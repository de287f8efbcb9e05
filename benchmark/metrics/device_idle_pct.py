"""The card's idle share of the traced window: 100 minus the share the
union of its device operations covers."""


def read(run):
    return run.trace.idle_pct()
