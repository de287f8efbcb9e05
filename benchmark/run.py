"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name from BENCHMARK.json; see
benchmark/harness.py. The host's thread pools are held to one thread
here, before torch or numpy is imported (manifest.hold_threads).
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))

from benchmark import manifest  # noqa: E402  (json only: no torch yet)


def main(argv=None) -> int:
    args = manifest.parse_args(argv)
    cell = manifest.resolve(ROOT, args.workload)
    manifest.hold_threads()
    from benchmark import harness
    return harness.run(cell, args)


if __name__ == "__main__":
    sys.exit(main())
