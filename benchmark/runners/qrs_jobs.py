"""QRS detection jobs in a closed loop, one job in flight.

Set-up makes the configuration's records on the card from the seed
(benchmark/traffic/ecg.py), copies them once into pinned host memory and
runs ``warm_jobs`` jobs. A job, all of it timed:
1. upload the (records x leads, samples) float32 rows from the pinned
   buffer to the card;
2. ``detect_batch(x, sampling_rate)`` (analysis/torch_peaks.py);
3. the marker positions to the host: one ``nonzero`` on the card and one
   copy into pinned memory.
Every job sees the same records, so one reference serves them all: the
last job and the jobs a draw from the seed keeps (one in ``keep_every``)
are compared, row by row, with the plain float64 detector
(benchmark/reference/qrs.py), by two numbers over the reference's
markers, each the worst job's: ``marker_unmatched``, the markers of
either side with no partner within ``match_samples`` on the other, over
the reference's markers; and ``marker_inexact``, the reference's markers
matched only at another sample, over those matched.

CONTROL and FAULTS are put in the place of ``entry`` (harness.measure's
``plant``) by benchmark/calibrate.py and the tests, never by a run.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import qrs
from benchmark.trace import span
from benchmark.traffic import ecg


class Runner:
    def __init__(self, config: dict, mix: dict, seed: int,
                 dev: torch.device):
        from rspt_tpu_torch.analysis.torch_peaks import detect_batch
        self.entry = detect_batch
        self.dev = dev
        self.sr = float(config["sampling_rate"])
        self.marker = float(config["detector"]["marker_val"])
        self.order2 = bool(config["detector"]["order2"])
        self.rows = config["records"] * config["leads"]
        self.T = config["samples"]
        self.tol = int(mix["match_samples"])
        self.limits = mix["limits"]
        x = ecg.records(config["signal"], config["records"],
                        config["leads"], self.T, self.sr, seed, dev)
        self.host = torch.empty(x.shape, dtype=torch.float32,
                                pin_memory=dev.type == "cuda")
        self.host.copy_(x)
        del x
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.keep_p = 1.0 / float(mix["keep_every"])
        self.rng = np.random.default_rng(int(seed) % (1 << 63))
        self.kept, self.last = [], None
        self.pinned = torch.empty((0, 2), dtype=torch.int64)
        self.attempted = self.failed = 0
        self.reset_counters()
        for _ in range(int(mix["warm_jobs"])):
            self.step()
        self.kept = []

    def reset_counters(self) -> None:
        self.jobs = self.samples = 0
        self.events = []

    def step(self) -> None:
        timed = self.dev.type == "cuda"
        with span("upload"):
            x = self.host.to(self.dev, non_blocking=True)
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        with span("detect"):
            peaks, _, _ = self.entry(x, self.sr, self.marker, self.order2,
                                      device=self.dev)
        if timed:
            e1.record()
            self.events.append((e0, e1))
        with span("markers"):
            idx = self._to_host(peaks.nonzero())
        self.attempted += 1
        self.jobs += 1
        self.samples += self.rows * self.T
        self.last = idx
        if self.rng.random() < self.keep_p:
            self.kept.append(idx.clone())

    def _to_host(self, idx: torch.Tensor) -> torch.Tensor:
        """The (markers, 2) positions copied into pinned host memory,
        grown (during warm-up) to twice the largest count seen; the view
        lasts until the next job."""
        if idx.device.type != "cuda":
            return idx
        k = idx.shape[0]
        if k > self.pinned.shape[0]:
            self.pinned = torch.empty((2 * k, 2), dtype=torch.int64,
                                      pin_memory=True)
        out = self.pinned[:k]
        out.copy_(idx)
        return out

    def counters(self) -> dict:
        return {"jobs": self.jobs, "samples": self.samples,
                "rows": self.rows, "T": self.T,
                "detect_ms": sum(a.elapsed_time(b) for a, b in self.events)}

    def end_to_end(self, elapsed: float) -> dict:
        return {"qrs_Msps": self.samples / elapsed / 1e6}

    def _rows(self, idx: torch.Tensor):
        idx = idx.numpy()
        cuts = np.searchsorted(idx[:, 0], np.arange(1, self.rows))
        return np.split(idx[:, 1].astype(np.int64), cuts)

    def check(self) -> dict:
        jobs = self.kept + [self.last]
        self.events = []
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        want = qrs.detect(self.host.to(self.dev), self.sr)
        unmatched = inexact = 0.0
        for idx in jobs:
            got = self._rows(idx)
            miss, ref = qrs.unmatched(got, want, self.tol)
            unmatched = max(unmatched, miss / max(1, ref))
            off, matched = qrs.inexact(got, want, self.tol)
            inexact = max(inexact, off / max(1, matched))
        return {name: {"value": value, "limit": float(self.limits[name]),
                       "jobs": len(jobs)}
                for name, value in (("marker_unmatched", unmatched),
                                    ("marker_inexact", inexact))}


def _bfloat16_reference(detect):
    """The control: the plain detector computed in bfloat16 in the
    program's place, its markers written as the program writes its
    peaks."""
    def control(x, sr, marker, *a, **k):
        peaks = torch.zeros_like(x)
        for r, m in enumerate(qrs.detect(x, sr, dtype=torch.bfloat16)):
            peaks[r, torch.as_tensor(m, device=x.device)] = marker
        return peaks, None, None
    return control


def _half_batch(detect):
    """The rows past the first half left out of every job."""
    def broken(x, *a, **k):
        n = x.shape[0] // 2
        peaks, sig, thr = detect(x[:n].contiguous(), *a, **k)
        return torch.cat([peaks, torch.zeros_like(x[n:])]), sig, thr
    return broken


def _answer_altered(detect):
    """One answer altered where it is produced: row 0's markers moved by
    100 ms."""
    def broken(x, *a, **k):
        peaks, sig, thr = detect(x, *a, **k)
        peaks[0] = torch.roll(peaks[0], 36)
        return peaks, sig, thr
    return broken


def _one_sample_late(detect):
    """Every marker one sample late, as an off-by-one in the gate's
    marker offset would put it."""
    def broken(x, *a, **k):
        peaks, sig, thr = detect(x, *a, **k)
        return torch.roll(peaks, 1, 1), sig, thr
    return broken


def _chunk_cleared(detect):
    """One 1,024-sample chunk (S4's unit of speculation) in the middle of
    each of 8 rows left without its markers, as a chunk that the gate's
    repair walk got wrong would be."""
    def broken(x, *a, **k):
        peaks, sig, thr = detect(x, *a, **k)
        rows = list(range(0, x.shape[0], max(1, x.shape[0] // 8)))[:8]
        c0 = x.shape[1] // 2 // 1024 * 1024
        peaks[rows, c0:c0 + 1024] = 0
        return peaks, sig, thr
    return broken


CONTROL = _bfloat16_reference
FAULTS = {"half_batch": _half_batch, "answer_altered": _answer_altered,
          "one_sample_late": _one_sample_late,
          "chunk_cleared": _chunk_cleared}
