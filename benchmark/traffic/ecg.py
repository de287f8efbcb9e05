"""Synthetic ECG from a seed, made on the given device in a few large
calls (a ``torch.Generator`` there): the records of a QRS job. The same
seed on the same device gives the same data; another seed gives other
data of the same sizes."""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, n, lo_hi, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device,
                                       dtype=torch.float64)


def _grid(g, n, lo_hi, device):
    """n values evenly spread over [lo, hi], in an order drawn from g:
    every seed gets the same set, so the same work."""
    lo, hi = lo_hi
    v = lo + (hi - lo) * (torch.arange(n, dtype=torch.float64,
                                       device=device) + 0.5) / n
    return v[torch.randperm(n, generator=g, device=device)]


def records(signal: dict, nr_records: int, leads: int, samples: int,
            sr: float, seed: int, device) -> torch.Tensor:
    """(nr_records * leads, samples) float32 ADC values, record-major: a
    beat train a record (with a slow sinusoidal variation of the RR
    interval), P, QRS and T waves as Gaussians around each beat with
    per-lead amplitudes (a share of the leads inverted), baseline wander,
    white noise, then the ADC (gain adu/mV, zero, bits: rounded and
    clipped). ``signal`` holds the ranges (the configuration's ``signal``
    group). Rates, amplitudes, wander and the inverted leads are one fixed
    set over their ranges, dealt to the records in an order drawn from
    the seed, so every seed asks for the same beats; phases and noise are
    drawn."""
    g = generator(seed, device)
    rows = nr_records * leads
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(samples, **f64)[None, :]
    hz = _grid(g, nr_records, signal["hr_bpm"], device)[:, None] / 60.0
    var_hz = _grid(g, nr_records, signal["hrv_hz"], device)[:, None]
    var_ph = _uniform(g, nr_records, (0.0, 2 * math.pi), device)[:, None]
    inst = hz * (1.0 + signal["hrv"] * torch.sin(
        2 * math.pi * var_hz * t / sr + var_ph))
    phase = torch.cumsum(inst, 1) / sr
    phase += _uniform(g, nr_records, (0.0, 1.0), device)[:, None]
    d = (phase - torch.round(phase)) / inst       # seconds from the R peak
    del phase, inst
    d = d.repeat_interleave(leads, 0)
    r_mv = _grid(g, rows, signal["r_mv"], device)
    flip = _grid(g, rows, (0.0, 1.0), device) < signal["inverted"]
    r_mv = torch.where(flip, -r_mv, r_mv)[:, None]
    mv = torch.zeros(rows, samples, **f64)
    for frac, at, width in signal["waves"]:
        mv += frac * r_mv * torch.exp(-0.5 * ((d - at) / width) ** 2)
    del d
    w_hz = _grid(g, rows, signal["wander_hz"], device)[:, None]
    w_ph = _uniform(g, rows, (0.0, 2 * math.pi), device)[:, None]
    mv += signal["wander_mv"] * torch.sin(2 * math.pi * w_hz * t / sr + w_ph)
    mv += signal["noise_mv"] * torch.randn(rows, samples, generator=g, **f64)
    adc = torch.round(signal["adc_zero"] + signal["adc_gain"] * mv)
    return adc.clamp_(0, 2 ** signal["adc_bits"] - 1).to(torch.float32)

