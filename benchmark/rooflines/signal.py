"""Bytes of the batch signal kernels (ops/csrc/iir.cu, peaks.cu) for one
detect_batch over (rows, T) float32."""

IIR_ASSOC_CALLS = 3     # band-pass, integrator, threshold


def iir_assoc_bytes(rows: int, T: int, calls: int = IIR_ASSOC_CALLS) -> int:
    """S2: x in and y out, 4 B each a sample, a call."""
    return calls * rows * T * (4 + 4)


def peak_gate_bytes(rows: int, T: int) -> int:
    """S4: sig and thr in, the markers out, 4 B each a sample."""
    return rows * T * 12
