"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; every test skips where torch sees no card.

    python -m pytest tests/test_torch_cuda.py -m cuda

All outputs are integer words: bit-exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from rspt_tpu_torch.packers import gpu  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _sig(rng, ch, ns, scale):
    sig = np.cumsum(rng.normal(0, scale, (ch, ns)), axis=1).astype(np.int32)
    return np.ascontiguousarray(sig.T).reshape(-1)


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_kernel_chain_matches_plain(rng, dev, planes):
    """Each kernel vs its plain version along one pass-1 → pass-2 chain."""
    ch, ns = 4, 30011
    words = torch.from_numpy(_sig(rng, ch, ns, 900.0)).to(dev)
    enc, ok = ck.xdelta_swizzle(words, ns, ch, planes)
    enc_p, ok_p = ck.xdelta_swizzle_plain(words, ns, ch, planes, True)
    assert torch.equal(enc, enc_p) and torch.equal(ok, ok_p)
    got = ck.tokenize_planes(enc, planes)
    want = ck.tokenize_planes_plain(enc, planes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tokw, _, hist = want
    _, lengths = gpu.block_layout(enc.numel(), planes)
    plan = tc.flat_plan(hist.cpu().numpy(), lengths)
    bases = torch.from_numpy(plan.bases).to(dev)
    tokc = ck.compact_tokens(tokw, bases, plan.T)
    assert torch.equal(tokc, ck.compact_tokens_plain(tokw, bases, plan.T))
    args = (tokc, bases, torch.from_numpy(plan.ntok).to(dev),
            torch.from_numpy(plan.bit0).to(dev),
            torch.from_numpy(plan.lut).to(dev), plan.nwords)
    assert torch.equal(ck.pack_flat(*args), ck.pack_flat_plain(*args))


def test_packer_card_equals_cpu(rng, dev):
    """Containers from the card equal the plain path's; exact round trip."""
    ch, ns = 3, 40000
    native = _sig(rng, ch, ns, 700.0).astype("<i4").tobytes()
    pc = gpack.new_xdelta_hzr(4, ch, ns, 1, device=dev)
    comp = pc.compress(native)
    assert comp == gpack.new_xdelta_hzr(4, ch, ns, 1, device="cpu").compress(
        native)
    assert pc.decompress(comp)[0] == native
