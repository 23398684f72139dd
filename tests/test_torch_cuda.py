"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``; they skip
without one. Run them there with
``python -m pytest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cn_kernel_bit_exact(card, dtype):
    from slidingwindowdecoder_torch.ops.bp import _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    gen = torch.Generator(device=card).manual_seed(3)
    dc, m_pad, B = 9, 64, 300
    valid = torch.rand((dc, m_pad), generator=gen, device=card) < 0.8
    valid[:, -1] = False  # an inert pad row
    mv = torch.randn((dc, m_pad, B), generator=gen, device=card) * 40
    mv[1, ::3] = -mv[0, ::3]
    mv[2, ::4] = 0.0
    mv = mv.to(dtype)
    parity = torch.randint(0, 2, (m_pad, B), generator=gen, device=card,
                           dtype=torch.int32)
    before = cn_update.launches
    out = cn_update(mv, valid, parity, alpha=0.625, clip=50.0)
    assert cn_update.launches == before + 1
    assert torch.equal(out, _cn_update_sm(mv, valid, parity, alpha=0.625, clip=50.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cn_pinned_kernel_bit_exact(card, dtype):
    """The pinned (masked-BP) kernel: pins at the dtype-rounded PIN, whole
    checks pinned, ties, zeros and values beyond +-clip."""
    from slidingwindowdecoder_torch.ops.bp import PIN, _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    gen = torch.Generator(device=card).manual_seed(4)
    dc, m_pad, B = 9, 64, 300
    valid = torch.rand((dc, m_pad), generator=gen, device=card) < 0.8
    valid[:, -1] = False
    mv = torch.randn((dc, m_pad, B), generator=gen, device=card) * 40
    mv[1, ::3] = -mv[0, ::3]
    mv[2, ::4] = 0.0
    mv = mv.to(dtype)
    mv[torch.rand(mv.shape, generator=gen, device=card) < 0.3] = PIN
    mv[:, ::7] = PIN
    parity = torch.randint(0, 2, (m_pad, B), generator=gen, device=card,
                           dtype=torch.int32)
    before = cn_update.pinned_launches, cn_update.launches
    out = cn_update(mv, valid, parity, alpha=0.625, clip=50.0, pinned=True)
    assert (cn_update.pinned_launches, cn_update.launches) == (before[0] + 1, before[1])
    ref = _cn_update_sm(mv, valid, parity, alpha=0.625, clip=50.0, pinned=True)
    assert torch.equal(out, ref)


def test_gj_kernel_bit_exact(card):
    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        gf2_rank_packed,
        ordered_gauss_jordan_key,
        pack_rows_host,
    )

    rng = np.random.default_rng(5)
    base = (rng.random((40, 150)) < 0.1).astype(np.uint8)
    H = np.vstack([base, base[:6]])  # rank-deficient
    m, n = H.shape
    rank = gf2_rank_packed(H)
    Hw = torch.as_tensor(pack_rows_host(H).view(np.int32), device=card)
    synd = torch.as_tensor(rng.integers(0, 2, (33, m)), dtype=torch.uint8, device=card)
    key = torch.as_tensor(rng.integers(0, 8, (33, n)), dtype=torch.float32, device=card)
    before = gauss_jordan_key.launches
    out = gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
    assert gauss_jordan_key.launches == before + 1
    ref = ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    assert bool(out["inconsistent"].any())
