"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Every test here is marked `cuda` and skips without a CUDA device.
This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from trlx_tpu_torch import kernels
from trlx_tpu_torch.ops import quant
from trlx_tpu_torch.ops.paged_attention import (
    KERNEL,
    KERNEL_INT8,
    paged_attention_decode,
    paged_attention_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, nh, nkv, b=4, hd=64, blk=32, n_tbl=4, n_blocks=20):
    """Lengths inside block 0, on a block boundary, across it, and one
    inactive row."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32))
    ka = torch.from_numpy(rng.randn(n_blocks, blk, nkv, hd).astype(np.float32))
    va = torch.from_numpy(rng.randn(n_blocks, blk, nkv, hd).astype(np.float32))
    table = torch.from_numpy(rng.permutation(np.arange(1, n_blocks))[: b * n_tbl].reshape(b, n_tbl).astype(np.int32))
    lens = np.asarray([blk - 1, blk, 2 * blk + 1, 0][:b])
    mask = torch.from_numpy((np.arange(n_tbl * blk)[None, :] < lens[:, None]).astype(np.int32))
    return q, ka, va, table, mask, torch.from_numpy(lens > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (4, 1), (12, 12)])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("qt", ["f32", "bf16"])
def test_paged_decode_kernel_matches_plain(cuda, nh, nkv, kv, qt):
    """1e-5 where q/out are f32 (only the summation order differs). Where
    they are bf16, both sides compute in f32 and round once to bf16, so
    they may differ by one bf16 ulp, at most 2^-7 of the value: rtol 8e-3,
    plus atol 1e-3 near zero."""
    q, ka, va, table, mask, active = (t.to(cuda) for t in _case(0, nh, nkv))
    q = q.to(torch.bfloat16 if qt == "bf16" else torch.float32)
    tol = dict(rtol=8e-3, atol=1e-3) if qt == "bf16" else dict(rtol=1e-5, atol=1e-5)
    extra = {}
    if kv == "int8":
        k, ks = quant.quantize_kv(ka)
        v, vs = quant.quantize_kv(va)
        extra = dict(k_scale=ks, v_scale=vs)
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        k, v = ka.to(dt), va.to(dt)
    kernels.reset_launches()
    out = paged_attention_decode(q, k, v, table, mask, **extra)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[KERNEL_INT8 if kv == "int8" else KERNEL] == 1
    ref = paged_attention_plain(q, k, v, table, mask, **extra)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert bool((out[~active] == 0).all())


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_what_it_does_not_take(cuda):
    q, ka, va, table, mask, _ = (t.to(cuda) for t in _case(1, 4, 4, hd=60))
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_decode(q, ka, va, table, mask)
    q, ka, va, table, mask, _ = (t.to(cuda) for t in _case(1, 4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_decode(q.transpose(0, 1).contiguous().transpose(0, 1), ka, va, table, mask)
