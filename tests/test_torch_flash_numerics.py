"""The arithmetic of the port's bf16 flash forward on the tensor cores
(`flash_fwd_wgmma_kernel` in trlx_tpu_torch/csrc/flash_attention.cu),
emulated in torch on the CPU and held against the JAX package's Pallas
forward (K4, `_flash_fwd_pallas_lse`) in interpret mode on the same numpy
inputs.

The emulation rounds where the kernel rounds: q.k^T as products of bf16
values summed in f32 (each product is exact in f32), then the scale; p in
f32 from exp2 with log2(e) folded in; p.V as two bf16 products, p_hi =
bf16(p) and p_lo = bf16(p - p_hi), against V exact in bf16, summed in f32;
the row sum over the f32 p; 64-key tiles in an online softmax, skipping
tiles with no valid key.

Tolerances: out within one bf16 ulp (rtol 8e-3, atol 1e-3: both sides
round once to bf16 from f32 values that differ by the split's error and
the order of the sums), lse within 2e-5. Before the final rounding, on
inputs exact in bf16 with the Pallas forward run in f32, the split keeps
the output within 1e-5 of it (measured on the CPU: 4.7e-6 at hd 32 and
4.8e-6 at hd 64, from the exp2 form and the order of the sums), while p_hi
alone is off by about 2^-9 of the values (2.9e-3 and 2.3e-3), some 500
times more.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.attention import _flash_fwd_pallas_lse
from trlx_tpu_torch.ops import attention as A

torch.set_num_threads(1)

B, T, NH, NKV, BLK = 2, 192, 4, 2, 64
PADS = [0, 70]  # row 1: q tile 0 has no valid key, key tile 0 is all padding
LOG2E = 1.4426950408889634


def _inputs(hd, seed):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, T, n, hd).astype(np.float32) for n in (NH, NKV, NKV)]
    # exact in bf16, so the f32 runs below see the bf16 values
    arrays = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]
    mask = (np.arange(T)[None, :] >= np.asarray(PADS)[:, None]).astype(np.int32)
    return arrays, mask


def emulate(q, k, v, mask, split=True):
    """(out f32 [b, t, nh, hd] before the output rounding, lse [b, nh, t])
    as the tensor-core kernel computes them, causal."""
    b, t, nh, hd = q.shape
    group = nh // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2)  # [b, nh, t, hd]
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    m = torch.full((b, nh, t), A.NEG_INF)
    l = torch.zeros((b, nh, t))
    acc = torch.zeros((b, nh, t, hd))
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, BLK):
        cols = torch.arange(k0, min(k0 + BLK, t))[None, :]
        valid = mask[:, None, None, k0:k0 + BLK] > 0
        if not bool(valid.any()):
            continue  # no valid key in any row: the kernel skips such a tile, per batch row
        s = (qf @ kf[:, :, k0:k0 + BLK].transpose(-1, -2)) * scale
        s = torch.where(valid & (cols <= rows), s, A.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        shift = torch.where(m_new <= A.NEG_INF / 2, 0.0, m_new)
        p = torch.where(s <= A.NEG_INF / 2, 0.0, torch.exp2((s - shift[..., None]) * LOG2E))
        corr = torch.where(m <= A.NEG_INF / 2, 0.0, torch.exp2((m - m_new) * LOG2E))
        l = l * corr + p.sum(-1)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vf[:, :, k0:k0 + BLK]
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vf[:, :, k0:k0 + BLK]
        acc = acc * corr[..., None] + pv
        m = m_new
    denom = torch.where(l > 0, l, 1.0)
    out = (acc / denom[..., None]).transpose(1, 2)
    lse = torch.where(l > 0, m + torch.log(denom), A.DEAD_LSE)
    return out, lse


@pytest.mark.parametrize("hd", [32, 64])
def test_bf16_forward_arithmetic_matches_pallas(hd):
    (q, k, v), mask = _inputs(hd, seed=hd)
    j_out, j_lse = _flash_fwd_pallas_lse(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask),
                                         True, BLK, BLK, interpret=True)
    out, lse = emulate(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), torch.from_numpy(mask))
    np.testing.assert_allclose(out.bfloat16().float().numpy(), np.asarray(jnp.asarray(j_out, jnp.float32)),
                               rtol=8e-3, atol=1e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=2e-5, atol=2e-5)
    dead = torch.from_numpy(mask).cumsum(-1) == 0  # [b, t] rows with no allowed key
    assert bool((out[dead] == 0).all()) and bool((lse.transpose(1, 2)[dead] == A.DEAD_LSE).all())


@pytest.mark.parametrize("hd", [32, 64])
def test_p_lo_product_is_what_keeps_the_forward_exact(hd):
    (q, k, v), mask = _inputs(hd, seed=100 + hd)
    j_out, _ = _flash_fwd_pallas_lse(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
                                     True, BLK, BLK, interpret=True)
    ref = np.asarray(j_out)  # f32 arithmetic on the same bf16-exact values
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    err_split = float(np.abs(emulate(tq, tk, tv, tm, split=True)[0].numpy() - ref).max())
    err_hi = float(np.abs(emulate(tq, tk, tv, tm, split=False)[0].numpy() - ref).max())
    msg = f"hd {hd}: max abs error p_hi + p_lo {err_split:.3g}, p_hi alone {err_hi:.3g}"
    assert err_split < 1e-5, msg
    assert err_hi > 100 * err_split, msg
