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
tiles with no valid key. The second half of the file does the same for
the backward (K5 `flash_bwd_dq_wgmma_kernel` and K6
`flash_bwd_dkv_wgmma_kernel`) against the Pallas backward.

Tolerances: out within one bf16 ulp (rtol 8e-3, atol 1e-3: both sides
round once to bf16 from f32 values that differ by the split's error and
the order of the sums), lse within 2e-5. Before the final rounding, on
inputs exact in bf16 with the Pallas forward run in f32, the split keeps
the output within 1e-5 of it (measured on the CPU: 4.7e-6 at hd 32,
4.8e-6 at hd 64 and 9.5e-6 at hd 256, from the exp2 form and the order
of the sums), while p_hi alone is off by about 2^-9 of the values
(2.9e-3, 2.3e-3 and 3.7e-3), some 400 to 600 times more. Head dim 256 is
GPT-J-6B's: there the forward's and the backward's kernels run two
warpgroups a block, each forming all of S (and in the backward dP, p and
ds) and adding its products into its half of the output's columns, which
is this arithmetic column by column. The backward's cases are in
`test_torch_flash_numerics_bwd.py`, so that `--dist loadfile` hands them
out after the large files.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.attention import _flash_bwd_pallas, _flash_fwd_pallas_lse
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


@pytest.mark.parametrize("hd", [32, 64, 256])
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


@pytest.mark.parametrize("hd", [32, 64, 256])
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


# ---------------------------------------------------------------------------
# The backward: K5 (dq) and K6 (dk/dv) on the tensor cores
# ---------------------------------------------------------------------------

DKV_TOL = dict(rtol=1e-4, atol=1e-3)  # chip_smoke.py phase 6, f32 dk/dv
BF16_TOL = dict(rtol=8e-3, atol=1e-3)  # one bf16 ulp


def _halves(x, split):
    """x as the bf16 products see it: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def emulate_backward(q, k, v, mask, g, lse, delta, split=True):
    """(dq before its bf16 rounding, per-q-head dk, dv), f32 [b, t, nh, hd],
    as `flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkv_wgmma_kernel` compute
    them, causal: over 64 x 64 (q, key) tiles, key tiles with no valid key
    skipped; s = q.k^T and dp = dO.v^T as bf16 products summed in f32; p =
    exp2(fma(s, scale * log2(e), -lse * log2(e))); ds = p * (dp - delta) *
    scale; dq += ds.k, dv += p^T.dO and dk += ds^T.q with p and ds split
    into bf16 hi and lo halves against the bf16 k, dO and q."""
    b, t, nh, hd = q.shape
    group = nh // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf, gf = q.float().transpose(1, 2), g.float().transpose(1, 2)  # [b, nh, t, hd]
    kf = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    sl2 = (torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)).double()
    nl2 = (-lse * LOG2E).double()
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(qf), torch.zeros_like(qf)
    for k0 in range(0, t, BLK):
        ks = slice(k0, k0 + BLK)
        valid = mask[:, None, None, ks] > 0
        if not bool(valid.any()):
            continue  # no valid key in any row: each kernel skips such a tile, per batch row
        cols = torch.arange(k0, min(k0 + BLK, t))[None, :]
        for q0 in range(k0 // BLK * BLK, t, BLK):  # causal: from the diagonal on
            qs = slice(q0, q0 + BLK)
            rows = torch.arange(q0, min(q0 + BLK, t))[:, None]
            s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
            arg = (s.double() * sl2 + nl2[:, :, qs, None]).float()  # one rounding, as fmaf
            p = torch.where(valid & (cols <= rows), torch.exp2(arg), 0.0)
            dp = gf[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
            ds = p * (dp - delta[:, :, qs, None]) * scale
            for part in _halves(ds, split):
                dq[:, :, qs] += part @ kf[:, :, ks]
                dk[:, :, ks] += part.transpose(-1, -2) @ qf[:, :, qs]
            for part in _halves(p, split):
                dv[:, :, ks] += part.transpose(-1, -2) @ gf[:, :, qs]
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _fold(x, nkv):
    """Per-q-head dk/dv summed onto the kv heads, as `flash_backward` does."""
    b, t, nh, hd = x.shape
    return x.reshape(b, t, nkv, nh // nkv, hd).sum(3)


def _backward_case(hd, seed):
    """bf16-exact inputs, the Pallas forward's (out, lse) at f32, and the
    Pallas backward's f32 (dq, dk, dv) in interpret mode."""
    (q, k, v), mask = _inputs(hd, seed)
    g = torch.from_numpy(np.random.RandomState(seed + 1).randn(B, T, NH, hd).astype(np.float32)).bfloat16().float()
    jq, jk, jv, jg, jm = (jnp.asarray(a) for a in (q, k, v, g.numpy(), mask))
    j_out, j_lse = _flash_fwd_pallas_lse(jq, jk, jv, jm, True, BLK, BLK, interpret=True)
    j_grads = _flash_bwd_pallas(jq, jk, jv, jm, j_out, j_lse, jg, True, BLK, BLK, interpret=True)
    out = torch.from_numpy(np.array(j_out))
    lse = torch.from_numpy(np.array(j_lse))
    delta = (g * out).sum(-1).transpose(1, 2)  # [b, nh, t], as flash_backward forms it
    tensors = [torch.from_numpy(a) for a in (q, k, v, mask)] + [g, lse, delta]
    return tensors, [np.array(x) for x in j_grads]
