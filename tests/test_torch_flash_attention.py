"""The port's flash attention (trlx_tpu_torch/ops/attention.py) against
the JAX package's Pallas kernels run in interpret mode, on the same numpy
inputs: the forward with and without the lse (K4, K3), the backward's dq
(K5) and dk/dv (K6, group-summed), causal with left padding and a row
with no valid key, for MHA (4, 4), GQA (4, 2) and MQA (4, 1), at f32 and
bf16 (the forward's case in `test_torch_flash_forward.py`, on this
file's helpers). On the CPU the port's wrappers run their plain versions.

Tolerances: at f32 both sides compute in f32 and differ in summation
order only: 1e-5 (the backward sums t products per element: 2e-5). At
bf16 both compute in f32 from the same bf16 inputs and round once to
bf16, so they may differ by one bf16 ulp: rtol 8e-3 plus atol 1e-3 near
zero. The backward's cases are in `test_torch_flash_attention_bwd.py`,
so that `--dist loadfile` hands them out after the large files.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.attention import _flash_bwd_pallas, _flash_fwd_pallas, _flash_fwd_pallas_lse
from trlx_tpu_torch.ops import attention as A

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

B, T, NH, HD, BLK = 3, 64, 4, 16, 32
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=8e-3, atol=1e-3)}
BWD_TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=8e-3, atol=1e-3)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(nkv, dtype, seed=0):
    """Left pads 0, 9 and T (the last row has no valid key)."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, T, n, HD).astype(np.float32) for n in (NH, nkv, nkv, NH)]
    mask = (np.arange(T)[None, :] >= np.asarray([0, 9, T])[:, None]).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    jax_in = [jnp.asarray(a, jdt) for a in arrays] + [jnp.asarray(mask)]
    torch_in = [torch.from_numpy(a).to(tdt) for a in arrays] + [torch.from_numpy(mask)]
    return jax_in, torch_in


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else x.float().numpy()


def test_flash_attention_autograd_through_the_function():
    """The autograd Function's grads equal `flash_backward` on the saved
    residuals, and a dead row contributes nothing."""
    _, (tq, tk, tv, tg, tm) = _case(2, "f32", seed=2)
    q, k, v = (x.clone().requires_grad_(True) for x in (tq, tk, tv))
    out = A.flash_attention(q, k, v, tm)
    out.backward(tg)
    ref_out, lse = A.flash_fwd(tq, tk, tv, tm, True, with_lse=True)
    ref = A.flash_backward(tq, tk, tv, tm, ref_out, lse, tg, True)
    for got, want in zip((q.grad, k.grad, v.grad), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(q.grad[-1].abs().max()) == 0.0


def test_k3_without_grad_k4_with_grad(monkeypatch):
    """Frozen inputs (or no_grad) take the forward without lse and record
    no graph; an input that requires grad takes the lse forward."""
    calls = []
    real = A.flash_fwd

    def spy(*args, with_lse=False, **kw):
        calls.append(with_lse)
        return real(*args, with_lse=with_lse, **kw)

    monkeypatch.setattr(A, "flash_fwd", spy)
    _, (tq, tk, tv, _, tm) = _case(4, "f32")
    out = A.flash_attention(tq, tk, tv, tm)
    assert out.grad_fn is None
    with torch.no_grad():
        out = A.flash_attention(tq.clone().requires_grad_(True), tk, tv, tm)
    assert out.grad_fn is None
    out = A.flash_attention(tq, tk.clone().requires_grad_(True), tv, tm)
    assert out.grad_fn is not None
    assert calls == [False, False, True]


# ---------------------------------------------------------------------------
# Head dims the kernels are not instantiated at (ROADMAP queue C.1): the
# Pallas kernels take any head dim; the port pads to the next instantiation
# ---------------------------------------------------------------------------


def _case_hd(hd, nkv, seed):
    """B 2 rows of T 64, 4 q heads: one full row, one with 9 left pads."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(2, T, n, hd).astype(np.float32) for n in (NH, nkv, nkv, NH)]
    mask = (np.arange(T)[None, :] >= np.asarray([0, 9])[:, None]).astype(np.int32)
    jax_in = [jnp.asarray(a) for a in arrays] + [jnp.asarray(mask)]
    torch_in = [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(mask)]
    return jax_in, torch_in


@pytest.mark.parametrize("hd,nkv", [(80, 4), (96, 2)])
def test_flash_at_head_dims_80_and_96_matches_pallas(hd, nkv):
    """pythia-2.8b's and OPT-2.7b's 80, the HH "20B" recipe's 96: the JAX
    kernels in interpret mode against the port's path, forward, lse and
    the three gradients, at f32 (TOL / BWD_TOL)."""
    (jq, jk, jv, jg, jm), (tq, tk, tv, tg, tm) = _case_hd(hd, nkv, seed=hd)
    j_out, j_lse = _flash_fwd_pallas_lse(jq, jk, jv, jm, True, BLK, BLK, interpret=True)
    j_out3 = _flash_fwd_pallas(jq, jk, jv, jm, True, BLK, BLK, interpret=True)
    j_grads = _flash_bwd_pallas(jq, jk, jv, jm, j_out, j_lse, jg, True, BLK, BLK, interpret=True)
    t_out, t_lse = A.flash_fwd(tq, tk, tv, tm, True, with_lse=True)
    np.testing.assert_allclose(_np(t_out), _np(j_out), **TOL["f32"])
    np.testing.assert_allclose(_np(A.flash_fwd(tq, tk, tv, tm, True)), _np(j_out3), **TOL["f32"])
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=1e-5, atol=1e-5)
    t_grads = A.flash_backward(tq, tk, tv, tm, t_out, t_lse, tg, True)
    for t, j in zip(t_grads, j_grads):
        assert t.shape == tuple(j.shape)
        np.testing.assert_allclose(_np(t), _np(j), **BWD_TOL["f32"])


@pytest.mark.parametrize("hd,nkv", [(80, 4), (96, 2), (40, 1)])
def test_padded_route_equals_the_unpadded_plain_path(hd, nkv, monkeypatch):
    """The route a CUDA tensor at such a head dim takes (pad to the next
    instantiation, the kernel at the padded width with the true scale,
    slice), here through the plain versions. The wrappers at the padded
    width, given the same lse and delta: out, lse, dq, dk and dv exactly
    the unpadded plain path's (zero columns add exact zeros) and the
    padded columns exactly 0. The autograd route forced onto the CPU:
    q, k, v padded once a call and g once, the forward exactly the
    unpadded one, the gradients within BWD_TOL (its delta = sum(g * out)
    runs over the padded width, a different summation order)."""
    _, (q, k, v, g, mask) = _case_hd(hd, nkv, seed=hd + 1)
    hp = A.padded_head_dim(hd)
    assert hp in A.HEAD_DIMS and hp > hd and A.padded_head_dim(hp) == hp
    out, lse = A.flash_fwd_plain(q, k, v, mask, True)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    dq = A.flash_bwd_dq_plain(q, k, v, mask, g, lse, delta, True)
    dk, dv = A.flash_bwd_dkv_plain(q, k, v, mask, g, lse, delta, True)
    qp, kp, vp, gp = A.pad_operands(hd, q, k, v, g)
    scale = 1.0 / np.sqrt(hd)
    wide, wide_lse = A.flash_fwd(qp, kp, vp, mask, True, with_lse=True, scale=scale)
    wide_dq = A.flash_bwd_dq(qp, kp, vp, mask, gp, lse, delta, True, scale=scale)
    wide_dk, wide_dv = A.flash_bwd_dkv(qp, kp, vp, mask, gp, lse, delta, True, scale=scale)
    assert torch.equal(wide_lse, lse)
    for x, want in ((wide, out), (wide_dq, dq), (wide_dk, dk), (wide_dv, dv)):
        assert x.shape[-1] == hp and float(x[..., hd:].abs().max()) == 0.0
        assert torch.equal(x[..., :hd], want)

    ref = A.flash_backward(q, k, v, mask, out, lse, g, True)
    pads = []
    real_pad = A.pad_head_dim
    monkeypatch.setattr(A, "takes_padded_route", lambda x: True)
    monkeypatch.setattr(A, "pad_head_dim", lambda x, w: pads.append(tuple(x.shape)) or real_pad(x, w))
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = A.flash_attention(tq, tk, tv, mask)
    assert got.shape == out.shape and torch.equal(got, out)
    assert pads == [tuple(q.shape), tuple(k.shape), tuple(k.shape)]
    got.backward(g)
    assert pads[3:] == [tuple(q.shape)]
    for x, want in zip((tq.grad, tk.grad, tv.grad), ref):
        assert x.shape == want.shape
        np.testing.assert_allclose(_np(x), _np(want), **BWD_TOL["f32"])


def test_head_dim_above_256_is_refused_naming_queue_c(monkeypatch):
    with pytest.raises(ValueError, match="ROADMAP queue C"):
        A.padded_head_dim(288)
    _, (q, k, v, _, mask) = _case_hd(288, 1, seed=0)
    monkeypatch.setattr(A, "takes_padded_route", lambda x: True)
    with pytest.raises(ValueError, match="ROADMAP queue C"):
        A.flash_attention(q.requires_grad_(True), k, v, mask)
