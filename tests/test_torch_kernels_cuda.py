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
    split_plan,
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


def _long_case(seed, nh, nkv, hd, b=4, blk=32, n_tbl=72):
    """Rows of 72 pages split as the wrapper splits them: lengths one below
    and one above a split edge, a full row with holes (a masked run of
    eleven pages and scattered columns) and two out-of-range entries under
    a mask of 1, and an inactive row."""
    rng = np.random.RandomState(seed)
    n_blocks = b * n_tbl + 1
    edge = split_plan(b, nkv, n_tbl)[0] * blk
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32))
    ka = torch.from_numpy(rng.randn(n_blocks, blk, nkv, hd).astype(np.float32))
    va = torch.from_numpy(rng.randn(n_blocks, blk, nkv, hd).astype(np.float32))
    table = rng.permutation(np.arange(1, n_blocks))[: b * n_tbl].reshape(b, n_tbl).astype(np.int32)
    table[2, 10], table[2, 30] = -1, n_blocks + 7
    lens = np.asarray([5 * edge - 1, 7 * edge + 1, n_tbl * blk, 0])
    mask = np.arange(n_tbl * blk)[None, :] < lens[:, None]
    mask[2, 40 * blk:51 * blk] = False
    mask[2, rng.randint(0, n_tbl * blk, 300)] = False
    return q, ka, va, torch.from_numpy(table), torch.from_numpy(mask), torch.from_numpy(lens > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv,hd", [(16, 1, 64), (16, 4, 128)])
@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mask_dtype", [torch.int32, torch.bool])
def test_paged_decode_kernel_split_edges_and_repeats(cuda, nh, nkv, hd, kv, mask_dtype):
    """Long rows across split edges, holes and out-of-range entries: the
    kernel within the tolerances above (f32 q with f32 KV, bf16 q with bf16
    and int8 KV), inactive rows exactly 0, one counted launch a call, and a
    second call bitwise equal to the first (the merge's order is fixed)."""
    q, ka, va, table, mask, active = (t.to(cuda) for t in _long_case(2, nh, nkv, hd))
    mask = mask.to(mask_dtype)
    q = q.to(torch.float32 if kv == "f32" else torch.bfloat16)
    tol = dict(rtol=1e-5, atol=1e-5) if kv == "f32" else dict(rtol=8e-3, atol=1e-3)
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
    again = paged_attention_decode(q, k, v, table, mask, **extra)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = paged_attention_plain(q, k, v, table, mask, **extra)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert bool((out[~active] == 0).all())


# ---------------------------------------------------------------------------
# Flash attention (K3-K6) and the fused label logprob (K7)
# ---------------------------------------------------------------------------

# f32: both sides compute in f32 and differ only in summation order
# (forward rtol/atol 2e-5; the backward sums t products per element, 1e-4).
# bf16 outputs: both sides round once to bf16 from f32 values that differ
# only in summation order (on the tensor cores the products of two bf16
# operands, q.k^T and dO.v^T, are exact, and the products with an f32
# operand, p.V, p^T.dO, ds.k and ds^T.q, carry p and ds to about 2^-17
# through a bf16 hi/lo split), so they may differ by one bf16 ulp: rtol
# 8e-3 plus atol 1e-3 near zero. The per-head dk/dv are f32 at either
# input type, and the split's 2^-17 stays inside their 1e-4.
FWD_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}
BWD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}
F32_BWD_TOL = dict(rtol=1e-4, atol=1e-4)  # dk/dv are f32 outputs at either input type


def _flash_case(seed, b, t, nh, nkv, hd, dtype, device, pads=None, causal=True):
    """Left-padded rows (pads 0, 5, 70, ...) and, with b >= 3, one row with
    no valid key at all."""
    from trlx_tpu_torch.ops import attention

    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, t, nh, hd).astype(np.float32)).to(device, dtype)
    k = torch.from_numpy(rng.randn(b, t, nkv, hd).astype(np.float32)).to(device, dtype)
    v = torch.from_numpy(rng.randn(b, t, nkv, hd).astype(np.float32)).to(device, dtype)
    g = torch.from_numpy(rng.randn(b, t, nh, hd).astype(np.float32)).to(device, dtype)
    pads = [0, 5, 70, t][:b] if pads is None else pads
    mask = torch.from_numpy((np.arange(t)[None, :] >= np.asarray(pads)[:, None]).astype(np.int32)).to(device)
    out, lse = attention.flash_fwd_plain(q, k, v, mask, causal)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, mask, g, out, lse, delta


# (b, t, nh, nkv, hd, left pads or None for 0, 5, 70, t). The bf16 kernels
# run on 64-row q tiles and 64-key tiles: pad 70 makes q tile 0 of its row
# wholly dead under the causal mask, a pad of t a wholly dead batch row,
# pads 200 and 131 rows whose first key tiles are all padding; t = 1 and t
# not a multiple of 64 exercise the ragged tail; t 1024 with pads 0, 511
# and 1024 is phase 6 of chip_smoke.py in small, with many tiles skipped.
FLASH_SHAPES = [(3, 130, 4, 4, 64, None), (2, 96, 4, 2, 32, None), (3, 64, 4, 1, 128, None),
                (2, 200, 2, 2, 16, None), (4, 300, 4, 2, 64, [0, 200, 300, 131]),
                (2, 1, 4, 1, 32, [0, 1]), (2, 257, 4, 2, 128, [190, 0]),
                (3, 1024, 2, 2, 64, [0, 511, 1024])]


def _dead_rows(mask, causal):
    """[b, t] True where a query has no allowed key."""
    if causal:
        return mask.cumsum(-1) == 0
    return (mask.sum(-1) == 0)[:, None].expand(mask.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,nh,nkv,hd,pads", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(cuda, b, t, nh, nkv, hd, pads, dtype, causal):
    from trlx_tpu_torch.ops import attention as A

    q, k, v, mask, g, out_ref, lse_ref, delta = _flash_case(0, b, t, nh, nkv, hd, dtype, cuda, pads, causal)
    kernels.reset_launches()
    out = A.flash_fwd(q, k, v, mask, causal)
    out2, lse = A.flash_fwd(q, k, v, mask, causal, with_lse=True)
    dq = A.flash_bwd_dq(q, k, v, mask, g, lse_ref, delta, causal)
    dk, dv = A.flash_bwd_dkv(q, k, v, mask, g, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert {n: kernels.LAUNCHES.get(n) for n in (A.KERNEL_FWD, A.KERNEL_FWD_LSE, A.KERNEL_BWD_DQ, A.KERNEL_BWD_DKV)} == {
        A.KERNEL_FWD: 1, A.KERNEL_FWD_LSE: 1, A.KERNEL_BWD_DQ: 1, A.KERNEL_BWD_DKV: 1}
    torch.testing.assert_close(out.float(), out_ref.float(), **FWD_TOL[dtype])
    torch.testing.assert_close(out2.float(), out_ref.float(), **FWD_TOL[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=2e-5, atol=2e-5)
    dead = _dead_rows(mask, causal)  # [b, t]
    if bool(dead.any()):
        assert bool((out[dead] == 0).all()) and bool((out2[dead] == 0).all())
        assert bool((lse.transpose(1, 2)[dead] == A.DEAD_LSE).all())
        assert bool((dq[dead] == 0).all())
    padding = mask == 0  # [b, t] keys nobody may attend: their per-head dk, dv are exactly 0
    if bool(padding.any()):
        assert bool((dk[padding] == 0).all()) and bool((dv[padding] == 0).all())
    torch.testing.assert_close(dq.float(), A.flash_bwd_dq_plain(q, k, v, mask, g, lse_ref, delta, causal).float(),
                               **BWD_TOL[dtype])
    dk_ref, dv_ref = A.flash_bwd_dkv_plain(q, k, v, mask, g, lse_ref, delta, causal)
    torch.testing.assert_close(dk, dk_ref, **F32_BWD_TOL)
    torch.testing.assert_close(dv, dv_ref, **F32_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (4, 1)])
def test_flash_attention_autograd_matches_cpu(cuda, nh, nkv):
    """The autograd Function on the card (K4 forward, K5/K6 backward and the
    GQA group-sum) against the same function on CPU copies (plain
    versions), f32."""
    from trlx_tpu_torch.ops.attention import flash_attention

    q, k, v, mask, g, *_ = _flash_case(1, 3, 80, nh, nkv, 32, torch.float32, torch.device("cpu"))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        qs, ks, vs = (x.to(dev).requires_grad_(True) for x in (q, k, v))
        out = flash_attention(qs, ks, vs, mask.to(dev), causal=True)
        out.backward(g.to(dev))
        grads.append([out.detach().cpu(), qs.grad.cpu(), ks.grad.cpu(), vs.grad.cpu()])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, **F32_BWD_TOL)


@pytest.mark.cuda
def test_flash_attention_dispatch_k3_without_grad_k4_with(cuda):
    from trlx_tpu_torch.ops import attention as A

    q, k, v, mask, *_ = _flash_case(2, 2, 64, 4, 4, 64, torch.bfloat16, cuda)
    kernels.reset_launches()
    with torch.no_grad():
        A.flash_attention(q.requires_grad_(True), k, v, mask)
    A.flash_attention(q.detach(), k, v, mask)
    assert kernels.LAUNCHES.get(A.KERNEL_FWD) == 2 and not kernels.LAUNCHES.get(A.KERNEL_FWD_LSE)
    A.flash_attention(q.detach().requires_grad_(True), k, v, mask).float().sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES.get(A.KERNEL_FWD_LSE) == 1
    assert kernels.LAUNCHES.get(A.KERNEL_BWD_DQ) == 1 and kernels.LAUNCHES.get(A.KERNEL_BWD_DKV) == 1


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    from trlx_tpu_torch.ops import attention as A

    q, k, v, mask, *_ = _flash_case(3, 2, 64, 4, 4, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_fwd(q, k, v, mask)
    q, k, v, mask, *_ = _flash_case(3, 2, 64, 4, 4, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)
    with pytest.raises(ValueError, match="dtypes"):
        A.flash_fwd(q.half(), k.half(), v.half(), mask)
    qb = q.bfloat16()
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(qb.shape)  # contiguous, 2 bytes off
    shifted.copy_(qb)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_fwd(shifted, k.bfloat16(), v.bfloat16(), mask)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda)
    for bwd in (A.flash_bwd_dq, A.flash_bwd_dkv):
        with pytest.raises(ValueError, match="aligned"):
            bwd(qb, k.bfloat16(), v.bfloat16(), mask, shifted, lse, lse)


# K7's shapes: odd V (consecutive bf16 rows start at every 2-byte
# alignment, so every head and tail length of the peel), V < 8 (no whole
# vector), one row, and rows few enough that the plan splits each row over
# a cluster of blocks (4 at bf16 and V 50257, 8 for one f32 row)
CE_SHAPES = [(300, 1001), (37, 50257), (1, 50257), (9, 5), (1, 7)]
# the backward, f32: both sides compute exp(x - lse) in f32 (ex2.approx on
# the card, about 2 ulp), the one-hot difference and the scale: 1e-5
# relative, 1e-6 absolute where (1 - p) at the label cancels. bf16: both
# round that f32 value once, so one bf16 ulp apart at most (2^-7 relative
# bounds an ulp; atol for denormals the kernel's exponential flushes).
CE_BWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.bfloat16: dict(rtol=2**-7, atol=1e-20)}


@pytest.mark.cuda
@pytest.mark.parametrize("n,v", CE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_label_logprobs_kernel_matches_plain(cuda, dtype, n, v):
    """Both sides read the same logits and compute in f32: 1e-5. A row
    split over a cluster merges in rank order: two calls bitwise equal."""
    from trlx_tpu_torch.ops.fused_ce import KERNEL as CE, label_logprobs, label_logprobs_plain

    rng = np.random.RandomState(4)
    logits = torch.from_numpy((3 * rng.randn(n, v)).astype(np.float32)).to(cuda, dtype)
    labels = torch.from_numpy(rng.randint(0, v, n).astype(np.int32)).to(cuda)
    kernels.reset_launches()
    out, lse = label_logprobs(logits, labels)
    out2, lse2 = label_logprobs(logits, labels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[CE] == 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref_out, ref_lse = label_logprobs_plain(logits, labels)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,v", CE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_label_logprobs_bwd_kernel_matches_plain(cuda, dtype, n, v):
    """dlogits against the plain backward, with zero incoming gradients on
    some rows (written as zeros without reading the logits) and labels in
    the head, the vectors and the tail of the rows."""
    from trlx_tpu_torch.ops.fused_ce import (KERNEL_BWD, label_logprobs_bwd, label_logprobs_bwd_plain,
                                             label_logprobs_plain)

    rng = np.random.RandomState(5)
    logits = torch.from_numpy((3 * rng.randn(n, v)).astype(np.float32)).to(cuda, dtype)
    labels = rng.randint(0, v, n).astype(np.int32)
    labels[: min(n, 3)] = [0, v - 1, v // 2][: min(n, 3)]
    labels = torch.from_numpy(labels).to(cuda)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    g[1::4] = 0.0
    _, lse = label_logprobs_plain(logits, labels)
    kernels.reset_launches()
    got = label_logprobs_bwd(logits, labels, lse, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[KERNEL_BWD] == 1
    assert got.dtype == dtype and got.shape == logits.shape
    assert bool((got[1::4] == 0).all())
    torch.testing.assert_close(got, label_logprobs_bwd_plain(logits, labels, lse, g), **CE_BWD_TOL[dtype])


@pytest.mark.cuda
def test_label_logprobs_bwd_kernel_on_offset_logits(cuda):
    """Logits whose first row is not 16-byte aligned (a view at an element
    offset): the gradient is allocated at the same alignment, and matches."""
    from trlx_tpu_torch.ops.fused_ce import label_logprobs, label_logprobs_bwd, label_logprobs_bwd_plain

    rng = np.random.RandomState(6)
    n, v = 16, 2001
    flat = torch.from_numpy((3 * rng.randn(n * v + 3)).astype(np.float32)).to(cuda, torch.bfloat16)
    logits = flat[3:].view(n, v)
    assert logits.data_ptr() % 16 == 6
    labels = torch.from_numpy(rng.randint(0, v, n).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    _, lse = label_logprobs(logits, labels)
    got = label_logprobs_bwd(logits, labels, lse, g)
    torch.cuda.synchronize()
    assert got.data_ptr() % 16 == 6
    torch.testing.assert_close(got, label_logprobs_bwd_plain(logits, labels, lse, g), **CE_BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_label_logprobs_kernels_refuse_what_they_do_not_take(cuda):
    from trlx_tpu_torch.ops.fused_ce import label_logprobs, label_logprobs_bwd

    x = torch.randn(4, 33, device=cuda)
    lab = torch.zeros(4, dtype=torch.int32, device=cuda)
    row = torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        label_logprobs(x.t().contiguous().t(), lab)
    with pytest.raises(ValueError, match="contiguous"):
        label_logprobs_bwd(x.t().contiguous().t(), lab, row, row)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtype"):
            label_logprobs(x.to(dtype), lab)
        with pytest.raises(ValueError, match="dtype"):
            label_logprobs_bwd(x.to(dtype), lab, row, row)
    with pytest.raises(ValueError, match="every tensor"):
        label_logprobs_bwd(x, lab, row.cpu(), row)
    with pytest.raises(ValueError, match="expected"):
        label_logprobs_bwd(x, lab, row[:3], row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_logprobs_value_and_grad_on_card(cuda, dtype):
    """Out-of-range labels clamp into [0, V); through autograd the forward
    and the backward kernel each launch once; against log_softmax + gather
    autograd on the same values (at bf16 the gradient rounds to bf16 on
    both sides: one ulp)."""
    from trlx_tpu_torch.ops.fused_ce import KERNEL as CE, KERNEL_BWD, fused_logprobs_of_labels

    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 7, 515).astype(np.float32)).to(cuda, dtype)
    labels = torch.from_numpy(rng.randint(-3, 520, (3, 7)).astype(np.int64)).to(cuda)
    a = x.clone().requires_grad_(True)
    kernels.reset_launches()
    out = fused_logprobs_of_labels(a, labels)
    out.sum().backward()
    torch.cuda.synchronize()
    assert {n: kernels.LAUNCHES.get(n) for n in (CE, KERNEL_BWD)} == {CE: 1, KERNEL_BWD: 1}
    b_ = x.float().clone().requires_grad_(True)
    ref = torch.gather(torch.log_softmax(b_, -1), -1, labels.clamp(0, 514)[..., None])[..., 0]
    ref.sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a.grad, b_.grad.to(dtype), **CE_BWD_TOL[dtype])


@pytest.mark.cuda
def test_sft_loss_reads_full_logits_once(cuda):
    """The SFT loss at gpt2-small's vocabulary over [2, 64] positions: one
    forward and one backward launch on the full logits (no copy of the
    [b, t - 1, V] slice), loss and gradient as on CPU copies."""
    from trlx_tpu_torch.ops.fused_ce import KERNEL as CE, KERNEL_BWD
    from trlx_tpu_torch.trainer.sft_trainer import causal_lm_ce_loss

    rng = np.random.RandomState(8)
    b, t, v = 2, 64, 50257
    logits = torch.from_numpy((3 * rng.randn(b, t, v)).astype(np.float32)).to(torch.bfloat16)
    ids = torch.from_numpy(rng.randint(0, v, (b, t)))
    mask = torch.ones(b, t, dtype=torch.long)
    mask[1, :9] = 0
    runs = []
    for dev in (cuda, torch.device("cpu")):
        x = logits.to(dev).requires_grad_(True)
        kernels.reset_launches()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = causal_lm_ce_loss(x, ids.to(dev), mask.to(dev))
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {n: kernels.LAUNCHES.get(n) for n in (CE, KERNEL_BWD)} == {CE: 1, KERNEL_BWD: 1}
            # the gradient itself, and no second [b, t, V] buffer
            assert torch.cuda.max_memory_allocated() - before < 1.5 * logits.numel() * 2
        runs.append((float(loss), x.grad.float().cpu()))
    (loss_k, grad_k), (loss_p, grad_p) = runs
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert bool((grad_k[:, -1] == 0).all())  # the dropped last column
    torch.testing.assert_close(grad_k, grad_p, **CE_BWD_TOL[torch.bfloat16])


def _ppo_rows(b=5, t=104):
    """PPO rows at t 104 (a 64-token query bucket, a 40-token response):
    unpadded; padded at both ends; a query wholly padded and the response
    right padded; padded at both ends with a hole; no valid key at all."""
    mask = np.ones((b, t), np.int32)
    for row, (left, right) in enumerate([(0, 0), (5, 31), (64, 12), (10, 5), (t, 0)]):
        mask[row, :left] = 0
        mask[row, t - right:] = 0
    mask[3, 50:53] = 0
    return torch.from_numpy(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [False, True])
def test_flash_attention_at_ppo_shapes_matches_plain(cuda, dtype, grad):
    """flash_attention at t 104 with rows padded at both ends, a hole and a
    dead row: without grad K3 against the plain forward; with grad K4, K5
    and K6 through autograd against the same function on CPU copies (the
    plain versions). gpt2-small's 12/12/64."""
    from trlx_tpu_torch.ops import attention as A

    rng = np.random.RandomState(6)
    b, t, nh, hd = 5, 104, 12, 64
    q, k, v, g = (torch.from_numpy(rng.randn(b, t, nh, hd).astype(np.float32)).to(dtype) for _ in range(4))
    mask = _ppo_rows(b, t)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        qs, ks, vs = (x.to(dev).requires_grad_(grad) for x in (q, k, v))
        kernels.reset_launches()
        with torch.set_grad_enabled(grad):
            out = A.flash_attention(qs, ks, vs, mask.to(dev), causal=True)
            if grad:
                out.backward(g.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            want = ({A.KERNEL_FWD_LSE: 1, A.KERNEL_BWD_DQ: 1, A.KERNEL_BWD_DKV: 1} if grad
                    else {A.KERNEL_FWD: 1})
            assert {n: c for n, c in kernels.LAUNCHES.items() if c} == want
        runs.append([out.detach().cpu()] + ([x.grad.cpu() for x in (qs, ks, vs)] if grad else []))
    (out, *grads), (out_ref, *grads_ref) = runs
    torch.testing.assert_close(out.float(), out_ref.float(), **FWD_TOL[dtype])
    dead = mask.cumsum(-1) == 0  # queries with no valid key at or before them
    assert bool((out[dead] == 0).all())
    for got, ref in zip(grads, grads_ref):
        torch.testing.assert_close(got.float(), ref.float(), **BWD_TOL[dtype])
    if grad:
        assert bool((grads[0][dead] == 0).all())
        assert bool((grads[1][mask == 0] == 0).all()) and bool((grads[2][mask == 0] == 0).all())


@pytest.mark.cuda
def test_label_logprobs_on_shifted_contiguous_logits(cuda):
    """K7 at the scoring shape [128 x 104, 50257] bf16, called the way the
    PPO scoring pass calls it: the full contiguous logits with the labels
    shifted one column (`shifted_logprobs`), one launch and no copy of the
    [b, t - 1, V] slice; against the plain version on that slice."""
    from trlx_tpu_torch.ops.fused_ce import KERNEL as CE, label_logprobs_plain
    from trlx_tpu_torch.trainer.ppo_trainer import shifted_logprobs

    gen = torch.Generator(device=cuda).manual_seed(7)
    b, t, vocab = 128, 104, 50257
    logits = torch.randn(b, t, vocab, generator=gen, device=cuda).mul_(3).to(torch.bfloat16)
    tokens = torch.randint(0, vocab, (b, t), generator=gen, device=cuda)
    kernels.reset_launches()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got = shifted_logprobs(logits, tokens)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[CE] == 1 and got.shape == (b, t - 1)
    assert torch.cuda.max_memory_allocated() - before < logits.numel()  # no copy of the logits
    want = label_logprobs_plain(logits[:, :-1].reshape(-1, vocab), tokens[:, 1:].reshape(-1))[0]
    torch.testing.assert_close(got.reshape(-1), want, rtol=1e-5, atol=1e-4)
