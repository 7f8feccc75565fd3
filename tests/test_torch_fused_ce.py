"""The port's fused label logprob (trlx_tpu_torch/ops/fused_ce.py)
against the JAX package's: the value against the Pallas streaming kernel
in interpret mode and the value and gradient against
`fused_logprobs_of_labels` (its XLA path on the CPU), with labels out of
range (clamped into [0, V)) and vocabularies that no block size divides.
On the CPU the port's wrapper runs its plain version.

Also: the plain backward (`label_logprobs_bwd_plain`) against JAX's
`_fused_bwd`; the arithmetic of the CUDA forward (its row peel, tiles,
split and merge), emulated in torch, against the Pallas kernel; and the
host-side plan (`split_plan`, `row_peel`).

Tolerances: at f32, 1e-5 (summation order only). At bf16 logits both
sides read the same bf16 values and compute in f32: the logprobs within
1e-5; the gradient is cast to bf16 on both sides, so one bf16 ulp
(rtol 8e-3, atol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops.fused_ce import _fused_bwd, _logprobs_pallas, _logprobs_xla
from trlx_tpu.ops.fused_ce import fused_logprobs_of_labels as j_fused
from trlx_tpu.trainer.sft_trainer import causal_lm_ce_loss as j_ce_loss
from trlx_tpu_torch.ops import fused_ce as F
from trlx_tpu_torch.ops.fused_ce import fused_logprobs_of_labels, label_logprobs
from trlx_tpu_torch.trainer.sft_trainer import causal_lm_ce_loss

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(n, v, dtype, seed=0, lead=None):
    rng = np.random.RandomState(seed)
    shape = lead or (n,)
    logits = (2 * rng.randn(*shape, v)).astype(np.float32)
    labels = rng.randint(-4, v + 4, shape).astype(np.int32)  # some out of range
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(logits, jdt), jnp.asarray(labels),
            torch.from_numpy(logits).to(tdt), torch.from_numpy(labels))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,v", [(64, 777), (13, 300)])
def test_label_logprobs_match_pallas_kernel(n, v, dtype):
    jl, jlab, tl, tlab = _case(n, v, dtype)
    jlab = jnp.clip(jlab, 0, v - 1)
    j_out, j_lse = _logprobs_pallas(jl, jlab, block_rows=8, block_v=256, interpret=True)
    t_out, t_lse = label_logprobs(tl, tlab.clamp(0, v - 1))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_logprobs_value_and_grad_match_jax(dtype):
    jl, jlab, tl, tlab = _case(0, 517, dtype, seed=1, lead=(3, 5))
    g = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    j_val, j_vjp = jax.vjp(lambda x: j_fused(x, jlab), jl)
    (j_grad,) = j_vjp(jnp.asarray(g))
    x = tl.clone().requires_grad_(True)
    out = fused_logprobs_of_labels(x, tlab)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and x.grad.dtype == tl.dtype
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_val), rtol=1e-5, atol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=8e-3, atol=1e-3)
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(j_grad, np.float32), **tol)


def test_causal_lm_ce_loss_matches_jax():
    """The SFT loss over left-padded rows and dialogue labels (-100)."""
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 9, 41).astype(np.float32)
    ids = rng.randint(0, 41, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, :3] = 0
    labels = np.where(rng.rand(2, 9) < 0.3, -100, ids).astype(np.int32)
    for lab in (None, labels):
        j_loss, _ = j_ce_loss(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask),
                              None if lab is None else jnp.asarray(lab))
        t_loss, stats = causal_lm_ce_loss(torch.from_numpy(logits), torch.from_numpy(ids).long(),
                                          torch.from_numpy(mask), None if lab is None else torch.from_numpy(lab).long())
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6, atol=1e-6)
        assert float(stats["loss"]) == float(t_loss)


# --- the plain backward against JAX's `_fused_bwd` ---------------------------

# f32: both sides compute exp(x - lse), the one-hot difference and the
# scale in f32, so they differ by the exponential's last bit: 1e-6. bf16:
# both round the same f32 formula once, so one bf16 ulp apart at most
# (2^-7 relative bounds an ulp; atol only for values that round to 0).
BWD_PLAIN_TOL = {"f32": dict(rtol=1e-6, atol=1e-6), "bf16": dict(rtol=2**-7, atol=1e-30)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,v", [(37, 1001), (5, 7)])
def test_label_logprobs_bwd_plain_matches_jax_fused_bwd(n, v, dtype):
    """Labels out of range (clamped into [0, V) first, as the entry point
    does) and an incoming gradient with zeros (masked rows)."""
    jl, jlab, tl, tlab = _case(n, v, dtype, seed=4)
    jlab = jnp.clip(jlab, 0, v - 1)
    _, j_lse = _logprobs_xla(jl, jlab)
    g = np.random.RandomState(5).randn(n).astype(np.float32)
    g[::3] = 0.0
    (j_grad, _) = _fused_bwd((jl, jlab, j_lse), jnp.asarray(g))
    t_grad = F.label_logprobs_bwd_plain(tl, tlab.clamp(0, v - 1), torch.from_numpy(np.array(j_lse)),
                                        torch.from_numpy(g))
    assert t_grad.dtype == tl.dtype and t_grad.shape == tl.shape
    assert bool((t_grad[::3] == 0).all())
    np.testing.assert_allclose(t_grad.float().numpy(), np.asarray(j_grad, np.float32), **BWD_PLAIN_TOL[dtype])


# --- the CUDA forward's arithmetic, emulated -------------------------------

LOG2E = 1.4426950408889634
F_NEG_INF = -1e30  # the kernel's NEG_INF


def _merge(m, l, m2, l2):
    mn = torch.maximum(m, m2)
    return mn, l * torch.exp2((m - mn) * LOG2E) + l2 * torch.exp2((m2 - mn) * LOG2E)


def _butterfly(m, l):
    """A warp's xor butterfly over the last dim (32 lanes): lane i merges
    lane i ^ off into itself, for off = 16 .. 1; lane 0's result."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        m, l = _merge(m, l, m[..., lanes ^ off], l[..., lanes ^ off])
    return m[..., 0], l[..., 0]


def emulate_label_logprobs(x, labels, address, itemsize, splits):
    """The forward kernel's function, step by step, in f32: x [N, V] f32
    (the logits' values), rows at byte address `address + r * V * itemsize`.
    Each row is peeled (`row_peel`) into a head, 16-byte vectors and a
    tail; its vectors are cut into `splits` slices, one block of THREADS
    threads each; a thread folds the head or tail element it owns, then
    its tiles of TILE vectors (v0 + t + (k * TILE + u) * THREADS): the
    tile's max, one rescale, the sum of exp2(x * log2e - m * log2e). A
    block merges its threads by warp butterflies, then one over the 8
    warps' results; the cluster's first block merges the blocks in rank
    order. Also checks that every column is read exactly once."""
    n, v = x.shape
    per = F.VECTOR_BYTES // itemsize
    T, U = F.THREADS, F.TILE
    neg = torch.tensor(F_NEG_INF)
    lse = torch.empty(n)
    for r in range(n):
        head, n_vec, tail = F.row_peel(address + r * v * itemsize, v, itemsize)
        seen = np.zeros(v, np.int64)
        parts = []
        for rank in range(splits):
            m = torch.full((T,), F_NEG_INF)
            l = torch.zeros(T)

            def fold(mask, cols):
                nonlocal m, l
                xv = torch.full((T,), -float("inf"))
                xv[mask] = x[r, cols]
                seen[cols] += 1
                mn = torch.maximum(m, xv)
                l = torch.where(mask, l * torch.exp2((m - mn) * LOG2E) + torch.exp2((xv - mn) * LOG2E), l)
                m = torch.where(mask, mn, m)

            t = torch.arange(T)
            if rank == 0:
                fold(t < head, torch.arange(min(head, T)))
            if rank == splits - 1:
                fold(t < tail, head + n_vec * per + torch.arange(min(tail, T)))
            v0, v1 = n_vec * rank // splits, n_vec * (rank + 1) // splits
            k = 0
            while v0 + k * T * U < v1:
                idx = v0 + t[:, None] + (k * U + torch.arange(U))[None, :] * T  # [T, U] vector index
                valid = idx < v1
                cols = head + idx[..., None] * per + torch.arange(per)  # [T, U, per]
                vals = torch.where(valid[..., None], x[r, cols.clamp(max=v - 1)], torch.tensor(-float("inf")))
                np.add.at(seen, cols[valid].reshape(-1).numpy(), 1)
                active = valid[:, 0]
                mn = torch.maximum(m, vals.amax((1, 2)))
                s = torch.exp2(vals * LOG2E - (mn * LOG2E)[:, None, None]).sum((1, 2))
                l = torch.where(active, l * torch.exp2((m - mn) * LOG2E) + s, l)
                m = torch.where(active, mn, m)
                k += 1
            wm, wl = _butterfly(m.view(T // 32, 32), l.view(T // 32, 32))  # each warp
            pad = 32 - T // 32
            bm, bl = _butterfly(torch.cat([wm, neg.expand(pad)]), torch.cat([wl, torch.zeros(pad)]))
            parts.append((bm, bl))
        assert (seen == 1).all(), f"row {r}: columns read {np.unique(seen)} times"
        m, l = neg, torch.tensor(0.0)
        for bm, bl in parts:  # rank order
            m, l = _merge(m, l, bm, bl)
        lse[r] = m + torch.log(l)
    return x[torch.arange(n), labels.long()] - lse, lse



@pytest.mark.parametrize("n,v,dtype,splits,address", [
    (3, 50257, "bf16", 1, 0),
    (3, 50257, "bf16", 4, 6),
    (2, 50257, "bf16", 8, 14),
    (2, 50257, "f32", 4, 4),
    (9, 1001, "bf16", 1, 2),
    (9, 1001, "bf16", 2, 0),
    (9, 1001, "f32", 1, 8),
])
def test_emulated_forward_partition_matches_pallas_kernel(n, v, dtype, splits, address):
    """The emulated CUDA forward (peel, tiles, split, ordered merge) against
    the Pallas kernel in interpret mode on the same values, 1e-5; with V
    odd, consecutive bf16 rows start at different alignments."""
    jl, jlab, tl, tlab = _case(n, v, dtype, seed=6)
    jlab = jnp.clip(jlab, 0, v - 1)
    j_out, j_lse = _logprobs_pallas(jl, jlab, block_rows=8, block_v=2048 if v > 2048 else 256, interpret=True)
    itemsize = 2 if dtype == "bf16" else 4
    e_out, e_lse = emulate_label_logprobs(tl.float(), tlab.clamp(0, v - 1), address, itemsize, splits)
    np.testing.assert_allclose(e_lse.numpy(), np.asarray(j_lse), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)


# --- the host-side plan ----------------------------------------------------


@pytest.mark.parametrize("offset", range(0, 16, 2))
def test_row_peel_of_every_bf16_alignment(offset):
    """A bf16 row of V = 50257 starting `offset` bytes past a 16-byte
    boundary: the head runs to the next boundary, whole vectors follow,
    the tail holds the rest (counted element by element here)."""
    v = 50257
    head = 0
    while head < v and (offset + 2 * head) % 16:
        head += 1
    vectors = (v - head) // 8
    assert F.row_peel(1024 + offset, v, 2) == (head, vectors, v - head - 8 * vectors)
    assert head == (16 - offset) % 16 // 2 and head < 8 and v - head - 8 * vectors < 8
    assert F.row_peel(offset, 3, 2) == (min(head, 3), 0, 3 - min(head, 3))  # V < 8


def test_split_plan_from_shapes():
    """One block a row where rows fill the card (SFT's 8,184 and 8,192,
    scoring's 13,312), four at the PPO window's 1,280, up to eight (f32)
    for a single row; never more blocks than a row has tiles."""
    assert [F.split_plan(n, 50257, 2) for n in (8184, 8192, 13312, 1280, 64, 1)] == [1, 1, 1, 4, 4, 4]
    assert [F.split_plan(n, 50257, 4) for n in (8184, 1280, 1)] == [1, 4, 8]
    assert F.split_plan(1, 1001, 2) == 1 and F.split_plan(1, 7, 4) == 1
    for n in (1, 100, 1280, 5000):
        for v in (7, 1001, 50257, 128256):
            s = F.split_plan(n, v, 2)
            assert s in (1, 2, 4, 8) and (s == 1 or v * 2 // 16 // s >= F.THREADS * F.TILE)


def test_bwd_split_plan_from_shapes():
    """The backward's independent blocks: eight a row at vocab 50257 (bf16
    and f32), one where a row has fewer vectors than two blocks' threads;
    every block keeps a vector a thread."""
    assert F.bwd_split_plan(50257, 2) == 8 and F.bwd_split_plan(50257, 4) == 8
    assert F.bwd_split_plan(1001, 2) == 1 and F.bwd_split_plan(7, 2) == 1
    assert F.bwd_split_plan(4500, 2) == 2 and F.bwd_split_plan(4500, 4) == 4
    for v in (7, 1001, 4500, 50257, 128256):
        for itemsize in (2, 4):
            s = F.bwd_split_plan(v, itemsize)
            assert s in (1, 2, 4, 8) and (s == 1 or v * itemsize // 16 // s >= F.THREADS)
