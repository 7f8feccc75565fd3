"""The arithmetic of the split paged-decode kernel
(trlx_tpu_torch/csrc/paged_attention.cu), emulated in torch on the CPU,
against the JAX package's Pallas kernel in interpret mode and against the
port's plain version, on the same numpy inputs; and the host's split plan.

The emulation follows the kernel step by step: a table row is cut into
splits of `pages_per_split` entries; each split keeps its live pages (an
entry inside the arena with a valid column), folds them into an f32
online softmax with NEG_INF = -1e30 and the clamped shift, and leaves
(m, l, acc); the merge weighs the splits in index order by exp(m - max m),
an empty split (m = NEG_INF) by exactly 0 without reading its acc, which
the kernel never writes (NaN here, so reading it would show).

Tolerance: 1e-5 absolute/relative at f32, where the sides differ only in
the order of their sums."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import quant as jquant
from trlx_tpu.ops.paged_attention import paged_attention_decode as j_decode
from trlx_tpu_torch.ops import quant
from trlx_tpu_torch.ops.paged_attention import (
    GRID_CAP,
    MAX_SPLITS,
    NEG_INF,
    paged_attention_plain,
    split_plan,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, HD, BLK, N_TBL, N_BLOCKS = 4, 16, 4, 9, 12


def emulate(q, k_arena, v_arena, table, key_mask, pages_per_split, k_scale=None, v_scale=None):
    """The kernel's function, split by split, in f32."""
    b, nh, hd = q.shape
    n_blocks, blk, nkv, _ = k_arena.shape
    n_tbl = table.shape[1]
    group = nh // nkv
    n_splits = -(-n_tbl // pages_per_split)
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(b, nh, hd)
    for r in range(b):
        for h in range(nkv):
            qg = q[r, h * group:(h + 1) * group].float()
            parts = []
            for s in range(n_splits):
                m = torch.full((group,), NEG_INF)
                l = torch.zeros(group)
                acc = torch.full((group, hd), float("nan"))  # never written by an empty split
                for j in range(s * pages_per_split, min((s + 1) * pages_per_split, n_tbl)):
                    phys = int(table[r, j])
                    valid = key_mask[r, j * blk:(j + 1) * blk] != 0
                    if not (0 <= phys < n_blocks) or not bool(valid.any()):
                        continue
                    if torch.isnan(acc).all():
                        acc = torch.zeros(group, hd)
                    k = k_arena[phys, :, h].float()
                    v = v_arena[phys, :, h].float()
                    if k_scale is not None:
                        k = k * k_scale[phys, :, h][:, None]
                        v = v * v_scale[phys, :, h][:, None]
                    sc = torch.where(valid[None, :], (qg @ k.T) * scale, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, sc.amax(1))
                    shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
                    p = torch.where(sc <= NEG_INF / 2, 0.0, torch.exp(sc - shift[:, None]))
                    corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ v
                    m = m_new
                parts.append((m, l, acc))
            top = torch.stack([m for m, _, _ in parts]).amax(0)
            den = torch.zeros(group)
            num = torch.zeros(group, hd)
            for m, l, acc in parts:  # index order
                w = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - top))
                den = den + w * l
                num = num + torch.where(w[:, None] != 0, w[:, None] * acc, 0.0)
            out[r, h * group:(h + 1) * group] = num / torch.where(den > 0, den, 1.0)[:, None]
    return out


def _case(seed, nh, nkv):
    """Row 0: its valid columns inside one page (so one split at any plan).
    Row 1: valid pages 0-1 and 6-8 around masked pages 2-5 (a wholly masked
    split between two valid ones at 1, 2 and 3 pages a split). Row 2: no
    valid column. Row 3: out-of-range entries mid-row under a mask of 1."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, nh, HD).astype(np.float32)
    ka = rng.randn(N_BLOCKS, BLK, nkv, HD).astype(np.float32)
    va = rng.randn(N_BLOCKS, BLK, nkv, HD).astype(np.float32)
    table = rng.randint(0, N_BLOCKS, (B, N_TBL)).astype(np.int32)
    table[3, 2], table[3, 5] = -1, N_BLOCKS + 3
    mask = np.zeros((B, N_TBL, BLK), np.int32)
    mask[0, 1, 1:3] = 1
    mask[1, 0] = 1
    mask[1, 1, :2] = 1
    mask[1, 6, 1:] = 1
    mask[1, 8, 0] = 1
    mask[3, :7] = 1
    return q, ka, va, table, mask.reshape(B, N_TBL * BLK)


def _jax_args(table, mask):
    """The port's rule for out-of-range entries (masked columns, never
    read) given to the Pallas kernel as what it means: entry 0, mask 0."""
    inside = (table >= 0) & (table < N_BLOCKS)
    return np.where(inside, table, 0), mask * np.repeat(inside, BLK, axis=1)


@functools.lru_cache(maxsize=None)
def _reference(nh, nkv, kv):
    q, ka, va, table, mask = _case(nh + 3 * nkv, nh, nkv)
    tj, mj = _jax_args(table, mask)
    if kv == "int8":
        kq, ks = quant.quantize_kv(torch.from_numpy(ka))
        vq, vs = quant.quantize_kv(torch.from_numpy(va))
        kqj, ksj = jquant.quantize_kv(jnp.asarray(ka))
        vqj, vsj = jquant.quantize_kv(jnp.asarray(va))
        np.testing.assert_array_equal(kq.numpy(), np.asarray(kqj))
        out_j = j_decode(jnp.asarray(q), kqj, vqj, jnp.asarray(tj), jnp.asarray(mj),
                         k_scale=ksj, v_scale=vsj, interpret=True)
        arenas, scales = (kq, vq), dict(k_scale=ks, v_scale=vs)
    else:
        out_j = j_decode(*map(jnp.asarray, (q, ka, va, tj, mj)), interpret=True)
        arenas, scales = (torch.from_numpy(ka), torch.from_numpy(va)), {}
    args = (torch.from_numpy(q), *arenas, torch.from_numpy(table), torch.from_numpy(mask))
    return args, scales, np.asarray(out_j), paged_attention_plain(*args, **scales).numpy()


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("nh,nkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3, N_TBL])
def test_split_and_merge_match_pallas_and_plain(pages_per_split, nh, nkv, kv):
    args, scales, out_j, out_p = _reference(nh, nkv, kv)
    out_e = emulate(*args, pages_per_split, **scales).numpy()
    assert np.isfinite(out_e).all()
    np.testing.assert_allclose(out_e, out_j, **TOL)
    np.testing.assert_allclose(out_e, out_p, **TOL)
    assert np.all(out_e[2] == 0.0)  # a row with no valid column is exactly 0


@pytest.mark.parametrize("b,nkv,n_tbl", [
    (8, 12, 10),    # gpt2-small serving: one page a split, 960 blocks
    (8, 8, 128),    # gqa-4k: 8 pages a split, 16 splits, 1024 blocks
    (8, 32, 10),    # llama-7b serving
    (8, 1, 10),     # MQA
    (1, 8, 128),    # one long row: held to MAX_SPLITS
    (64, 32, 4),    # more (slot, kv head) pairs than GRID_CAP: one split
    (3, 5, 7),
    (1, 1, 1),
    (16, 12, 300),
])
def test_split_plan_covers_the_table_within_the_caps(b, nkv, n_tbl):
    pps, n_splits = split_plan(b, nkv, n_tbl)
    assert (pps, n_splits) == split_plan(b, nkv, n_tbl)  # shapes in, no state
    assert 1 <= pps <= n_tbl
    assert n_splits == -(-n_tbl // pps) and (n_splits - 1) * pps < n_tbl <= n_splits * pps
    assert b * nkv * n_splits <= max(GRID_CAP, b * nkv)
    assert n_splits <= MAX_SPLITS
    if pps > 1:  # the fewest pages a split that keep both caps
        fewer = -(-n_tbl // (pps - 1))
        assert b * nkv * fewer > GRID_CAP or fewer > MAX_SPLITS
    expected = {(8, 12, 10): (1, 10), (8, 8, 128): (8, 16)}
    assert expected.get((b, nkv, n_tbl), (pps, n_splits)) == (pps, n_splits)
