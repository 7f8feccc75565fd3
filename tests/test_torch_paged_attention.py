"""The port's paged-attention decode (trlx_tpu_torch/ops/paged_attention.py)
against the JAX package's: the plain PyTorch version of the CUDA kernel
vs the Pallas kernel in interpret mode, and the gather reference vs
its JAX counterpart, on the same numpy inputs.

Tolerances: 1e-5 absolute/relative at f32 (the two sides sum in another
order); bf16 arenas hold the same bf16 values on both sides and are read
in f32, so the same bound holds; int8 codes and scales are bit-equal
(`quantize_kv` rounds half to even in both frameworks)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trlx_tpu.ops import quant as jquant
from trlx_tpu.ops.paged_attention import (
    paged_attention_decode as j_decode,
    paged_attention_reference as j_reference,
)
from trlx_tpu_torch import kernels
from trlx_tpu_torch.ops import quant
from trlx_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_plain,
    paged_attention_reference,
)

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, nh, nkv, b=3, hd=16, blk=8, n_tbl=4, n_blocks=10):
    """Lengths inside block 0, across the block-2 boundary, and one
    inactive row (length 0)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, nh, hd).astype(np.float32)
    ka = rng.randn(n_blocks, blk, nkv, hd).astype(np.float32)
    va = rng.randn(n_blocks, blk, nkv, hd).astype(np.float32)
    ka[0] = 0.0
    va[0] = 0.0
    table = rng.randint(0, n_blocks, (b, n_tbl)).astype(np.int32)
    lens = np.asarray([blk - 1, 2 * blk + 1, 0][:b])
    mask = (np.arange(n_tbl * blk)[None, :] < lens[:, None]).astype(np.int32)
    return q, ka, va, table, mask, lens > 0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (4, 1)])
def test_plain_matches_jax_kernel_and_reference_f32(nh, nkv):
    q, ka, va, table, mask, active = _case(0, nh, nkv)
    out_j = np.asarray(j_decode(*map(jnp.asarray, (q, ka, va, table, mask)), interpret=True))
    ref_j = np.asarray(j_reference(*map(jnp.asarray, (q, ka, va, table, mask))))
    out_t = paged_attention_plain(*_t(q, ka, va, table, mask)).numpy()
    ref_t = paged_attention_reference(*_t(q, ka, va, table, mask)).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(ref_t[active], ref_j[active], **TOL)
    np.testing.assert_allclose(out_t[active], ref_t[active], **TOL)
    # an inactive row is exactly 0.0 (a -inf softmax would give NaN)
    assert np.all(out_t[~active] == 0.0)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (4, 1)])
def test_plain_matches_jax_kernel_bf16_arenas(nh, nkv):
    q, ka, va, table, mask, active = _case(1, nh, nkv)
    kb, vb = jnp.asarray(ka, jnp.bfloat16), jnp.asarray(va, jnp.bfloat16)
    out_j = np.asarray(j_decode(jnp.asarray(q), kb, vb, jnp.asarray(table), jnp.asarray(mask),
                                interpret=True))
    kt = torch.from_numpy(np.array(kb.astype(jnp.float32))).to(torch.bfloat16)
    vt = torch.from_numpy(np.array(vb.astype(jnp.float32))).to(torch.bfloat16)
    out_t = paged_attention_plain(torch.from_numpy(q), kt, vt, *_t(table, mask)).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
    assert np.all(out_t[~active] == 0.0)


@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2), (4, 1)])
def test_plain_matches_jax_kernel_int8(nh, nkv):
    q, ka, va, table, mask, active = _case(2, nh, nkv)
    kq_j, ks_j = jquant.quantize_kv(jnp.asarray(ka))
    vq_j, vs_j = jquant.quantize_kv(jnp.asarray(va))
    kq, ks = quant.quantize_kv(torch.from_numpy(ka))
    vq, vs = quant.quantize_kv(torch.from_numpy(va))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(kq_j))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(ks_j))
    out_j = np.asarray(j_decode(jnp.asarray(q), kq_j, vq_j, jnp.asarray(table), jnp.asarray(mask),
                                k_scale=ks_j, v_scale=vs_j, interpret=True))
    ref_j = np.asarray(j_reference(jnp.asarray(q), kq_j, vq_j, jnp.asarray(table), jnp.asarray(mask),
                                   k_scale=ks_j, v_scale=vs_j))
    args = [torch.from_numpy(q), kq, vq, *_t(table, mask)]
    out_t = paged_attention_plain(*args, k_scale=ks, v_scale=vs).numpy()
    ref_t = paged_attention_reference(*args, k_scale=ks, v_scale=vs).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(ref_t[active], ref_j[active], **TOL)
    assert np.all(out_t[~active] == 0.0)


def test_quantize_kv_rounds_half_to_even():
    # amax 127 -> scale 1.0, so x / scale lands exactly on the halves
    x = np.asarray([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    q_t, s_t = quant.quantize_kv(torch.from_numpy(x))
    q_j, s_j = jquant.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q_t.numpy(), [[0, 2, 2, 0, -2, 127]])
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    back = quant.dequantize_kv(q_t, s_t, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jquant.dequantize_kv(q_j, s_j, jnp.float32)))


def test_int8_requires_scales():
    q, ka, va, table, mask, _ = _case(3, 4, 2)
    kq, _ = quant.quantize_kv(torch.from_numpy(ka))
    vq, _ = quant.quantize_kv(torch.from_numpy(va))
    with pytest.raises(ValueError, match="scale"):
        paged_attention_decode(torch.from_numpy(q), kq, vq, *_t(table, mask))


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    q, ka, va, table, mask, _ = _case(4, 4, 2)
    kernels.reset_launches()
    before = dict(kernels.LAUNCHES)
    out = paged_attention_decode(*_t(q, ka, va, table, mask))
    np.testing.assert_array_equal(out.numpy(), paged_attention_plain(*_t(q, ka, va, table, mask)).numpy())
    assert kernels.LAUNCHES == before


def test_out_of_range_table_entries_are_masked():
    """Table ids outside [0, n_blocks) count as masked columns (the engine
    never hands the kernel one; padding prefill rows carry them)."""
    q, ka, va, table, mask, active = _case(5, 4, 4)
    bad = table.copy()
    bad[1, 2:] = ka.shape[0]  # row 1's third and fourth blocks out of range
    masked = mask.copy()
    masked[1, 2 * ka.shape[1]:] = 0
    a = paged_attention_plain(*_t(q, ka, va, bad, mask)).numpy()
    b = paged_attention_plain(*_t(q, ka, va, table, masked)).numpy()
    np.testing.assert_array_equal(a, b)
