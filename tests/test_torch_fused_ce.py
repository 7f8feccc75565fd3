"""The port's fused label logprob (trlx_tpu_torch/ops/fused_ce.py)
against the JAX package's: the value against the Pallas streaming kernel
in interpret mode and the value and gradient against
`fused_logprobs_of_labels` (its XLA path on the CPU), with labels out of
range (clamped into [0, V)) and vocabularies that no block size divides.
On the CPU the port's wrapper runs its plain version.

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

from trlx_tpu.ops.fused_ce import _logprobs_pallas
from trlx_tpu.ops.fused_ce import fused_logprobs_of_labels as j_fused
from trlx_tpu.trainer.sft_trainer import causal_lm_ce_loss as j_ce_loss
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
