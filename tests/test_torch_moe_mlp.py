"""The MoE MLP and its gradients against the JAX package, the cases of
`test_torch_moe.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): with
and without the GLU and the biases."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.data.default_configs import default_sft_config as j_default_sft_config
from trlx_tpu.inference import InferenceEngine as JEngine
from trlx_tpu.models import policy as j_policy
from trlx_tpu.models import transformer as jtf
from trlx_tpu.models.hf_interop import params_to_hf_state_dict as j_params_to_hf_state_dict
from trlx_tpu.ops import quant as j_quant
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQLTrainer
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu.trainer.sft_trainer import SFTTrainer as JSFTTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import ILQLBatch, PPORLBatch
from trlx_tpu_torch.data.default_configs import (
    default_grpo_config,
    default_ilql_config,
    default_ppo_config,
    default_sft_config,
)
from trlx_tpu_torch.inference import InferenceEngine
from trlx_tpu_torch.models import hf_interop, policy
from trlx_tpu_torch.models import transformer as tf
from trlx_tpu_torch.ops import quant, sampling
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer
from trlx_tpu_torch.utils import flatten_dict
from trlx_tpu_torch.utils.modeling import apply_with_moe_aux
from test_torch_moe import (  # the cases' helpers, shared with test_torch_moe.py
    MOE,
    V,
    _close,
    _np,
    _t,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("glu,bias", [(False, True), (False, False), (True, True), (True, False)])
def test_moe_mlp_and_its_gradients_match_jax(glu, bias):
    kw = dict(vocab_size=V, d_model=16, n_layers=1, n_heads=2, d_ff=32, glu=glu, use_bias=bias,
              activation="silu" if glu else "gelu", **MOE)
    jcfg, tcfg = jtf.TransformerConfig(dtype=jnp.float32, **kw), tf.TransformerConfig(dtype=torch.float32, **kw)
    rng = np.random.RandomState(1)
    h = rng.randn(2, 6, 16).astype(np.float32)
    w = rng.randn(2, 6, 16).astype(np.float32)
    jmod = jtf.MoEMLP(jcfg)
    jparams = jmod.init(jax.random.PRNGKey(0), jnp.asarray(h))["params"]
    if bias:  # non-zero biases, as training would make them
        jparams = {**jparams, "up_bias": jnp.asarray(rng.randn(4, 32), jnp.float32) * 0.1,
                   "down_bias": jnp.asarray(rng.randn(4, 16), jnp.float32) * 0.1}
    tmod = tf.MoEMLP(tcfg)
    tmod.load_state_dict(params_from_jax(_np(jparams)))
    assert {n: tuple(p.shape) for n, p in tmod.named_parameters()} == {
        **{"router.weight": (4, 16), "up_proj": (4, 16, 32), "down_proj": (4, 32, 16)},
        **({"gate_proj": (4, 16, 32)} if glu else {}),
        **({"up_bias": (4, 32), "down_bias": (4, 16)} if bias else {})}

    def j_scalar(params, x):
        out, inter = jmod.apply({"params": params}, x, mutable=["intermediates"])
        aux = jtf.moe_aux_from_intermediates(inter)
        return jnp.sum(out * jnp.asarray(w)) + aux, (out, aux)

    (j_val, (j_out, j_aux)), (j_gp, j_gh) = jax.value_and_grad(j_scalar, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_(True)
    with tf.collect_moe_aux() as terms:
        t_out = tmod(th)
    assert len(terms) == 1
    t_val = (t_out * torch.from_numpy(w)).sum() + terms[0]
    t_val.backward()
    _close(_t(t_out), j_out, 1e-5)
    _close(float(terms[0].detach()), float(j_aux), 1e-5)
    _close(float(t_val.detach()), float(j_val), 1e-5)
    _close(_t(th.grad), j_gh, 1e-4)
    want = params_from_jax(_np(j_gp))
    for name, p in tmod.named_parameters():
        _close(_t(p.grad), want[name].numpy(), 1e-4)
    assert float(tmod.router.weight.grad.abs().max()) > 0  # the term and the gates reach the router
