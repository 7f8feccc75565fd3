"""The MoE LM, its load-balancing term and decode against the JAX package,
the cases of `test_torch_moe.py` moved to a file of their own (the
suite's `--dist loadfile` hands out the files with the fewest tests
last, so these heavy ones fill a worker the parallelism files leave
idle): over gpt2-, llama- and neox-style blocks on padded rows, and the
cached decode against JAX's forward."""

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
    _rows,
    _t,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("preset", ["moe-tiny", "llama-tiny", "neox-tiny"])
def test_moe_lm_and_term_match_jax_on_padded_rows(preset):
    """gpt2-style, llama-style (GLU, no biases, GQA) and neox-style
    (parallel residual) blocks with MoE MLPs: logits over left-padded rows
    and the term, whose means run over the padding too."""
    jcfg = jtf.config_from_preset(preset, vocab_size=V, dtype=jnp.float32, **MOE)
    tcfg = tf.config_from_preset(preset, vocab_size=V, dtype=torch.float32, **MOE)
    jlm = jtf.TransformerLM(jcfg)
    ids, mask = _rows()
    jparams = jlm.init(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(mask))["params"]
    (j_logits, _, _), inter = jlm.apply({"params": jparams}, jnp.asarray(ids), jnp.asarray(mask),
                                        mutable=["intermediates"])
    tlm = tf.TransformerLM(tcfg)
    tlm.load_state_dict(params_from_jax(_np(jparams)))
    with torch.no_grad():
        (t_logits, _, _), t_aux = apply_with_moe_aux(tcfg, tlm, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(_t(t_logits), j_logits, 1e-5)
    _close(float(t_aux), jcfg.moe_aux_coef * float(jtf.moe_aux_from_intermediates(inter)), 1e-6)
    with torch.no_grad():  # padding rows count: dropping them moves the term
        _, t_aux_real = apply_with_moe_aux(tcfg, tlm, torch.from_numpy(ids[:1]).long(), torch.from_numpy(mask[:1]))
    assert abs(float(t_aux_real) - float(t_aux)) > 1e-6


def test_moe_decode_matches_jax_forward():
    """The cached prefill and decode steps against JAX's full forward (the
    JAX package's `test_moe_decode_matches_forward`, across packages)."""
    jcfg = jtf.config_from_preset("moe-tiny", vocab_size=V, dtype=jnp.float32)
    tcfg = tf.config_from_preset("moe-tiny", vocab_size=V, dtype=torch.float32)
    jlm = jtf.TransformerLM(jcfg)
    tokens = np.random.default_rng(0).integers(0, V, (2, 10)).astype(np.int32)
    mask = np.ones_like(tokens)
    jparams = jlm.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(mask))["params"]
    full = np.asarray(jlm.apply({"params": jparams}, jnp.asarray(tokens), jnp.asarray(mask))[0])
    tlm = tf.TransformerLM(tcfg)
    tlm.load_state_dict(params_from_jax(_np(jparams)))
    tt, tm = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    cache = tf.init_kv_cache(tcfg, 2, 10, dtype=torch.float32)
    with torch.no_grad():
        logits, _, cache = tlm.decode_step(tt[:, :5], cache, tm[:, :5], True)
        _close(_t(logits), full[:, :5], 1e-4)
        for i in range(5, 10):
            logits, _, cache = tlm.decode_step(tt[:, i:i + 1], cache, tm[:, i:i + 1], False)
            _close(_t(logits[:, 0]), full[:, i], 1e-4)
