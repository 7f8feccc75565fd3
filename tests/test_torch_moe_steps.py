"""MoE under the trainers' steps against the JAX package, the cases of
`test_torch_moe.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): the
int8 frozen-trunk view and a greedy collection over it, one GRPO step
and one ILQL step."""

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
    G,
    _check_params,
    _check_stats,
    _close,
    _common,
    _grpo_chunk,
    _np,
    _pair,
    _ppo_config,
    _prompts,
    reward_fn,
)

torch.set_num_threads(1)


def test_int8_frozen_trunk_of_moe_matches_jax(tmp_path):
    """`quantize_frozen_trunk` at split 1: the port's int8 leaves are
    bitwise JAX's `quantize_frozen_flat` (codes, scales, the dequantized
    weights), one scale per index of the last axis of JAX's layout: the
    router's kernel is the port's weight transposed, the experts'
    [E, d, f] and [E, f, d] leaves are the same tensors. A greedy
    collection of 8 rollouts from that view equals JAX's token for token,
    its logprobs, values and rewards within 1e-5."""
    def config(make, side):
        return _ppo_config(make, tmp_path, side, 0).evolve(method=dict(
            quantize_frozen_trunk=True, speculative_decode=False, cache_trunk_activations=False))

    jt, tt = _pair(JPPOTrainer, PPOTrainer, config(j_default_ppo_config, "jax"), config(default_ppo_config, "torch"),
                   reward_fn=reward_fn, stop_sequences=["�"])
    assert tt.split == jt.split == 1
    jt._decode_params()
    want = {}
    for key, node in jt._quant_frozen_cache.items():
        if not j_quant.is_quant_leaf(node):
            continue
        *mods, leaf = [str(k) for k in key]
        q, dense = np.asarray(node["q"]), np.asarray(j_quant.dequantize_array(node))
        if leaf == "kernel":
            q, dense = q.T, dense.T
        want[".".join([*mods, {"kernel": "weight", "embedding": "weight"}.get(leaf, leaf)])] = (
            q, np.asarray(node["scale"]), dense)
    got = tt._decode_params()
    assert set(got) == set(want)
    assert {"lm.block_0.mlp.router.weight", "lm.block_0.mlp.up_proj", "lm.block_0.mlp.down_proj"} <= set(got) and "lm.block_1.mlp.up_proj" not in got
    dense = quant.dequantize_tree(got, torch.float32)
    for name, (q, scale, d) in want.items():
        np.testing.assert_array_equal(got[name][0].numpy(), q, err_msg=name)
        np.testing.assert_array_equal(got[name][1].numpy().reshape(-1), scale, err_msg=name)
        np.testing.assert_array_equal(dense[name].numpy(), d, err_msg=name)
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    assert len(tt.store.history) == len(jt.store.history) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)


def test_one_grpo_step_matches_jax(tmp_path):
    mk = lambda make, side: make().evolve(**_common(tmp_path, side), method=dict(
        num_rollouts=8, chunk_size=8, ppo_epochs=1, group_size=G, init_kl_coef=0.05, grpo_kl_coef=0.1,
        gen_kwargs=dict(max_new_tokens=8, do_sample=False)))
    jt, tt = _pair(JGRPOTrainer, GRPOTrainer, mk(j_default_grpo_config, "jax"), mk(default_grpo_config, "torch"),
                   reward_fn=reward_fn)
    prompts, outputs, scores, (lp, vals, lr) = _grpo_chunk(0)
    args = (prompts, outputs, None, scores, np.ones_like(scores, bool), lp, vals, lr)
    jt.store.push(jt._chunk_to_elements(*args))
    tt.store.push(tt._chunk_to_elements(*args))
    jb = next(iter(jt.create_train_dataloader()))
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards", "group_ids")
    ib = PPORLBatch(**{f: np.asarray(getattr(jb, f)) for f in fields})
    _check_stats(tt.train_minibatch([ib]), flatten_dict(_np(jt.train_minibatch([jb]))))
    _check_params(jt, tt, 1)


def test_one_ilql_step_matches_jax(tmp_path):
    """The ILQL loss (Q, V, CQL and AWAC terms) plus the MoE term, its
    `losses/loss` the optimised sum, then one step."""
    mk = lambda make, side: make().evolve(**_common(tmp_path, side, seq_length=24), method=dict(
        steps_for_target_q_sync=5, alpha=0.3, beta=1.0, gen_kwargs=dict(max_new_tokens=6, top_k=5, beta=1.0)))
    jt, tt = _pair(JILQLTrainer, ILQLTrainer, mk(j_default_ilql_config, "jax"), mk(default_ilql_config, "torch"))
    rng = np.random.RandomState(1)
    word = lambda k: "".join(chr(97 + c) for c in rng.randint(0, 26, k))
    samples = [[word(rng.randint(3, 9)), word(rng.randint(2, 12))] for _ in range(8)]
    rewards = list(rng.randn(len(samples)))
    jt.make_experience(samples, rewards, 24)
    tt.make_experience(samples, rewards, 24)
    jb = next(iter(jt.create_train_dataloader()))
    fields = ("input_ids", "attention_mask", "rewards", "states_ixs", "actions_ixs", "dones")
    ib = ILQLBatch(*(np.asarray(getattr(jb, f)) for f in fields))
    j_stats = flatten_dict(_np(jt.train_minibatch([jb])))
    t_stats = tt.train_minibatch([ib])
    _check_stats(t_stats, j_stats)
    _close(t_stats["losses/loss"], j_stats["losses/loss"], 1e-5)
    _check_params(jt, tt, 1)
