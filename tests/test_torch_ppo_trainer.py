"""PPOTrainer against the JAX trainer on one trainer pair, the cases of
`test_torch_ppo.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): a
greedy collection, the first step, the parameters after three steps, the
reference left alone, the windowed head against the full forward, and
the token count."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu.data import PPORLElement as JPPORLElement
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.ops import ppo as j_ppo
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.pipeline.ppo_pipeline import PPORolloutStorage as JPPORolloutStorage
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu.utils import modeling as j_modeling
from trlx_tpu_torch import resilience
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops import ppo
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer, shifted_logprobs
from trlx_tpu_torch.utils import flatten_dict, modeling
from test_torch_ppo import (  # the cases' helpers, shared with test_torch_ppo.py
    STEPS,
    _close,
    _pair,
    _prompts,
    _rows,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ppo_pair(tmp_path_factory):
    """Both trainers on gpt2-tiny: one greedy collection of 8 rollouts,
    then STEPS optimizer steps on the same collated batches."""
    tmp = tmp_path_factory.mktemp("ppo")
    jt, tt = _pair("gpt2-tiny", tmp)
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    ref_before = {k: v.clone() for k, v in tt.ref_model.state_dict().items()}
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    tbatches = [b for _ in range(2) for b in tt.create_train_dataloader()][:STEPS]
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards")
    # the loaders' batches equal, then the JAX batches injected into both
    injected = [PPORLBatch(**{f: np.asarray(getattr(b, f)) for f in fields}) for b in jbatches]
    j_stats, t_stats = [], []
    for jb, ib in zip(jbatches, injected):
        j_stats.append(flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([ib]))
    return dict(jt=jt, tt=tt, tbatches=tbatches, injected=injected, j_stats=j_stats, t_stats=t_stats,
                ref_before=ref_before)


def test_greedy_make_experience_matches_jax(ppo_pair):
    """(f) tokens exactly equal; logprobs, values and rewards 1e-5; the
    logged stats keys equal. (b) the train loaders' batches equal."""
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    assert len(tt.store) == len(jt.store) == 8
    padded_both_ends = 0
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)
        padded_both_ends += int(e.query_tensor[0] == 256) * int(len(e.response_tensor) < 8)
    assert padded_both_ends > 0  # some rows are padded at both ends in the scoring pass
    assert tt.mean_kl == pytest.approx(jt.mean_kl, rel=1e-5, abs=1e-9)
    keys = lambda tr: set(_rows(tr.config.train.logging_dir, "time/rollout_generate")[0])
    assert keys(tt) == keys(jt)
    for b, ib in zip(ppo_pair["tbatches"], ppo_pair["injected"]):
        for f in ("query_tensors", "response_tensors", "logprobs", "values", "rewards"):
            if f in ("query_tensors", "response_tensors"):
                np.testing.assert_array_equal(getattr(b, f), getattr(ib, f))
            else:
                _close(getattr(b, f), getattr(ib, f), 1e-5)


def test_first_ppo_step_loss_and_stats_match_jax(ppo_pair):
    """(e) the first step's loss and every stat of an injected batch, 1e-5."""
    t, j = ppo_pair["t_stats"][0], ppo_pair["j_stats"][0]
    for k, v in j.items():
        _close(t[k], v, 1e-5)
    assert "throughput/train_tokens_per_s" in t and abs(t["losses/total_loss"]) > 0


def test_ppo_params_after_three_steps_match_jax(ppo_pair):
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert "v_head.dense_out.weight" in trainable and "lm.block_1.attn.q_proj.weight" in trainable
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            # exact gradient 0: Adam turns rounding noise into steps of +-lr (3e-5)
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 3e-5
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)
        if name not in trainable:
            assert torch.equal(got[name], w), f"frozen {name} moved"


def test_reference_is_unchanged_by_training(ppo_pair):
    """(g) bitwise, and its storage is its own."""
    tt = ppo_pair["tt"]
    for name, w in tt.ref_model.state_dict().items():
        assert torch.equal(w, ppo_pair["ref_before"][name]), name
        assert not w.requires_grad
    ptrs = {p.data_ptr() for p in tt.model.parameters()}
    assert not any(p.data_ptr() in ptrs for p in tt.ref_model.parameters())
    assert not torch.equal(tt.model.lm.block_1.attn.q_proj.weight, tt.ref_model.block_1.attn.q_proj.weight)


def test_windowed_head_and_loss_match_the_full_forward(ppo_pair):
    """(c) forward_window against the full forward's slice, and the loss
    (windowed head) against `ppo_loss` over the full forward's slice,
    1e-6."""
    tt = ppo_pair["tt"]
    method = tt.config.method
    batch = tt.batch_to_device(ppo_pair["injected"][0])
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    mask = (tokens != 256).long()
    start, length = batch.query_tensors.shape[1] - 1, batch.rewards.shape[1]
    end = start + length
    with torch.no_grad():
        logits, values, _ = tt.model(tokens, mask, position_ids(mask))
        logits_w, values_w = tt.model.forward_window(tokens, mask, position_ids(mask), start, length)
        torch.testing.assert_close(logits_w, logits[:, start:end], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(values_w, values[:, start:end], rtol=1e-6, atol=1e-6)
        loss_w, stats_w = tt.make_loss_fn()(batch)
        advantages, returns = ppo.get_advantages_and_returns(batch.values, batch.rewards, method.gamma, method.lam)
        loss_f, stats_f = ppo.ppo_loss(
            logprobs=shifted_logprobs(logits, tokens)[:, start:end], values=values[:, :-1][:, start:end],
            old_logprobs=batch.logprobs, old_values=batch.values, advantages=advantages, returns=returns,
            mask=mask[:, start + 1:end + 1], cliprange=method.cliprange, cliprange_value=method.cliprange_value,
            vf_coef=method.vf_coef,
        )
        stats_f = flatten_dict(stats_f)
    _close(loss_w, loss_f, 1e-6)
    assert not method.whiten_with_mask and stats_w.keys() == stats_f.keys()
    for k in stats_w:
        _close(stats_w[k], stats_f[k], 1e-6)


def test_ppo_token_count_is_the_attention_mask(ppo_pair):
    tt = ppo_pair["tt"]
    b = ppo_pair["injected"][0]
    tokens = np.concatenate([b.query_tensors, b.response_tensors], axis=1)
    assert tt.count_tokens(b) == int((tokens != 256).sum()) < tokens.size
