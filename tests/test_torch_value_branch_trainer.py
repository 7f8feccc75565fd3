"""The value branch through the PPO trainer against the JAX trainer, the
cases of `test_torch_value_branch.py` moved to a file of their own (the
suite's `--dist loadfile` hands out the files with the fewest tests
last, so these heavy ones fill a worker the parallelism files leave
idle): greedy rollouts, scores and values, the first step, the
parameters after three steps, the cached loss, an exact resume, and the
pipelined cycle under a branch."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models.policy import CausalLMWithValueHead as JPolicy
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.models.transformer import init_kv_cache, position_ids
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict
from test_torch_value_branch import (  # the cases' helpers, shared with test_torch_value_branch.py
    STEPS,
    SUPPRESS,
    _close,
    _pair,
    _prompts,
    _train_run,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ppo_pair(tmp_path_factory):
    """Both trainers: one greedy collection of 8 rollouts, then STEPS
    optimizer steps on the JAX loader's batches, injected into both."""
    jt, tt = _pair(tmp_path_factory.mktemp("branch"))
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards")
    injected = [PPORLBatch(**{f: np.asarray(getattr(b, f)) for f in fields}) for b in jbatches]
    j_stats, t_stats = [], []
    for jb, ib in zip(jbatches, injected):
        j_stats.append(flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([ib]))
    return dict(jt=jt, tt=tt, injected=injected, j_stats=j_stats, t_stats=t_stats)


def test_greedy_rollouts_scores_and_values_match_jax(ppo_pair):
    """Tokens exactly equal; the branch's values, the logprobs and the
    rewards 1e-5."""
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    assert tt.model.num_value_layers == 1 and len(tt.store) == len(jt.store) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f), 1e-5)
    assert max(float(np.abs(e.values).max()) for e in tt.store.history) > 0


def test_first_step_loss_and_stats_match_jax(ppo_pair):
    assert not ppo_pair["tt"]._window_loss_ok()
    t, j = ppo_pair["t_stats"][0], ppo_pair["j_stats"][0]
    for k, v in j.items():
        _close(t[k], v, 1e-5)
    assert abs(t["losses/value_loss"]) > 0


def test_params_after_three_steps_match_jax_branch_included(ppo_pair):
    jt, tt = ppo_pair["jt"], ppo_pair["tt"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    trainable = {n for n, p in tt.model.named_parameters() if p.requires_grad}
    assert "value_branch.block_0.attn.q_proj.weight" in trainable and "value_branch.v_head.dense_out.weight" in trainable
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            # exact gradient 0: Adam turns rounding noise into steps of +-lr (3e-5)
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 3e-5
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)
        if name not in trainable:
            assert torch.equal(got[name], w), f"frozen {name} moved"
    # the branch trained apart from the trunk block it was cloned from
    assert not torch.equal(got["value_branch.block_0.mlp.up_proj.weight"], got["lm.block_1.mlp.up_proj.weight"])


def test_cached_loss_matches_the_full_forward(ppo_pair):
    """The trunk-cache step (forward_from_cache, the branch fed from the
    cache) against the full forward's loss, 1e-6, with f32 caches."""
    tt = ppo_pair["tt"]
    batch = tt.batch_to_device(ppo_pair["injected"][0])
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    mask = (tokens != tt.tokenizer.pad_token_id).long()
    loss_fn = tt.make_loss_fn()
    with torch.no_grad():
        cache = tt.model.forward_trunk(tokens, mask, position_ids(mask), tt.split)
        full, stats_f = loss_fn(batch)
        cached, stats_c = loss_fn(PPORLBatch(**{**batch.__dict__, "h_split": cache}))
    _close(cached, full, 1e-6)
    for k in stats_f:
        _close(stats_c[k], stats_f[k], 1e-6)


def test_train_with_a_branch_and_the_trunk_cache_resumes_exactly(tmp_path):
    """`trlx_tpu_torch.train(reward_fn=...)` with a branch and the trunk
    cache (its tap at the split, so the gate holds): two collections of
    2 inner epochs; a run resumed from step 3 ends bitwise equal to the
    uninterrupted one, the branch included."""
    full = _train_run(tmp_path, "full")
    assert full.iter_count == 8 and full._trunk_cache_available()
    assert all(e.h_split is not None for e in full.store.history)
    resumed = _train_run(tmp_path, "resumed",
                         resume_from_checkpoint=os.path.join(tmp_path, "full", "ckpts", "checkpoint_3"))
    assert resumed.iter_count == 8
    for a, b in ((full.model, resumed.model), (full.ref_model, resumed.ref_model)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), name
    assert full.kl_ctl.value == resumed.kl_ctl.value and full.mean_kl == resumed.mean_kl


def test_pipelined_cycle_under_a_branch_takes_the_speculative_scorer(tmp_path):
    """With `capture_rollout_stats` on, a branch turns the fast path off
    (no per-step values) and the cycle scores speculatively, with no
    fallback; two greedy cycles match the JAX trainer's: samples exactly,
    losses 1e-5."""
    kw = dict(gen_kwargs=dict(max_new_tokens=6, do_sample=False, suppress_tokens=SUPPRESS),
              capture_rollout_stats=True)
    jt, tt = _pair(tmp_path, **kw)
    tt.config = tt.config.evolve(train=dict(batch_size=8))
    jt.config = jt.config.evolve(train=dict(batch_size=8))
    prompts = ["hello world", "jax tpu", "ppo", "cycle", "fast path", "torch", "hopper", "scorer"]
    tt.add_prompt_pipeline(PromptPipeline(prompts, 8, tt.tokenizer))
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 8, jt.tokenizer))
    tt.stop_sequences = jt.stop_sequences = []
    assert not tt._fast_rollout_available() and tt._spec_path_available()
    calls = []
    for name in ("_dispatch_spec_score", "_dispatch_fast_score", "_score_reward"):
        fn = getattr(tt, name)
        setattr(tt, name, lambda *a, _fn=fn, _name=name, **k: (calls.append(_name), _fn(*a, **k))[1])
    pending, jpending, losses = None, None, []
    for _ in range(2):
        loss, pending = tt.pipelined_cycle(pending)
        jloss, jpending = jt.pipelined_cycle(jpending)
        losses.append((loss, jloss))
        for (_, o), (_, jo) in zip(pending[0], jpending[0]):
            np.testing.assert_array_equal(o["samples"].numpy(), np.asarray(jo["samples"]))
    assert calls == ["_dispatch_spec_score"] * 3 and tt.spec_fallbacks == 0
    assert losses[1][0] == pytest.approx(losses[1][1], rel=1e-5, abs=1e-6)
    assert float(pending[2][0]) == pytest.approx(float(np.asarray(jpending[2][0])), rel=1e-5, abs=1e-6)
