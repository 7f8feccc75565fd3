"""The bench's options through the PPO trainer against the JAX trainer,
the cases of `test_torch_ppo_options.py` moved to a file of their own
(the suite's `--dist loadfile` hands out the files with the fewest
tests last, so these heavy ones fill a worker the parallelism files
leave idle): a collection under the options, the cached step, the cached
loss and gradients against the full path, and an exact resume through
`train`."""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data import PPORLElement as JPPORLElement
from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models.policy import CausalLMWithValueHead as JPolicy
from trlx_tpu.ops import quant as j_quant
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.pipeline.ppo_pipeline import PPORolloutStorage as JPPORolloutStorage
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch, PPORLElement
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models import build_model
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.models.transformer import position_ids
from trlx_tpu_torch.ops import quant, sampling
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.pipeline.ppo_pipeline import PPORolloutStorage
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict
from test_torch_ppo_options import (  # the cases' helpers, shared with test_torch_ppo_options.py
    OPTIONS,
    STEPS,
    STOP,
    _close,
    _loss_and_grads,
    _np,
    _ppo_config,
    _rows,
    _text_prompts,
    _to_port_batch,
    reward_fn,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def options_pair(tmp_path_factory):
    """Both trainers with the three options (f32 trunk cache) on the same
    weights: one greedy collection of 8 rollouts, then STEPS optimizer
    steps on the JAX loader's batches, cache rows included."""
    tmp = tmp_path_factory.mktemp("ppo_options")
    method = dict(OPTIONS, trunk_cache_dtype="float32")
    jt = JPPOTrainer(_ppo_config(j_default_ppo_config, tmp, "jax", **method), reward_fn=reward_fn,
                     stop_sequences=STOP, devices=jax.devices()[:1])
    tt = PPOTrainer(_ppo_config(default_ppo_config, tmp, "torch", **method), reward_fn=reward_fn,
                    stop_sequences=STOP, device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    prompts = _text_prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 40, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 40, tt.tokenizer))
    jt.make_experience(8)
    tt.make_experience(8)
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    tbatches = [b for _ in range(2) for b in tt.create_train_dataloader()][:STEPS]
    loss_batch = tt.batch_to_device(tbatches[0])
    j_stats, t_stats = [], []
    for jb in jbatches:
        j_stats.append(flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([_to_port_batch(jb)]))
    return SimpleNamespace(jt=jt, tt=tt, jbatches=jbatches, tbatches=tbatches, loss_batch=loss_batch,
                           j_stats=j_stats, t_stats=t_stats)


def test_options_make_experience_matches_jax(options_pair):
    """Greedy rollouts through the speculative sampler on the int8 view:
    the store equal to JAX's (tokens exactly, stats and trunk cache rows
    1e-5), the same rounds and accepted drafts, no fallback; the loaders'
    batches (their cache rows re-padded under left padding) equal."""
    jt, tt = options_pair.jt, options_pair.tt
    assert len(tt.store) == len(jt.store) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards", "h_split"):
            _close(_np(getattr(e, f)), getattr(je, f), 1e-5)
        assert e.h_split.shape == (len(e.query_tensor) + len(e.response_tensor), 64)
    assert (tt.spec_decode_rounds, tt.spec_decode_accepted) == (jt.spec_decode_rounds, jt.spec_decode_accepted)
    assert tt.spec_decode_rounds > 0 and tt.spec_decode_fallbacks == getattr(jt, "spec_decode_fallbacks", 0) == 0
    keys = lambda tr: set(_rows(tr.config.train.logging_dir, "time/rollout_generate")[0])
    assert keys(tt) == keys(jt) and "rollout/spec_accept_rate" in keys(tt)
    assert any(int(e.query_tensor[0]) == 256 for e in tt.store.history)  # left-padded queries
    for b, jb in zip(options_pair.tbatches, options_pair.jbatches):
        np.testing.assert_array_equal(b.query_tensors, np.asarray(jb.query_tensors))
        np.testing.assert_array_equal(b.response_tensors, np.asarray(jb.response_tensors))
        _close(_np(b.h_split), jb.h_split, 1e-5)


def test_options_cached_step_matches_jax(options_pair):
    """The first step's loss and stats through the trunk cache (the JAX
    batch's cache rows in both), 1e-5; parameters after 3 steps 2e-5 (the
    key bias, whose exact gradient is 0, within its bound)."""
    for k, v in options_pair.j_stats[0].items():
        _close(options_pair.t_stats[0][k], v, 1e-5)
    jt, tt = options_pair.jt, options_pair.tt
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 3e-5
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)


def test_cached_loss_and_grads_equal_the_full_path(options_pair):
    """(`test_trunk_cache.py:109,125`) In the port: an f32 cache computed by
    the trunk over the batch gives the full path's loss and every gradient
    bitwise; a bf16 cache within 2e-3 relative."""
    tt, batch = options_pair.tt, options_pair.loss_batch
    tokens = torch.cat([batch.query_tensors, batch.response_tensors], dim=1)
    mask = (tokens != tt.tokenizer.pad_token_id).long()
    with torch.no_grad():
        h = tt.model.forward_trunk(tokens, mask, position_ids(mask), tt.split)
    loss_f, grads_f = _loss_and_grads(tt, PPORLBatch(**{**batch.__dict__, "h_split": None}))
    loss_c, grads_c = _loss_and_grads(tt, PPORLBatch(**{**batch.__dict__, "h_split": h}))
    assert torch.equal(loss_c, loss_f) and grads_c.keys() == grads_f.keys()
    for name in grads_f:
        assert torch.equal(grads_c[name], grads_f[name]), name
    loss_b, grads_b = _loss_and_grads(tt, PPORLBatch(**{**batch.__dict__, "h_split": h.to(torch.bfloat16)}))
    assert abs(float(loss_b) - float(loss_f)) <= 2e-3 * abs(float(loss_f))
    # the LM's gradients within 5e-2 of their largest element; the value
    # head's are left out: the cache's rounding flips a few of its ReLU
    # gates, and a flipped unit's row differs by its whole share
    for name, g in grads_f.items():
        if name.startswith("lm."):
            torch.testing.assert_close(grads_b[name], g, rtol=0, atol=5e-2 * max(float(g.abs().max()), 1e-3))


def test_options_train_entry_point_resumes_exactly(tmp_path):
    """`trlx_tpu_torch.train(reward_fn=...)` with the three options and
    sampling on (bf16 trunk cache): two collections, 8 steps; a run
    resumed from step 3 (the store and its cache rows from the checkpoint)
    ends with the uninterrupted run's parameters and store bit for bit."""
    import trlx_tpu_torch

    def run(side, **train):
        cfg = _ppo_config(default_ppo_config, tmp_path, side, **OPTIONS).evolve(
            train=dict(checkpoint_interval=1, **train), method=dict(gen_kwargs=dict(max_new_tokens=8, do_sample=True)))
        return trlx_tpu_torch.train(reward_fn=reward_fn, prompts=_text_prompts(12, 1), config=cfg,
                                    stop_sequences=STOP, device="cpu")

    full = run("full")
    assert full.iter_count == 8 and full.spec_decode_rounds > 0 and full.spec_decode_fallbacks == 0
    assert full.store.history[0].h_split.dtype == torch.bfloat16
    assert len(_rows(full.config.train.logging_dir, "rollout/spec_accept_rate")) == 2
    resumed = run("resumed", resume_from_checkpoint=str(tmp_path / "full" / "ckpts" / "checkpoint_3"))
    assert resumed.iter_count == 8
    for (name, x), y in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(x, y), name
    for e, f in zip(full.store.history, resumed.store.history):
        np.testing.assert_array_equal(e.response_tensor, f.response_tensor)
        np.testing.assert_array_equal(e.rewards, f.rewards)
        assert torch.equal(e.h_split, f.h_split)
