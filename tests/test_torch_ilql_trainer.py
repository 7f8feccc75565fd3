"""ILQL trainer pairs against the JAX package, the cases of
`test_torch_ilql.py` moved to a file of their own (the suite's
`--dist loadfile` hands out the files with the fewest tests last, so
these heavy ones fill a worker the parallelism files leave idle): the
loaders and the first step, the parameters after three steps (target
heads included), and the target heads' place outside the optimizer."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.configs import ModelConfig as JModelConfig
from trlx_tpu.data.default_configs import default_ilql_config as j_default_ilql_config
from trlx_tpu.models import build_model as j_build_model
from trlx_tpu.models.heads import ILQLHeads as JILQLHeads
from trlx_tpu.models.heads import sync_target_q_heads as j_sync_target_q_heads
from trlx_tpu.ops import ilql as j_ilql
from trlx_tpu.ops import sampling as j_sampling
from trlx_tpu.pipeline.offline_pipeline import ILQLRolloutStorage as JILQLRolloutStorage
from trlx_tpu.tokenizers import ByteTokenizer as JByteTokenizer
from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQLTrainer
from trlx_tpu.trainer.base_trainer import partition_params
from trlx_tpu.trainer.ilql_trainer import make_experience as j_make_experience
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import ILQLBatch
from trlx_tpu_torch.data.configs import ModelConfig
from trlx_tpu_torch.data.default_configs import default_ilql_config
from trlx_tpu_torch.models import ILQLHeads, build_model, sync_target_q_heads, target_q_mask
from trlx_tpu_torch.ops import ilql, sampling
from trlx_tpu_torch.pipeline.offline_pipeline import ILQLRolloutStorage
from trlx_tpu_torch.tokenizers import ByteTokenizer
from trlx_tpu_torch.trainer.ilql_trainer import ILQLTrainer, make_experience
from trlx_tpu_torch.utils import flatten_dict
from test_torch_ilql import (  # the cases' helpers, shared with test_torch_ilql.py
    FIELDS,
    STEPS,
    SYNC,
    _close,
    _config,
    _dialogues,
    _heads,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trainer_pair(tmp_path_factory):
    """Both trainers on the same weights and experience; STEPS optimizer
    steps on the JAX loader's batches, injected into both, the sync by the
    trainers' own rule (iter_count bumped after each step, as learn does)."""
    tmp = tmp_path_factory.mktemp("ilql")
    jt = JILQLTrainer(_config(j_default_ilql_config, tmp, "jax"), devices=jax.devices()[:1])
    tt = ILQLTrainer(_config(default_ilql_config, tmp, "torch"), device="cpu")
    rng = np.random.RandomState(6)
    jparams = jax.tree_util.tree_map(np.asarray, jt.params)
    # the target heads apart from the Q heads, so a sync moves them
    jparams["ilql_heads"] = {k: (jax.tree_util.tree_map(lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), v)
                                 if k.startswith("target") else v) for k, v in jparams["ilql_heads"].items()}
    jtree = jax.tree_util.tree_map(jnp.asarray, jparams)
    jt.train_params, jt.frozen_params = partition_params(jtree, jt.make_trainable_mask(jtree))
    tt.model.load_state_dict(params_from_jax(jparams, tt.model_cfg))
    samples, rewards = _dialogues(10, seed=2)
    jt.make_experience(samples, rewards, 24)
    tt.make_experience(samples, rewards, 24)
    jbatches = [b for _ in range(2) for b in jt.create_train_dataloader()][:STEPS]
    tbatches = [b for _ in range(2) for b in tt.create_train_dataloader()][:STEPS]
    injected = [ILQLBatch(*(np.asarray(getattr(b, f)) for f in FIELDS)) for b in jbatches]
    j_stats, t_stats, heads = [], [], [_heads(tt.model)]
    for jb, ib in zip(jbatches, injected):
        j_stats.append(flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb]))))
        t_stats.append(tt.train_minibatch([ib]))
        jt.iter_count += 1
        tt.iter_count += 1
        heads.append(_heads(tt.model))
    return dict(jt=jt, tt=tt, tbatches=tbatches, injected=injected, j_stats=j_stats, t_stats=t_stats, heads=heads)


def test_trainer_loaders_and_first_step_match_jax(trainer_pair):
    tt = trainer_pair["tt"]
    for b, ib in zip(trainer_pair["tbatches"], trainer_pair["injected"]):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(ib, f))
    t, j = trainer_pair["t_stats"][0], trainer_pair["j_stats"][0]
    for k, v in j.items():
        _close(t[k], v, 1e-5)
    assert abs(t["losses/loss_q"]) > 0 and t["throughput/train_tokens_per_s"] > 0
    assert tt.count_tokens(trainer_pair["injected"][0]) == int(trainer_pair["injected"][0].attention_mask.sum())


def test_params_after_three_steps_match_jax_target_heads_included(trainer_pair):
    jt, tt = trainer_pair["jt"], trainer_pair["tt"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    assert want.keys() == got.keys()
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * 5e-5
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)


def test_target_heads_stay_out_of_the_optimizer_and_move_only_at_syncs(trainer_pair):
    """Out of the optimizer and untouched by backward; bitwise unchanged
    by the steps between syncs; after the sync of step SYNC, alpha * q +
    (1 - alpha) * target of the heads before it."""
    tt, heads = trainer_pair["tt"], trainer_pair["heads"]
    targets = target_q_mask(tt.model)
    in_optimizer = {id(p) for g in tt.optimizer.param_groups for p in g["params"]}
    for name, p in tt.model.named_parameters():
        assert (id(p) in in_optimizer) == (not targets[name]) and (p.requires_grad == (not targets[name]))
    assert sum(targets.values()) == 8  # 2 target heads x (2 Dense x weight, bias)
    for step in range(1, STEPS + 1):
        synced = step % SYNC == 0
        for name, w in heads[step].items():
            assert torch.equal(w, heads[step - 1][name]) != synced, (step, name)
    assert all(torch.equal(w, heads[1][n]) for n, w in heads[SYNC - 1].items())
