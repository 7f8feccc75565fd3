"""Multi-turn rollouts (`method.multiturn_env`) over fleet `/chat` sessions
in the port against the JAX package, PPO and GRPO (same-seed groups of
G 4), on `CalculatorEnv`.

Each package runs its own supervised thread fleet of 2 paged replicas
with sessions on, random:gpt2-tiny at f32, greedy, the JAX trainer's
weights carried into the port by `params_from_jax`. Per episode: the
concatenated turns equal token for token, the loss masks (1 on policy
turns, 0 on the environment's) equal, and the rewards (the per-token KL
penalty on policy tokens, each turn's reward on its last token; GRPO's
group advantage), the logprobs (the replicas' behaviour logprobs spliced
onto policy tokens) and the values within 1e-5; the logged turn counts
and retained-KV hits equal. Then one PPO step on the same collated batch
with its loss masks: the loss and every stat within 1e-5 of JAX's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.environments import make_environment as j_make_environment
from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLBatch
from trlx_tpu_torch.data.default_configs import default_grpo_config, default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import flatten_dict

torch.set_num_threads(1)

MAX_NEW = 8
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]
TOL = 1e-5
G = 4
ENV = dict(multiturn_env="calculator", multiturn_max_turns=3, multiturn_env_kwargs=dict(max_turns=3))
FLEET = dict(
    rollout_backend="fleet", rollout_fleet_supervised=True, rollout_fleet_size=2,
    rollout_fleet_kwargs=dict(replica_retries=0, hedge=False),
    rollout_fleet_supervisor_kwargs=dict(tick_s=0.02, probe_interval_s=0.1, sync_interval_s=3600.0,
                                         start_timeout_s=10.0),
)


def _config(make, tmp, side, **method):
    return make().evolve(
        train=dict(seq_length=128, batch_size=4, epochs=1, total_steps=1000, eval_interval=1000,
                   checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                   logging_dir=str(tmp / side / "logs"), **FLEET),
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(dict(num_rollouts=8, chunk_size=8, ppo_epochs=1, init_kl_coef=0.05,
                         gen_kwargs=dict(max_new_tokens=MAX_NEW, do_sample=False, suppress_tokens=SUPPRESS)),
                    **ENV, **method),
        inference=dict(num_slots=8, max_prompt_len=128, max_new_tokens=MAX_NEW, max_wait_s=0.0,
                       kv_paging=True, kv_block_size=8, sessions=True),
    )


def _pair(tmp, j_cls, t_cls, j_make, t_make, **method):
    jt = j_cls(_config(j_make, tmp, "jax", **method), reward_fn=None, devices=jax.devices()[:1])
    tt = t_cls(_config(t_make, tmp, "torch", **method), reward_fn=None, device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    try:
        jt.make_experience(8)
        tt.make_experience(8)
    finally:
        jt.shutdown_rollout_fleet()
        tt.shutdown_rollout_fleet()
    return jt, tt


def _rows(logging_dir, key):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row for row in map(json.loads, f) if key in row]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ppo_pair(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("mt_ppo"), JPPOTrainer, PPOTrainer, j_default_ppo_config,
                 default_ppo_config)


@pytest.fixture(scope="module")
def grpo_pair(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("mt_grpo"), JGRPOTrainer, GRPOTrainer, j_default_grpo_config,
                 default_grpo_config, group_size=G)


def _assert_episodes_match(jt, tt):
    assert len(tt.store) == len(jt.store) == 8
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        np.testing.assert_array_equal(e.loss_mask, np.asarray(je.loss_mask))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f))
        assert e.group_id == je.group_id
    key = "rollout/retained_hit_turns"
    t_row, j_row = _rows(tt.config.train.logging_dir, key)[0], _rows(jt.config.train.logging_dir, key)[0]
    for k in ("rollout/retained_hit_turns", "rollout/mean_turns", "rollout/mean_env_reward", "fleet/session_turns"):
        assert t_row[k] == pytest.approx(j_row[k], abs=1e-6), k
    assert set(t_row) == set(j_row)
    return t_row


@pytest.mark.parametrize("side", ["ppo", "grpo"])
def test_multiturn_episodes_match_jax(side, ppo_pair, grpo_pair):
    jt, tt = ppo_pair if side == "ppo" else grpo_pair
    row = _assert_episodes_match(jt, tt)
    # the episodes took more than one turn, over retained blocks
    assert row["rollout/mean_turns"] > 1 and row["rollout/retained_hit_turns"] > 0
    # policy tokens and environment tokens both appear, masked apart
    masks = np.concatenate([e.loss_mask for e in tt.store.history])
    assert 0 < masks.sum() < masks.size


def test_multiturn_episodes_follow_the_environment(ppo_pair):
    """Replaying each stored episode's policy turns through the JAX
    package's own environment gives back its environment turns."""
    _, tt = ppo_pair
    tok = tt.tokenizer
    for i, e in enumerate(tt.store.history):
        env = j_make_environment("calculator", max_turns=3)
        obs = env.reset(i)
        assert list(e.query_tensor[e.query_tensor != 256]) == tok.encode(obs)
        ids, mask = list(e.response_tensor), list(e.loss_mask)
        j = 0
        while j < len(ids):
            k = j
            while k < len(ids) and mask[k] == 1.0:
                k += 1
            turn = env.step(tok.decode(ids[j:k]))
            env_end = k
            while env_end < len(ids) and mask[env_end] == 0.0:
                env_end += 1
            if env_end > k:
                assert tok.decode(ids[k:env_end]) == turn.text and not turn.done
            else:
                assert turn.done or env._turns == 3
            j = env_end


def test_grpo_multiturn_groups_share_a_seed(grpo_pair):
    _, tt = grpo_pair
    history = tt.store.history
    for g in range(0, 8, G):
        assert len({e.group_id for e in history[g:g + G]}) == 1
        assert len({tuple(e.query_tensor) for e in history[g:g + G]}) == 1
        advantages = [float(e.rewards[-1]) for e in history[g:g + G]]
        # greedy siblings play the same episode: their advantages agree
        assert max(advantages) - min(advantages) < 1e-5


def test_ppo_step_with_loss_masks_matches_jax(ppo_pair):
    """The collated batch (with its loss masks) equal, and one PPO step on
    the JAX batch, injected into both trainers: loss and stats 1e-5."""
    jt, tt = ppo_pair
    jb = next(iter(jt.create_train_dataloader()))
    tb = next(iter(tt.create_train_dataloader()))
    assert tb.loss_masks is not None and jb.loss_masks is not None
    np.testing.assert_array_equal(tb.loss_masks, np.asarray(jb.loss_masks))
    np.testing.assert_array_equal(tb.response_tensors, np.asarray(jb.response_tensors))
    fields = ("query_tensors", "response_tensors", "logprobs", "values", "rewards", "loss_masks")
    injected = PPORLBatch(**{f: np.asarray(getattr(jb, f)) for f in fields})
    j_stats = flatten_dict(jax.tree_util.tree_map(np.asarray, jt.train_minibatch([jb])))
    t_stats = tt.train_minibatch([injected])
    for k, v in j_stats.items():
        _close(t_stats[k], v)
    # the masks matter: without them the loss differs
    unmasked = PPORLBatch(**{f: np.asarray(getattr(jb, f)) for f in fields[:-1]})
    loss, _ = tt.make_loss_fn()(tt.batch_to_device(unmasked))
    assert abs(float(loss.detach()) - t_stats["losses/total_loss"]) > 1e-6
