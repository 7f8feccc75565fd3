"""The rollout fleet slice as a whole: PPO and GRPO through
`train.rollout_backend="fleet"` in the port against the JAX package.

Each package runs its own supervised thread fleet (2 replicas of its own
`serve()`), on random:gpt2-tiny at f32 with greedy sampling, the JAX
trainer's weights carried into the port by `params_from_jax`, and the same
prompts:

- PPO: the stored rollouts' response tokens equal, their logprobs (the
  replicas' behaviour logprobs), values and rewards within 1e-5, and
  `fleet/behavior_logprob_rows` equal;
- GRPO with the `n` fan-out (G 4): the same comparison, and only the
  unique prompts travel;
- the store's collation of multi-turn loss masks bitwise equal to JAX's.

Then the port alone: a replica killed mid-collection (from inside the
reward function) still gives the exact rollout count, equal to the local
sampler's greedy rollouts; and a fleet that is entirely down degrades to
local generation, counted in `fleet/degraded_chunks`.

The multi-turn loss-mask collation is `test_torch_fleet_collation.py`.
"""

import json
import os
import socket

import jax
import numpy as np
import pytest
import torch

from trlx_tpu.data.default_configs import default_grpo_config as j_default_grpo_config
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.grpo_trainer import GRPOTrainer as JGRPOTrainer
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch import resilience
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.default_configs import default_grpo_config, default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.grpo_trainer import GRPOTrainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

torch.set_num_threads(1)

MAX_NEW = 6
# printable bytes and eos: the decode -> encode round trip is exact, so
# every row takes the replicas' behaviour logprobs
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]
GEN = dict(max_new_tokens=MAX_NEW, do_sample=False, suppress_tokens=SUPPRESS)
G = 4
FLEET = dict(
    rollout_backend="fleet", rollout_fleet_supervised=True, rollout_fleet_size=2,
    rollout_fleet_kwargs=dict(replica_retries=0, hedge=False, concurrency=8),
    rollout_fleet_supervisor_kwargs=dict(tick_s=0.02, probe_interval_s=0.1, respawn_backoff_s=0.1,
                                         sync_interval_s=3600.0, start_timeout_s=10.0),
)
TOL = 1e-5


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(n)]


def _config(make, tmp, side, **train):
    return make().evolve(
        train=dict(dict(seq_length=32, batch_size=4, epochs=1, total_steps=1000, eval_interval=1000,
                        checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                        logging_dir=str(tmp / side / "logs")), **train),
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=1, gen_kwargs=dict(GEN)),
        inference=dict(num_slots=8, max_prompt_len=32, max_new_tokens=MAX_NEW, max_wait_s=0.0,
                       kv_paging=True, kv_block_size=8, prefix_cache=True),
    )


def _pair(tmp, j_cls, t_cls, j_make, t_make, **method):
    jt = j_cls(_config(j_make, tmp, "jax", **FLEET).evolve(method=method), reward_fn=reward_fn,
               devices=jax.devices()[:1])
    tt = t_cls(_config(t_make, tmp, "torch", **FLEET).evolve(method=method), reward_fn=reward_fn, device="cpu")
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    tt.ref_model = HydraReference(tt.model.lm, tt.split)
    prompts = _prompts(12, 0)
    jt.add_prompt_pipeline(JPromptPipeline(prompts, 24, jt.tokenizer))
    tt.add_prompt_pipeline(PromptPipeline(prompts, 24, tt.tokenizer))
    return jt, tt


def _rows(logging_dir, key):
    (path,) = [os.path.join(logging_dir, f) for f in os.listdir(logging_dir) if f.endswith(".metrics.jsonl")]
    with open(path) as f:
        return [row for row in map(json.loads, f) if key in row]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _assert_stores_match(tt, jt):
    assert len(tt.store) == len(jt.store) > 0
    for e, je in zip(tt.store.history, jt.store.history):
        np.testing.assert_array_equal(e.query_tensor, np.asarray(je.query_tensor))
        np.testing.assert_array_equal(e.response_tensor, np.asarray(je.response_tensor))
        for f in ("logprobs", "values", "rewards"):
            _close(getattr(e, f), getattr(je, f))
        assert (e.group_id is None) == (je.group_id is None) and e.group_id == je.group_id


@pytest.fixture(scope="module")
def ppo_pair(tmp_path_factory):
    jt, tt = _pair(tmp_path_factory.mktemp("fleet_ppo"), JPPOTrainer, PPOTrainer, j_default_ppo_config,
                   default_ppo_config)
    try:
        jt.make_experience(8)
        tt.make_experience(8)
        yield jt, tt
    finally:
        jt.shutdown_rollout_fleet()
        tt.shutdown_rollout_fleet()


def test_fleet_ppo_rollouts_match_jax(ppo_pair):
    jt, tt = ppo_pair
    _assert_stores_match(tt, jt)
    key = "fleet/behavior_logprob_rows"
    t_rows, j_rows = _rows(tt.config.train.logging_dir, key), _rows(jt.config.train.logging_dir, key)
    assert [r[key] for r in t_rows] == [r[key] for r in j_rows] == [8.0]
    assert [r["fleet/degraded_chunks"] for r in t_rows] == [r["fleet/degraded_chunks"] for r in j_rows] == [0.0]
    assert t_rows[0]["fleet/requests"] == j_rows[0]["fleet/requests"] == 8
    assert t_rows[0]["fleet/capacity"] == 2.0
    assert set(t_rows[0]) == set(j_rows[0])


def test_fleet_replicas_decode_on_their_own_weights(ppo_pair):
    """Each seat's engine holds its own copy of the weights, equal to the
    trainer's at the snapshot; a trainer step then moves the trainer's and
    not the seats', until the next collection pushes a new snapshot."""
    _, tt = ppo_pair
    seats = tt._rollout_supervisor.seats
    own = {p.data_ptr() for p in tt.model.parameters()}
    engines = [s.handle.server.engine for s in seats]
    for e in engines:
        assert not any(p.data_ptr() in own for p in e.model.parameters())
        for (k, a), b in zip(e.model.state_dict().items(), tt.model.state_dict().values()):
            assert torch.equal(a, b), k
    loader = tt.create_train_dataloader()
    tt.train_minibatch([next(iter(loader))])
    tt.iter_count += 1
    name = "lm.block_1.attn.q_proj.weight"
    assert not torch.equal(engines[0].model.state_dict()[name], tt.model.state_dict()[name])
    tt._push_params_to_thread_replicas()
    for e in engines:
        assert torch.equal(e.model.state_dict()[name], tt.model.state_dict()[name])
    assert tt._fleet_params_step == tt.iter_count


@pytest.fixture(scope="module")
def grpo_pair(tmp_path_factory):
    jt, tt = _pair(tmp_path_factory.mktemp("fleet_grpo"), JGRPOTrainer, GRPOTrainer, j_default_grpo_config,
                   default_grpo_config, group_size=G)
    try:
        jt.make_experience(8)
        tt.make_experience(8)
        yield jt, tt
    finally:
        jt.shutdown_rollout_fleet()
        tt.shutdown_rollout_fleet()


def test_fleet_grpo_fan_out_matches_jax(grpo_pair):
    jt, tt = grpo_pair
    _assert_stores_match(tt, jt)
    key = "fleet/behavior_logprob_rows"
    t_rows, j_rows = _rows(tt.config.train.logging_dir, key), _rows(jt.config.train.logging_dir, key)
    assert [r[key] for r in t_rows] == [r[key] for r in j_rows] == [8.0]
    # only the 2 unique prompts of the chunk travelled, each with n = G
    assert t_rows[0]["fleet/requests"] == j_rows[0]["fleet/requests"] == 8 // G
    for g in range(0, 8, G):
        group = tt.store.history[g:g + G]
        assert len({e.group_id for e in group}) == 1 and len({tuple(e.query_tensor) for e in group}) == 1


def test_fleet_grpo_shares_the_prompts_blocks(grpo_pair):
    """The `n` fan-out reaches `Scheduler.submit_n`: the group's sequences
    share the prompt's cached KV blocks on their replica, as many as on
    the JAX replicas (a prompt's group lands on one replica)."""
    jt, tt = grpo_pair
    hits = [sum(s.handle.server.engine.kv_stats().get("prefix_cache_hits", 0) for s in t._rollout_supervisor.seats)
            for t in (tt, jt)]
    assert hits[0] == hits[1] > 0


# ---------------------------------------------------------------------------
# The port alone: chaos and a fleet that is down
# ---------------------------------------------------------------------------


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def _local_trainer(tmp, **train):
    tt = PPOTrainer(_config(default_ppo_config, tmp, "local", **train), reward_fn=reward_fn, device="cpu")
    tt.add_prompt_pipeline(PromptPipeline(_prompts(12, 0), 24, tt.tokenizer))
    return tt


def test_chaos_kill_mid_collection_keeps_the_count(tmp_path):
    """3 replicas given by URL; one is killed from inside the reward
    function of the first chunk: 12 rollouts in 3 chunks all land, equal
    to the local sampler's greedy ones (logprobs: the replicas' within
    1e-5 of the scorer's)."""
    server_trainer = _local_trainer(tmp_path / "srv")
    servers = [server_trainer.serve(host="127.0.0.1", port=0, background=True) for _ in range(3)]
    killed = []

    def killing_reward(samples, prompts, outputs, **kw):
        if not killed:
            killed.append(True)
            resilience.FaultInjector.kill_replica(servers[2])
        return reward_fn(samples, prompts, outputs)

    fleet = _local_trainer(tmp_path / "fleet", rollout_backend="fleet", rollout_fleet_urls=[s.url for s in servers],
                           rollout_fleet_kwargs=dict(replica_retries=0, retry_base_delay=0.05, breaker_threshold=2,
                                                     breaker_recovery=0.5, hedge=False, probe_timeout_s=2.0))
    fleet.config.method.chunk_size = 4
    fleet.add_prompt_pipeline(PromptPipeline(_prompts(12, 0), 24, fleet.tokenizer))
    fleet.reward_fn = killing_reward
    local = _local_trainer(tmp_path / "local")
    local.config.method.chunk_size = 4
    local.add_prompt_pipeline(PromptPipeline(_prompts(12, 0), 24, local.tokenizer))
    try:
        fleet.make_experience(12)
        local.make_experience(12)
        assert killed and len(fleet.store) == 12
        assert fleet._rollout_router.stats()["requests"] >= 12
        for e, le in zip(fleet.store.history, local.store.history):
            np.testing.assert_array_equal(e.response_tensor, le.response_tensor)
            _close(e.logprobs, le.logprobs)
            _close(e.values, le.values)
        rows = _rows(fleet.config.train.logging_dir, "fleet/degraded_chunks")
        assert rows[0]["fleet/degraded_chunks"] == 0.0 and rows[0]["fleet/behavior_logprob_rows"] == 4.0
    finally:
        fleet.shutdown_rollout_fleet()
        for s in servers:
            s.shutdown()


def test_whole_fleet_down_degrades_to_local(tmp_path):
    from trlx_tpu_torch.utils.logging import MultiProcessAdapter

    tt = _local_trainer(tmp_path, rollout_backend="fleet", rollout_fleet_urls=[_dead_url(), _dead_url()],
                        rollout_fleet_kwargs=dict(timeout=2.0, probe_timeout_s=0.3, replica_retries=0,
                                                  retry_base_delay=0.01, breaker_threshold=1, hedge=False))
    tt.make_experience(8)
    assert len(tt.store) == 8 and tt._rollout_router is not None
    rows = _rows(tt.config.train.logging_dir, "fleet/degraded_chunks")
    assert rows[0]["fleet/degraded_chunks"] == 1.0 and rows[0]["fleet/behavior_logprob_rows"] == 0.0
    assert any("degrading to local generation" in str(msg) for (_, msg) in MultiProcessAdapter._once_seen)
    tt.shutdown_rollout_fleet()
    assert tt._rollout_router is None


def test_pipelined_cycle_keeps_generating_locally(tmp_path):
    tt = _local_trainer(tmp_path, rollout_backend="fleet", rollout_fleet_urls=[_dead_url()])
    loss, pending = tt.pipelined_cycle()
    assert loss is None and pending is not None and tt._rollout_router is None
