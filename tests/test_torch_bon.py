"""The port's best-of-n trainer (trlx_tpu_torch/trainer/bon_trainer.py)
against the JAX package's `BestOfNTrainer` on the same weights (carried
by `params_from_jax`): gpt2-tiny at f32, greedy `gen_kwargs` held to
printable bytes (the decode round trip is exact), a deterministic
`reward_fn`.

Both trainers run `learn()` through three epochs (four rounds): each round's
candidates and winners, the `bon/*` stats and the store must be equal,
and the parameters after the CE steps within 2e-5 (the key bias, whose
exact gradient is 0, within its bound, as in test_torch_rft.py). Then the
port alone: the fleet backend on two in-process replicas of the trainer's
own `serve()` (one request a prompt with the `n` fan-out) gives the local
backend's candidates, a fleet that is down degrades to local, and
`method.reward_url` builds the remote reward client.
"""

import json
import os
import socket

import jax
import numpy as np
import pytest
import torch

import trlx_tpu_torch
from trlx_tpu.data.default_configs import default_bon_config as j_default_bon_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.bon_trainer import BestOfNTrainer as JBestOfNTrainer
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data.default_configs import default_bon_config
from trlx_tpu_torch.models.policy import CausalLMPolicy
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.serving import RewardModelServer
from trlx_tpu_torch.trainer.bon_trainer import BestOfNTrainer

torch.set_num_threads(1)

N = 3
ROUNDS = 3
MAX_NEW = 6
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]
GEN = dict(max_new_tokens=MAX_NEW, do_sample=False, suppress_tokens=SUPPRESS)


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _prompts(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 10))) for _ in range(n)]


def _config(make, tmp, side, **train):
    return make().evolve(
        train=dict(dict(seq_length=32, batch_size=4, epochs=ROUNDS, total_steps=1000, eval_interval=1000,
                        checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                        logging_dir=str(tmp / side / "logs"), tracker="jsonl"), **train),
        model=dict(model_path="random:gpt2-tiny", model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        method=dict(best_of_n=N, gen_kwargs=dict(GEN)),
        inference=dict(num_slots=8, max_prompt_len=24, max_new_tokens=MAX_NEW, max_wait_s=0.0,
                       kv_paging=True, kv_block_size=8),
    )


def _wire(t, pipeline_cls):
    t.add_prompt_pipeline(pipeline_cls(_prompts(), 24, t.tokenizer))
    t.add_eval_pipeline(pipeline_cls(_prompts()[:2], 24, t.tokenizer))
    return t


def _record(t, rounds):
    sample = t._sample_candidates

    def wrapped(input_ids, attention_mask, n):
        out = sample(input_ids, attention_mask, n)
        rounds.append(out)
        return out

    t._sample_candidates = wrapped


def _rows(logging_dir, key):
    rows = []
    for name in os.listdir(logging_dir):
        if name.endswith(".metrics.jsonl"):
            with open(os.path.join(logging_dir, name)) as f:
                rows += [r for r in map(json.loads, f) if key in r]
    return rows


@pytest.fixture(scope="module")
def bon_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bon")
    jt = _wire(JBestOfNTrainer(_config(j_default_bon_config, tmp, "jax"), reward_fn=reward_fn,
                               devices=jax.devices()[:1]), JPromptPipeline)
    tt = _wire(BestOfNTrainer(_config(default_bon_config, tmp, "torch"), reward_fn=reward_fn, device="cpu"),
               PromptPipeline)
    tt.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg))
    j_rounds, t_rounds = [], []
    _record(jt, j_rounds)
    _record(tt, t_rounds)
    jt.learn()
    tt.learn()
    return dict(jt=jt, tt=tt, j_rounds=j_rounds, t_rounds=t_rounds)


def test_candidates_winners_stats_and_store_match_jax(bon_pair):
    jt, tt = bon_pair["jt"], bon_pair["tt"]
    assert isinstance(tt.model, CausalLMPolicy) and not any("v_head" in k for k in tt.model.state_dict())
    # a round before the first epoch and one after each
    assert len(bon_pair["t_rounds"]) == len(bon_pair["j_rounds"]) == ROUNDS + 1
    for got, want in zip(bon_pair["t_rounds"], bon_pair["j_rounds"]):
        assert got == want and len(got) == 4 and all(len(c) == N for c in got)
    j_stats = _rows(jt.config.train.logging_dir, "bon/n_winners")
    t_stats = _rows(tt.config.train.logging_dir, "bon/n_winners")
    assert len(t_stats) == len(j_stats) == ROUNDS + 1
    for a, b in zip(t_stats, j_stats):
        assert a["bon/n_winners"] == b["bon/n_winners"] == 4 and a["_step"] == b["_step"]
        for k in ("bon/scores_mean", "bon/winner_scores_mean"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    t_ids = [np.asarray(b["input_ids"]) for b in tt.store.create_loader(4)]
    j_ids = [np.asarray(b["input_ids"]) for b in jt.store.create_loader(4)]
    for a, b in zip(t_ids, j_ids):
        np.testing.assert_array_equal(a, b)


def test_parameters_after_the_ce_steps_match_jax(bon_pair):
    jt, tt = bon_pair["jt"], bon_pair["tt"]
    assert tt.iter_count == jt.iter_count == ROUNDS
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.params), tt.model_cfg)
    got = tt.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith("k_proj.bias"):
            assert float((got[name] - w).abs().max()) <= 2 * ROUNDS * 1e-4
            continue
        torch.testing.assert_close(got[name], w, rtol=2e-5, atol=2e-5)


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def test_fleet_candidates_equal_local_and_a_downed_fleet_degrades(tmp_path):
    from trlx_tpu_torch.utils.logging import MultiProcessAdapter

    tt = _wire(BestOfNTrainer(_config(default_bon_config, tmp_path, "fleet"), reward_fn=reward_fn, device="cpu"),
               PromptPipeline)
    batch = next(iter(tt.prompt_dataloader))
    ids, mask = np.asarray(batch["input_ids"]), np.asarray(batch["attention_mask"])
    local = tt._sample_candidates(ids, mask, N)
    servers = [tt.serve(host="127.0.0.1", port=0, background=True) for _ in range(2)]
    tt.config.train.rollout_backend = "fleet"
    tt.config.train.rollout_fleet_urls = [s.url for s in servers]
    tt.config.train.rollout_fleet_kwargs = dict(replica_retries=0, hedge=False)
    calls = []
    router = tt._get_bon_router()
    generate = router.generate
    router.generate = lambda prompts, **kw: (calls.append((len(prompts), kw)), generate(prompts, **kw))[1]
    try:
        fleet = tt._sample_candidates(ids, mask, N)
        assert fleet == local
        # one call: a request a prompt, each fanned out to n sequences
        assert calls == [(len(ids), dict(max_new_tokens=MAX_NEW, n=N))]
    finally:
        tt.shutdown_rollout_fleet()
        for s in servers:
            s.shutdown()
    tt.config.train.rollout_fleet_urls = [_dead_url(), _dead_url()]
    tt.config.train.rollout_fleet_kwargs = dict(timeout=2.0, probe_timeout_s=0.3, replica_retries=0,
                                                retry_base_delay=0.01, breaker_threshold=1, hedge=False)
    assert tt._sample_candidates(ids, mask, N) == local
    assert any("best-of-n fleet unavailable" in str(msg) for (_, msg) in MultiProcessAdapter._once_seen)
    tt.shutdown_rollout_fleet()


def test_reward_url_builds_the_remote_client_and_train_admits_bon(tmp_path):
    srv = RewardModelServer(reward_fn, host="127.0.0.1", port=0)
    url = srv.start_background()
    try:
        cfg = _config(default_bon_config, tmp_path, "url", epochs=1).evolve(method=dict(reward_url=url))
        tt = BestOfNTrainer(cfg, device="cpu")
        assert tt.reward_fn is not None
        assert tt.reward_fn(samples=["ab c"], prompts=["a"], outputs=["b c"]) == reward_fn(["ab c"], ["a"], ["b c"])
        trainer = trlx_tpu_torch.train(reward_fn=tt.reward_fn, prompts=_prompts(), config=cfg, device="cpu")
        assert isinstance(trainer, BestOfNTrainer) and trainer.iter_count == 1
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="best_of_n"):
        BestOfNTrainer(_config(default_bon_config, tmp_path, "bad").evolve(method=dict(best_of_n=0)), device="cpu")
