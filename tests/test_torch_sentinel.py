"""The port's health sentinel (trlx_tpu_torch/sentinel.py), its gradient
guard and ladder in the trainer, the step watchdog and the train-side
fault injector, against the JAX package's on the same inputs.

The ladder, the rolling statistics, the quarantine, `repetition_frac`,
the fault schedule and the state dict must equal JAX's exactly (the same
Python and numpy code). The guard must leave a skipped step's
parameters, Adam moments and step counts and the LR scheduler bitwise as
they were, and a clean sentinel-on run must equal a sentinel-off run bit
for bit. A greedy PPO chaos run (NaN, spike and hang injected, the
watchdog's `on_timeout` injected) must take the JAX trainer's sequence
of (step, action), skip and quarantine the same counts, and end with
parameters within 2e-4 of JAX's (f32, gpt2-tiny; 2e-5 after 3 steps in
test_torch_ppo.py, here 12 steps, one of them replayed after a rewind).
The global norm under accumulation and the chaos run are in
`test_torch_sentinel_runs.py`, so that `--dist loadfile` hands them out
after the large files.
"""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu import sentinel as j_sentinel
from trlx_tpu.data.default_configs import default_ppo_config as j_default_ppo_config
from trlx_tpu.pipeline.offline_pipeline import PromptPipeline as JPromptPipeline
from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPOTrainer
from trlx_tpu_torch import resilience, sentinel
from trlx_tpu_torch.convert import params_from_jax
from trlx_tpu_torch.data import PPORLElement
from trlx_tpu_torch.data.default_configs import default_ppo_config
from trlx_tpu_torch.models.policy import HydraReference
from trlx_tpu_torch.pipeline import MiniBatchIterator
from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

torch.set_num_threads(1)

STOP = ["�"]
SENTINEL = dict(
    sentinel=True, grad_skip_threshold=50.0, sentinel_window=8, sentinel_warmup=2, sentinel_zscore=8.0,
    sentinel_skip_after=2, sentinel_rewind_after=2, sentinel_good_steps=1, sentinel_pin_interval=1,
    max_rewinds=4, sentinel_cooldown_steps=4,
)


def reward_fn(samples, prompts, outputs, **kw):
    return [sum(c.islower() or c == " " for c in o) / max(len(o), 1) + 0.01 * len(p)
            for p, o in zip(prompts, outputs)]


def _prompts(n=12, seed=1):
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(2, 14))) for _ in range(n)]


def _config(make, tmp, side, **train):
    base = dict(seq_length=48, batch_size=4, epochs=4, total_steps=8, eval_interval=1000,
                checkpoint_interval=1000, seed=7, checkpoint_dir=str(tmp / side / "ckpts"),
                logging_dir=str(tmp / side / "logs"), tracker="jsonl")
    base.update(train)
    return make().evolve(
        train=base,
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1,
                   model_extra_configs={"attn_impl": "flash", "dtype": "float32"}),
        method=dict(num_rollouts=8, chunk_size=8, ppo_epochs=2, init_kl_coef=0.05,
                    gen_kwargs=dict(max_new_tokens=8, do_sample=False)),
    )


def _trainer(tmp, side, **train):
    t = PPOTrainer(_config(default_ppo_config, tmp, side, **train), reward_fn=reward_fn, stop_sequences=STOP,
                   device="cpu")
    t.add_prompt_pipeline(PromptPipeline(_prompts(), 40, t.tokenizer))
    t.add_eval_pipeline(PromptPipeline(_prompts()[:4], 40, t.tokenizer))
    return t


def _rows(logging_dir):
    rows = []
    for name in os.listdir(logging_dir):
        if name.endswith(".metrics.jsonl"):
            with open(os.path.join(logging_dir, name)) as f:
                rows += [json.loads(line) for line in f if line.strip()]
    return rows


def _store_batches(t, n=16, seed=3):
    """Minibatches over a random store (the JAX test's `push_random_store`)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        t.store.push([PPORLElement(
            query_tensor=rng.integers(3, 8, size=4).astype(np.int32),
            response_tensor=rng.integers(3, 8, size=5).astype(np.int32),
            logprobs=rng.normal(size=5).astype(np.float32),
            values=rng.normal(size=5).astype(np.float32),
            rewards=rng.normal(size=5).astype(np.float32),
        )])
    loader = t.store.create_loader(4, shuffle=False)
    return list(MiniBatchIterator(loader, t.mb_size, t.num_mb))


def _state(t):
    """Everything a skipped step must leave bitwise unchanged."""
    params = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
    opt = {i: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
           for i, s in t.optimizer.state_dict()["state"].items()}
    return params, opt, dict(t.scheduler.state_dict()), [g["lr"] for g in t.optimizer.param_groups]


def _assert_same_state(a, b):
    for name in a[0]:
        assert torch.equal(a[0][name], b[0][name]), name
    assert a[1].keys() == b[1].keys()
    for i in a[1]:
        for k in a[1][i]:
            x, y = a[1][i][k], b[1][i][k]
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y, (i, k)
    assert a[2] == b[2] and a[3] == b[3]


# ---------------------------------------------------------------------------
# The sentinel's host logic against the JAX package's
# ---------------------------------------------------------------------------


def _stats_sequence(seed):
    """Seeded step stats: a noisy baseline, a NaN, spikes and recovery."""
    rng = np.random.RandomState(seed)
    seq = []
    for step in range(40):
        loss = 1.0 + 0.05 * rng.randn()
        if step in (11, 23):
            loss = float("nan")
        if step in (15, 16, 17, 30):
            loss *= 1e4
        seq.append({"loss": loss, "train/grad_global_norm": abs(2.0 + 0.1 * rng.randn()),
                    "policy/approx_kl": 0.01 + 0.001 * rng.randn(), "other": rng.randn()})
    return seq


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(window=8, warmup=2, skip_after=2, rewind_after=2, good_steps=1, pin_interval=1, max_rewinds=1)),
    (2, dict(nan_guard_patience=1, max_rewinds=0)),
])
def test_ladder_and_rolling_stats_match_jax(seed, kw):
    ours, theirs = sentinel.HealthSentinel(**kw), j_sentinel.HealthSentinel(**kw)
    for step, stats in enumerate(_stats_sequence(seed), start=1):
        if step == 20:
            for s in (ours, theirs):
                s.observe_rollout({"rollout_scores/mean": 1e6, "rollout/entropy": 2.0})
        a, b = ours.observe_step(dict(stats), step), theirs.observe_step(dict(stats), step)
        assert (a.action, a.reasons) == (b.action, b.reasons), step
        if a.action == "ok" and ours.should_pin(step):
            assert theirs.should_pin(step)
            ours.note_pinned("/tmp/last_good", step)
            theirs.note_pinned("/tmp/last_good", step)
        if a.action == "rewind":
            ours.note_rewind(step)
            theirs.note_rewind(step)
        assert ours.lr_scale(step) == theirs.lr_scale(step) and ours.kl_scale(step) == theirs.kl_scale(step)
        assert ours.stats() == theirs.stats()
    assert ours.state_dict() == theirs.state_dict()
    stat, j_stat = sentinel.RollingStat(8, 3), j_sentinel.RollingStat(8, 3)
    for v in [1.0, 1.1, 0.9, 1.05, float("inf"), 50.0, 1.02]:
        assert stat.zscore(v) == j_stat.zscore(v)
        stat.push(v)
        j_stat.push(v)
    assert stat.state_dict() == j_stat.state_dict()


def test_quarantine_mask_and_repetition_frac_match_jax():
    rng = np.random.RandomState(5)
    kw = dict(quarantine_zscore=4.0, warmup=2, min_response_tokens=2, max_repetition_frac=0.9)
    ours, theirs = sentinel.HealthSentinel(**kw), j_sentinel.HealthSentinel(**kw)
    for chunk in range(4):
        scores = 1.0 + 0.05 * rng.randn(8)
        if chunk == 2:
            scores[3] = 1e3
        outputs = [list(rng.randint(0, 5, rng.randint(0, 7))) for _ in range(8)]
        outputs[5] = [4] * 6
        lens = np.array([len(o) for o in outputs])
        reps = np.array([sentinel.repetition_frac(o) for o in outputs])
        assert list(reps) == [j_sentinel.repetition_frac(o) for o in outputs]
        np.testing.assert_array_equal(ours.quarantine_mask(scores, lens, reps),
                                      theirs.quarantine_mask(scores, lens, reps))
    assert ours.quarantined_rows == theirs.quarantined_rows > 0
    assert ours.state_dict() == theirs.state_dict()
    # more than half flagged: keep everything
    assert not ours.quarantine_mask(np.ones(4), np.zeros(4), np.ones(4)).any()
    assert sentinel.repetition_frac([]) == j_sentinel.repetition_frac([]) == 1.0
    assert sentinel.LAST_GOOD_NAME == j_sentinel.LAST_GOOD_NAME and sentinel.ACTIONS == j_sentinel.ACTIONS


def test_train_fault_schedule_matches_jax():
    kw = dict(nan_grad_steps=[2], loss_spike_steps=[2, 5], hang_steps=[7])
    ours, theirs = resilience.FaultInjector(**kw), j_resilience.FaultInjector(**kw)
    seq = [0, 2, 2, 2, 5, 5, 7, 7]
    assert [ours.train_fault(s) for s in seq] == [theirs.train_fault(s) for s in seq] == \
        [None, "nan_grad", "loss_spike", None, "loss_spike", None, "hang", None]
    assert ours.injected == theirs.injected == 4
    batch = {"rewards": np.ones(3, np.float32)}
    assert ours.poison_batch(batch, "hang") is batch


# ---------------------------------------------------------------------------
# The step watchdog
# ---------------------------------------------------------------------------


def test_watchdog_fires_and_dumps_stacks(capfd):
    fired = []
    dog = sentinel.StepWatchdog(timeout_s=0.1, on_timeout=lambda: fired.append(True), poll_s=0.02).start()
    time.sleep(0.4)
    dog.stop()
    assert fired == [True] and dog.fired
    assert "most recent call first" in capfd.readouterr().err


def test_watchdog_is_held_off_by_beats():
    fired = []
    dog = sentinel.StepWatchdog(timeout_s=0.2, on_timeout=lambda: fired.append(True), poll_s=0.02).start()
    for _ in range(10):
        time.sleep(0.04)
        dog.beat()
    dog.stop()
    assert fired == [] and not dog.fired
    assert sentinel.StepWatchdog(timeout_s=10.0).on_timeout is None  # the default: os._exit(75)


def test_learn_starts_and_stops_the_watchdog(tmp_path):
    t = _trainer(tmp_path, "dog", step_timeout_s=300.0)
    t.prepare_learning = lambda: None
    t.evaluate = lambda: {}
    seen = {}

    def fake_loop(best, clock):
        seen["watchdog"] = t._watchdog
        return {}

    t._learn_loop = fake_loop
    t.learn()
    assert isinstance(seen["watchdog"], sentinel.StepWatchdog) and seen["watchdog"].timeout_s == 300.0
    assert t._watchdog is None


# ---------------------------------------------------------------------------
# The gradient guard
# ---------------------------------------------------------------------------


def test_sentinel_on_clean_run_is_bitwise_sentinel_off(tmp_path):
    def run(side, **train):
        t = _trainer(tmp_path, side, **train)
        for mb in _store_batches(t):
            stats = t.train_minibatch(mb)
            t.iter_count += 1
        return t, stats

    off, _ = run("off")
    on, stats = run("on", **SENTINEL)
    assert stats["train/skipped_updates"] == 0.0 and np.isfinite(stats["train/grad_global_norm"])
    _assert_same_state(_state(off), _state(on))


@pytest.mark.parametrize("fault,kw", [("nan", dict(nan_grad_steps=[1])),
                                      ("spike", dict(loss_spike_steps=[1], spike_scale=1e6))])
def test_skipped_step_leaves_params_adam_and_schedule_bitwise(tmp_path, fault, kw):
    t = _trainer(tmp_path, fault, **dict(SENTINEL, minibatch_size=2))  # two microbatches a step
    t.config.scheduler.name = "linear"
    mbs = _store_batches(t)
    stats0 = t.train_minibatch(mbs[0])
    t.iter_count += 1
    assert stats0["train/skipped_updates"] == 0.0
    before = _state(t)
    t.fault_injector = resilience.FaultInjector(**kw)
    stats1 = t.train_minibatch(mbs[1])
    assert stats1["train/skipped_updates"] == 1.0
    # NaN rewards: a NaN norm; finite but 1e6-scaled ones: above the threshold
    assert np.isnan(stats1["train/grad_global_norm"]) if fault == "nan" else \
        np.isfinite(stats1["train/grad_global_norm"]) and stats1["train/grad_global_norm"] > 50.0
    _assert_same_state(before, _state(t))


def test_lr_scale_scales_the_whole_update(tmp_path):
    """In the cooldown the update, weight decay included, is lr_damp times
    the undamped one."""
    cfgs = dict(SENTINEL, sentinel_lr_damp=0.25)
    a, b = _trainer(tmp_path, "full", **cfgs), _trainer(tmp_path, "damped", **cfgs)
    for t in (a, b):
        t.optimizer.param_groups[0]["weight_decay"] = 0.1
    b._sentinel.cooldown_until = 10
    mb = _store_batches(a)[0]
    p0 = {k: v.detach().clone() for k, v in a.model.named_parameters() if v.requires_grad}
    a.train_minibatch(mb)
    b.train_minibatch(mb)
    for k, v in a.model.named_parameters():
        if v.requires_grad:
            full, damped = v.detach() - p0[k], dict(b.model.named_parameters())[k].detach() - p0[k]
            # p + u rounds to the parameters' ulp: the updates are read to that
            torch.testing.assert_close(damped, 0.25 * full, rtol=1e-4, atol=3e-7)
    assert b.optimizer.param_groups[0]["lr"] == a.optimizer.param_groups[0]["lr"]


# ---------------------------------------------------------------------------
# The ladder in learn(): a chaos run against the JAX trainer
# ---------------------------------------------------------------------------


def _record_actions(t, acts):
    observe = t._sentinel.observe_step

    def wrapped(stats, step):
        verdict = observe(stats, step)
        acts.append((step, verdict.action))
        return verdict

    t._sentinel.observe_step = wrapped


def test_rewind_restores_the_pin_bitwise_and_moves_the_generator(tmp_path):
    t = _trainer(tmp_path, "pin", **dict(SENTINEL, epochs=6, total_steps=12))
    t.fault_injector = resilience.FaultInjector(nan_grad_steps=[2], loss_spike_steps=[5, 6])
    pins, restores, real_save, real_load = [], [], t.save, t.load

    def save(path=None):
        if path and os.path.basename(path) == sentinel.LAST_GOOD_NAME:
            pins.append((t.iter_count, _state(t), t.generator.get_state().clone()))
        real_save(path)

    def load(path):
        real_load(path)
        if os.path.basename(path) == sentinel.LAST_GOOD_NAME:
            restores.append((t.iter_count, _state(t), t.generator.get_state().clone()))

    t.save, t.load = save, load
    post = []
    real_post = t._post_rewind
    t._post_rewind = lambda: (post.append(t.generator.get_state().clone()), real_post())
    t.learn()
    assert t.iter_count == 12 and t._sentinel.rewinds_used == 1 and restores
    step, state, gen = restores[0]
    pin_step, pin_state, pin_gen = [p for p in pins if p[0] == step][-1]
    _assert_same_state(pin_state, state)
    assert torch.equal(pin_gen, gen)
    assert not torch.equal(post[0], gen)  # moved off the pinned stream


def test_budget_exhaustion_aborts_with_stats_flushed(tmp_path):
    t = _trainer(tmp_path, "abort", **dict(SENTINEL, epochs=4, sentinel_good_steps=1000, max_rewinds=0))
    t.fault_injector = resilience.FaultInjector(loss_spike_steps=[2, 3], spike_scale=1e4)
    with pytest.raises(FloatingPointError, match="Health sentinel abort"):
        t.learn()
    fatal = [r for r in _rows(t.config.train.logging_dir) if r["_step"] == t.iter_count and "losses/total_loss" in r]
    assert fatal and any("sentinel/anomaly_streak" in r for r in fatal)


def test_make_experience_quarantines_injected_outliers(tmp_path):
    t = _trainer(tmp_path, "quarantine", **dict(SENTINEL, sentinel_quarantine_zscore=6.0,
                                                 sentinel_min_response_tokens=0, sentinel_max_repetition_frac=1.1))
    calls = {"n": 0}

    def outlier_reward(samples, **kwargs):
        rewards = [1.0 + 0.05 * (j % 4) for j in range(len(samples))]
        calls["n"] += 1
        if calls["n"] == 3:
            rewards[0] = 1e6
        return rewards

    t.reward_fn = outlier_reward
    t.make_experience(8, iter_count=0)
    t.store.clear_history()
    t.make_experience(16, iter_count=1)
    assert t._sentinel.quarantined_rows >= 1
    assert len(t.store.history) >= 16  # an extra chunk made up the dropped row


def test_sentinel_state_rides_in_the_checkpoint(tmp_path):
    t = _trainer(tmp_path, "a", **SENTINEL)
    t._sentinel.record_skipped(2)
    t._sentinel.note_pinned("/tmp/pin", 4)
    t._sentinel.observe_step({"loss": 1.0}, 1)
    extra = t._extra_resume_state()
    assert "sentinel" in extra and "store_history" in extra
    directory = str(tmp_path / "a" / "ckpts" / "checkpoint_test")
    t.save(directory)
    t2 = _trainer(tmp_path, "b", **SENTINEL)
    t2.load(directory)
    assert t2._sentinel.skipped_updates == 2.0 and t2._sentinel.last_good["step"] == 4
    assert t2._sentinel.state_dict() == t._sentinel.state_dict()
    # plain dicts, lists and numbers: JAX's sentinel loads it too
    j_sen = j_sentinel.HealthSentinel()
    j_sen.load_state_dict(t._sentinel.state_dict())
    assert j_sen.state_dict() == t._sentinel.state_dict()


def test_gc_keeps_last_good_and_best(tmp_path):
    ckpt_dir = tmp_path / "ckpts"
    for i, name in enumerate(["checkpoint_1", "checkpoint_2", "checkpoint_3", sentinel.LAST_GOOD_NAME,
                              "best_checkpoint"]):
        d = ckpt_dir / name
        d.mkdir(parents=True)
        (d / "data.bin").write_text("x")
        (d / resilience.MANIFEST_NAME).write_text(json.dumps({"step": i + 1}))
    deleted = resilience.gc_checkpoints(str(ckpt_dir), keep_n=1)
    assert sorted(os.listdir(ckpt_dir)) == sorted(["checkpoint_3", sentinel.LAST_GOOD_NAME, "best_checkpoint"])
    assert sorted(os.path.basename(p) for p in deleted) == ["checkpoint_1", "checkpoint_2"]


def test_post_rewind_refreshes_the_fleet_snapshot_at_the_rewound_step(tmp_path):
    """After a rewind to a step whose snapshot the thread replicas already
    hold, they get the restored weights before the new collection (the
    step-keyed refresh alone would skip them)."""
    import threading
    import types

    t = _trainer(tmp_path, "fleet", **SENTINEL)
    pushed = []
    engine = types.SimpleNamespace(has_params=True, set_params=lambda p: pushed.append(
        {k: v.clone() for k, v in p.items()}))
    seat = types.SimpleNamespace(handle=types.SimpleNamespace(server=types.SimpleNamespace(engine=engine)))
    t._rollout_supervisor = types.SimpleNamespace(_lock=threading.Lock(), seats=[seat])
    t._snapshot_params()  # the replicas' weights at this step
    with torch.no_grad():  # the rewind's load restores other weights at the same step
        next(t.model.parameters()).add_(1.0)
    t.make_experience = lambda *a, **k: t._push_params_to_thread_replicas()  # a fleet collection's first act
    t._post_rewind()
    assert len(pushed) == 1
    for k, v in t.model.state_dict().items():
        assert torch.equal(pushed[0][k], v), k
    t._rollout_supervisor = None
