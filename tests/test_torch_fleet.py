"""The port's rollout fleet on the CPU: `inference/fleet.py:ReplicaRouter`
against the port's own servers (`PPOTrainer(config, device="cpu").serve()`
of random:gpt2-tiny at f32, greedy), with faults from the port's
`resilience.FaultInjector`:

- failover when a replica answers 503s (`http_500`), a hedge that beats a
  `slow` replica, a stale replica refused until it reports a fresh step,
  `FleetUnavailableError` when every replica is down, mixed-fault
  saturation with every prompt served, and a wedged /healthz;
- drain-on-sync: a hot-reload drains the request in flight before it
  swaps the weights, with readiness off (liveness on) in between;
- /chat through the router: a dead replica's session is replayed, whole
  transcript, on the other one;
- a killed thread replica gives back its engine's device state;
- `kernels.count_launch` is exact under concurrent threads.

Against the JAX package: the injector's `should_fail` sequence for the
same seed or schedule, and the router's `stats()` keys (the JAX router,
plain Python, runs over the same port servers). Every wait has a deadline
of at most 10 s."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu.inference.fleet import ReplicaRouter as JReplicaRouter
from trlx_tpu_torch import kernels, resilience
from trlx_tpu_torch.inference import InferenceEngine, InferenceServer, Scheduler, remote_generate
from trlx_tpu_torch.inference.fleet import FleetUnavailableError, ReplicaRouter
from trlx_tpu_torch.inference.supervisor import ThreadReplica
from trlx_tpu_torch.ops.sampling import GenerationConfig

torch.set_num_threads(1)

MAX_NEW = 4
# printable bytes and eos: the decode -> encode round trip stays exact
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]
GEN = dict(max_new_tokens=MAX_NEW, do_sample=False, suppress_tokens=SUPPRESS)
ID_PROMPTS = [[72, 101, 108, 108], [106, 97, 120], [112, 112, 111], [102, 108]]


def _config(tmp, **inference):
    from trlx_tpu_torch.data.default_configs import default_ppo_config

    return default_ppo_config().evolve(
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1, model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=32, batch_size=4, total_steps=4, tracker=None, checkpoint_dir=str(tmp), seed=11),
        method=dict(num_rollouts=8, chunk_size=4, ppo_epochs=2, gen_kwargs=dict(GEN)),
        inference=dict(dict(num_slots=4, max_prompt_len=32, max_new_tokens=MAX_NEW, max_wait_s=0.0,
                            reload_interval_s=3600.0), **inference),
    )


def _trainer(tmp, **inference):
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    return PPOTrainer(_config(tmp, **inference), reward_fn=lambda samples, **kw: [0.0] * len(samples),
                      device="cpu")


@pytest.fixture(scope="module")
def server_trainer(tmp_path_factory):
    return _trainer(tmp_path_factory.mktemp("fleet_srv"))


@pytest.fixture(scope="module")
def pair(server_trainer):
    """Two replicas shared by the router tests (each test resets the fault
    injector it sets; none kills these)."""
    servers = [server_trainer.serve(host="127.0.0.1", port=0, background=True) for _ in range(2)]
    yield servers
    for s in servers:
        s.shutdown()


def _router(servers, **kw):
    kw.setdefault("replica_retries", 0)
    kw.setdefault("retry_base_delay", 0.05)
    kw.setdefault("breaker_threshold", 2)
    kw.setdefault("breaker_recovery", 0.5)
    kw.setdefault("hedge", False)
    kw.setdefault("probe_timeout_s", 2.0)
    kw.setdefault("timeout", 10.0)
    return ReplicaRouter([s.url for s in servers], **kw)


def _local_greedy(trainer, prompt_ids):
    out = trainer.generate(np.asarray([prompt_ids], np.int32), np.ones((1, len(prompt_ids)), np.int32),
                           gen_kwargs=dict(GEN))
    toks, mask = out["response_tokens"][0].numpy(), out["response_mask"][0].numpy()
    return toks[mask > 0].tolist()


# ---------------------------------------------------------------------------
# The injector and the router's stats against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(rate=0.3, seed=0), dict(rate=0.5, seed=7), dict(rate=1.0, seed=3),
    dict(schedule=[1, 0, 0, 1, 1]), dict(schedule=[0, 1, 0], cycle=True),
])
def test_should_fail_sequence_matches_jax(kwargs):
    ours, theirs = resilience.FaultInjector(**kwargs), j_resilience.FaultInjector(**kwargs)
    assert [ours.should_fail() for _ in range(40)] == [theirs.should_fail() for _ in range(40)]
    assert ours.injected == theirs.injected


@pytest.mark.parametrize("name", ["nan_grad_steps", "loss_spike_steps", "hang_steps", "spike_scale",
                                  "hang_step_s"])
def test_train_side_faults_match_jax(name):
    """Each train-side argument of the injector is accepted and gives the
    JAX injector's schedule, poisoning and hang time (an unknown name
    still raises TypeError)."""
    kwargs = {name: [1, 3] if name.endswith("steps") else 7.0}
    if name in ("spike_scale", "hang_step_s"):
        kwargs.update(nan_grad_steps=[2], loss_spike_steps=[1, 2], hang_steps=[3])
    ours, theirs = resilience.FaultInjector(**kwargs), j_resilience.FaultInjector(**kwargs)
    assert [ours.train_fault(s) for s in (0, 1, 1, 2, 2, 2, 3, 3)] == \
        [theirs.train_fault(s) for s in (0, 1, 1, 2, 2, 2, 3, 3)]
    assert ours.injected == theirs.injected and ours.hang_step_s == theirs.hang_step_s
    rewards = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    for fault in ("nan_grad", "loss_spike"):
        a = ours.poison_batch({"rewards": rewards, "ids": np.ones(2, np.int64)}, fault)
        b = theirs.poison_batch({"rewards": rewards, "ids": np.ones(2, np.int64)}, fault)
        np.testing.assert_array_equal(a["rewards"], np.asarray(b["rewards"]))
        assert a["rewards"].dtype == np.float32
        np.testing.assert_array_equal(a["ids"], np.asarray(b["ids"]))
    with pytest.raises(TypeError):
        resilience.FaultInjector(no_such_fault=1)


def test_truncate_checkpoint_hides_it(tmp_path):
    d = tmp_path / "checkpoint_1"
    d.mkdir()
    (d / resilience.MANIFEST_NAME).write_text(json.dumps({"step": 1}))
    assert resilience.is_valid_checkpoint(str(d))
    resilience.FaultInjector.truncate_checkpoint(str(d))
    assert not resilience.is_valid_checkpoint(str(d))


def test_router_stats_keys_match_jax(pair):
    ours, theirs = _router(pair), JReplicaRouter([s.url for s in pair], replica_retries=0, hedge=False)
    try:
        ours.probe_all(force=True)
        theirs.probe_all(force=True)
        a, b = ours.stats(), theirs.stats()
        assert a.keys() == b.keys()
        # a replica's snapshot less what waits for item 4.7 (the compile
        # and HBM ledgers); its adapter residency is ported
        deferred = {"compiles_total", "compile_storms", "hbm_peak_bytes"}
        assert [set(r) for r in a["replicas"]] == [set(r) - deferred for r in b["replicas"]]
        assert a["capacity"] == b["capacity"] == 2
    finally:
        ours.close()
        theirs.close()


# ---------------------------------------------------------------------------
# Router: failover, hedging, staleness, whole-fleet-down, saturation
# ---------------------------------------------------------------------------


def test_router_failover_on_faulty_replica(server_trainer, pair):
    """A replica answering only 503s: every request fails over to the other
    one, nothing is dropped, the outputs stay right, its breaker opens.
    The prompts go one at a time, so the faulty replica takes two of them
    (its breaker's threshold) whatever the host's load: with concurrent
    coordinators, a slow host can order the dispatches so that only one
    reaches it and its breaker never opens."""
    router = _router(pair, concurrency=1)
    pair[0].fault_injector = resilience.FaultInjector(rate=1.0, mode="http_500")
    try:
        results = router.generate(ID_PROMPTS, max_new_tokens=MAX_NEW)
        for p, res in zip(ID_PROMPTS, results):
            assert res["token_ids"] == _local_greedy(server_trainer, p)
        stats = router.stats()
        assert stats["failovers"] >= 1
        reps = {r["url"]: r for r in stats["replicas"]}
        assert reps[pair[0].url]["served"] == 0
        assert reps[pair[1].url]["served"] == len(ID_PROMPTS)
        assert router.replicas[0].breaker.state in ("open", "half-open")
    finally:
        pair[0].fault_injector = None
        router.close()


def test_hedged_request_beats_slow_replica(pair):
    """`slow` on the first choice: the hedge fires after hedge_after_s and
    the other replica's answer wins well before the slow one lands."""
    slow_s = 2.5
    router = _router(pair, hedge=True, hedge_after_s=0.2)
    pair[0].fault_injector = resilience.FaultInjector(rate=1.0, mode="slow", slow_s=slow_s)
    try:
        t0 = time.monotonic()
        res = router.generate_one(ID_PROMPTS[0], max_new_tokens=MAX_NEW)
        elapsed = time.monotonic() - t0
        assert res["finish_reason"] in ("eos", "length")
        assert elapsed < slow_s - 0.5, f"hedge did not win ({elapsed:.2f}s)"
        stats = router.stats()
        assert stats["hedges"] >= 1 and stats["hedges_cancelled"] + stats["hedges_wasted"] >= 1
    finally:
        pair[0].fault_injector = None
        router.close(timeout_s=slow_s + 1)


def test_stale_replica_refused_until_reload(pair):
    """Bounded staleness: a replica reporting a step too far behind gets no
    request; once it reports a fresh step it is eligible again."""
    router = _router(pair, max_staleness_steps=1)
    pair[0].fault_injector = resilience.FaultInjector(stale_checkpoint_step=0)
    try:
        router.set_trainer_step(5)
        router.probe_all(force=True)
        assert not router._eligible(router.replicas[0]) and router._eligible(router.replicas[1])
        results = router.generate(ID_PROMPTS, max_new_tokens=MAX_NEW)
        assert all(r["finish_reason"] in ("eos", "length") for r in results)
        assert all(r["checkpoint_step"] is None for r in results)
        reps = {r["url"]: r for r in router.stats()["replicas"]}
        assert reps[pair[0].url]["served"] == 0, "stale replica got traffic"
        pair[0].fault_injector = resilience.FaultInjector(stale_checkpoint_step=5)
        router.probe_all(force=True)
        assert router._eligible(router.replicas[0])
    finally:
        pair[0].fault_injector = None
        router.close()


def test_stale_reply_is_redispatched(pair):
    """A reply whose checkpoint step is beyond the bound (the replica
    reloaded backwards mid-request) is rejected and served elsewhere."""
    router = _router(pair, max_staleness_steps=1)
    try:
        router.set_trainer_step(5)
        router.probe_all(force=True)
        # replica 0 turns stale after its probe: only its reply says so
        pair[0].fault_injector = resilience.FaultInjector(stale_checkpoint_step=0)
        router.replicas[1].inflight = 1  # least-loaded dispatch picks replica 0 first
        res = router.generate_one(ID_PROMPTS[1], max_new_tokens=MAX_NEW)
        router.replicas[1].inflight = 0
        assert res["checkpoint_step"] is None
        assert router.stats()["stale_rejected"] == 1
    finally:
        pair[0].fault_injector = None
        router.close()


def test_fleet_unavailable_when_all_replicas_down(pair):
    router = _router(pair)
    for s in pair:
        s.fault_injector = resilience.FaultInjector(rate=1.0, mode="http_500")
    try:
        with pytest.raises(FleetUnavailableError, match="unservable by the fleet"):
            router.generate(ID_PROMPTS[:2], max_new_tokens=MAX_NEW)
    finally:
        for s in pair:
            s.fault_injector = None
        router.close()
    # an empty fleet is a whole-fleet outage too
    empty = ReplicaRouter([])
    with pytest.raises(FleetUnavailableError):
        empty.generate_one([1, 2], max_new_tokens=MAX_NEW)
    empty.close()


def test_fleet_saturation_with_mixed_faults(server_trainer, pair):
    """A lossy replica (503s and dropped connections) and a healthy one
    under 16 concurrent prompts: every prompt served, greedy-right."""
    router = _router(pair, concurrency=8, breaker_threshold=4, breaker_recovery=0.2)
    pair[0].fault_injector = resilience.FaultInjector(rate=0.4, seed=3, mode="mixed")
    try:
        prompts = [ID_PROMPTS[i % len(ID_PROMPTS)] for i in range(16)]
        results = router.generate(prompts, max_new_tokens=MAX_NEW)
        want = {tuple(p): _local_greedy(server_trainer, p) for p in ID_PROMPTS}
        assert [r["token_ids"] for r in results] == [want[tuple(p)] for p in prompts]
        assert pair[0].fault_injector.injected >= 1
    finally:
        pair[0].fault_injector = None
        router.close()


def test_wedged_healthz_fails_the_probe(pair):
    router = _router(pair, probe_timeout_s=0.3)
    pair[1].fault_injector = resilience.FaultInjector(healthz_hang_s=1.0)
    try:
        assert router.probe(router.replicas[0]) is True
        assert router.probe(router.replicas[1]) is False
        assert not router.replicas[1].live and "probe" in router.replicas[1].last_error
    finally:
        pair[1].fault_injector = None
        router.close()


def test_router_metrics_render(pair):
    router = _router(pair)
    try:
        router.generate_one(ID_PROMPTS[0], max_new_tokens=MAX_NEW)
        text = router.render_metrics()
        assert "trlx_tpu_fleet_requests_total 1" in text and "trlx_tpu_fleet_capacity 2" in text
        assert f'trlx_tpu_fleet_replica_up{{url="{pair[0].url}"}} 1' in text
        assert "trlx_tpu_fleet_replica_kv_blocks_free" not in text  # fixed-slot replicas report no arena
    finally:
        router.close()


# ---------------------------------------------------------------------------
# Drain-on-sync readiness
# ---------------------------------------------------------------------------


def test_drain_on_sync_and_readiness(server_trainer, tmp_path, monkeypatch):
    """A hot-reload drains the request in flight before it swaps the
    weights, and /healthz readiness is off for the whole window while
    liveness stays on."""
    import trlx_tpu_torch.inference.server as server_module

    tok = server_trainer.tokenizer
    long_new = 200
    gen_cfg = GenerationConfig(max_new_tokens=long_new, do_sample=False, eos_token_id=tok.eos_token_id,
                               pad_token_id=tok.pad_token_id, suppress_tokens=tuple(SUPPRESS + [tok.eos_token_id]))
    engine = InferenceEngine(server_trainer.model, server_trainer.model_cfg, None, gen_cfg, num_slots=2,
                             max_prompt_len=32)
    sched = Scheduler(engine, max_wait_s=0.0)
    ckpt_dir = tmp_path / "ckpts"
    server = InferenceServer(sched, tokenizer=tok, host="127.0.0.1", port=0, watch_dir=str(ckpt_dir),
                             reload_interval_s=3600)
    url = server.start_background()
    try:
        assert server.ready is True
        server_trainer.iter_count = 3
        server_trainer.save(str(ckpt_dir / "checkpoint_03"))
        server_trainer.iter_count = 0
        record = {}
        orig_load, orig_set = server_module.load_checkpoint_params, engine.set_params

        def loader(path):
            params = orig_load(path)
            deadline = time.monotonic() + 10
            while not sched._slot_req and time.monotonic() < deadline:
                time.sleep(0.005)
            record["inflight_at_load"] = len(sched._slot_req)
            return params

        def set_params(params):
            record["inflight_at_swap"] = len(sched._slot_req)
            record["ready_during_reload"] = server.ready
            record["health"] = json.loads(urllib.request.urlopen(url + "/healthz", timeout=10).read())
            return orig_set(params)

        monkeypatch.setattr(server_module, "load_checkpoint_params", loader)
        engine.set_params = set_params
        result = {}
        req = threading.Thread(target=lambda: result.update(
            remote_generate(url, timeout=60)(ID_PROMPTS[1], max_new_tokens=long_new)))
        req.start()
        assert server.watcher.poll_once() is True
        req.join(timeout=10)
        assert not req.is_alive()
        assert record["inflight_at_load"] == 1, "the long request never got a slot"
        assert record["inflight_at_swap"] == 0, "weights swapped before the drain finished"
        assert record["ready_during_reload"] is False
        h = record["health"]
        assert h["live"] is True and h["ready"] is False and h["reloading"] is True
        assert result["finish_reason"] == "length" and len(result["token_ids"]) == long_new
        health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=10).read())
        assert health["ready"] is True and health["checkpoint_step"] == 3
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# Sessions through the router
# ---------------------------------------------------------------------------


def test_chat_replays_a_dead_sessions_transcript(tmp_path):
    """Turn 1 lands on a replica that then dies: turn 2 is replayed, whole
    transcript, as a fresh session on the other replica, and equals
    /generate over that transcript (greedy, f32); the next turn sticks to
    the new replica and reuses its retained blocks."""
    trainer = _trainer(tmp_path, kv_paging=True, kv_block_size=8, sessions=True, max_new_tokens=8,
                       gen_kwargs=dict(max_new_tokens=8))
    servers = [trainer.serve(host="127.0.0.1", port=0, background=True) for _ in range(2)]
    router = _router(servers)
    try:
        out1 = router.chat([65, 66, 67, 68], session_key="ep")
        first = router._sessions["ep"]["url"]
        dead = next(s for s in servers if s.url == first)
        alive = next(s for s in servers if s.url != first)
        resilience.FaultInjector.kill_replica(dead)
        transcript = [65, 66, 67, 68] + out1["token_ids"] + [32, 61, 32]
        out2 = router.chat([32, 61, 32], session_key="ep", max_new_tokens=8)
        assert router._sessions["ep"]["url"] == alive.url
        assert router.stats()["session_failovers"] == 1
        assert out2["prefill_tokens"] == len(transcript)
        fresh = remote_generate(alive.url)(transcript, max_new_tokens=8)
        assert out2["token_ids"] == fresh["token_ids"]
        out3 = router.chat([33], session_key="ep", max_new_tokens=8)
        assert out3["retained_hit"] and router._sessions["ep"]["url"] == alive.url
        assert router._sessions["ep"]["ids"] == transcript + out2["token_ids"] + [33] + out3["token_ids"]
        router.end_session("ep")
        assert "ep" not in router._sessions
    finally:
        router.close()
        for s in servers:
            s.shutdown()


# ---------------------------------------------------------------------------
# A killed replica's device state, and exact launch counts across threads
# ---------------------------------------------------------------------------


def test_killed_thread_replica_releases_its_engine(server_trainer):
    handle = ThreadReplica(lambda: server_trainer.serve(host="127.0.0.1", port=0, background=True))
    url = handle.spawn()
    assert remote_generate(url)(ID_PROMPTS[0], max_new_tokens=MAX_NEW)["token_ids"]
    engine = handle.server.engine
    assert handle.alive and engine.has_params
    handle.kill()
    assert not handle.alive
    assert engine._pool is None and engine.model is None and not engine.has_params
    assert not handle.server.ready
    # the module the engine was built on (the trainer's) is untouched
    assert all(torch.isfinite(p).all() for p in server_trainer.model.parameters())


def test_count_launch_is_exact_across_threads():
    name = "test_count_launch_threads"
    kernels.LAUNCHES.pop(name, None)
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        for _ in range(10_000):
            kernels.count_launch(name)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    try:
        assert kernels.LAUNCHES[name] == 80_000
        kernels.reset_launches()
        assert kernels.LAUNCHES[name] == 0
    finally:
        kernels.LAUNCHES.pop(name, None)
