"""The port's fleet supervisor (`inference/supervisor.py`) on the CPU: the
cases of the JAX package's `tests/test_supervisor.py`, against the port's
own fake replicas (an HTTP stand-in with /healthz and /admin/reload).

The supervision loop's thread is stopped right after `start()`: each test
drives `FleetSupervisor._tick()` itself, with short intervals, until its
condition holds or a deadline of at most 10 s passes, so nothing waits on
a background timer. Then the real thing on the CPU: the policy server
process (`python -m trlx_tpu_torch.inference.serve_policy`) as a
`SubprocessReplica` that the supervisor respawns after a kill, and a PPO
trainer that launches its own supervised fleet, loses a replica between
collections and collects the exact rollout count through the respawned
one.

The subprocess replica's respawn are in
`test_torch_supervisor_process.py`, so that `--dist loadfile` hands them
out after the large files.
"""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from trlx_tpu_torch import resilience
from trlx_tpu_torch.inference.supervisor import (
    QUARANTINED,
    SERVING,
    FleetSupervisor,
    ReplicaHandle,
    SubprocessReplica,
    ThreadReplica,
    serve_policy_command,
)

torch.set_num_threads(1)

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


class _FakeReplicaServer:
    """An InferenceServer stand-in: /healthz answers ready and a checkpoint
    step, POST /admin/reload adopts the manifest's step (or answers 500
    when `reload_ok` is off), `healthz_delay_s` wedges the health
    endpoint."""

    def __init__(self, ready=True, step=None, reload_ok=True, healthz_delay_s=0.0):
        self.ready = ready
        self.step = step
        self.reload_ok = reload_ok
        self.healthz_delay_s = healthz_delay_s
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path.rstrip("/") == "/healthz":
                    if srv.healthz_delay_s:
                        time.sleep(srv.healthz_delay_s)
                    self._json(200, {"status": "ok" if srv.ready else "degraded", "ready": srv.ready,
                                     "checkpoint_step": srv.step})
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if self.path.rstrip("/") == "/admin/reload":
                    if not srv.reload_ok:
                        self._json(500, {"error": "reload refused"})
                        return
                    srv.step = int(resilience.read_manifest(payload["path"])["step"])
                    self._json(200, {"reloaded": True, "checkpoint_step": srv.step})
                else:
                    self.send_error(404)

            def log_message(self, fmt, *args):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None  # ThreadReplica.alive turns False


def _fake_factory(overrides=None):
    overrides = overrides or {}

    def factory(i):
        return ThreadReplica(lambda: _FakeReplicaServer(**overrides.get(i, {})))

    return factory


FAST = dict(
    tick_s=0.01,
    probe_interval_s=0.03,
    probe_timeout_s=0.5,
    unhealthy_after=2,
    start_timeout_s=10.0,
    respawn_backoff_s=0.05,
    respawn_backoff_max_s=0.5,
    flap_window_s=10.0,
    flap_budget=2,
    sync_interval_s=3600.0,  # sync only when a test calls sync_once()
    drain_timeout_s=2.0,
    reload_timeout_s=3.0,
    router_kwargs=dict(replica_retries=0, hedge=False, probe_timeout_s=1.0),
)


def _driven(sup):
    """Start `sup` (spawn, router, metrics endpoint), then stop its loop
    thread: the test ticks it."""
    sup.start()
    sup._stop.set()
    sup._thread.join(timeout=10)
    sup._thread = None
    return sup


def _make(n=2, spares=0, overrides=None, factory=None, **kw):
    opts = {**FAST, **kw}
    return _driven(FleetSupervisor(factory or _fake_factory(overrides), num_replicas=n, spares=spares, **opts))


def _tick_until(sup, predicate, timeout_s=10.0, msg="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with sup._lock:
            sup._tick()
        if predicate():
            return
        time.sleep(0.01)
    assert predicate(), f"timed out waiting for {msg}"


def _ckpt(tmp_path, name, step):
    d = tmp_path / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "model.pt").write_bytes(b"\x00")
    (d / resilience.MANIFEST_NAME).write_text(json.dumps({"step": step, "wall_time": time.time()}))
    return str(d)


# ---------------------------------------------------------------------------
# Lifecycle: spawn, respawn, hang detection, quarantine, spares
# ---------------------------------------------------------------------------


def test_spawn_to_full_capacity():
    sup = _make(n=3)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 3, msg="3 serving")
        assert sup.router.capacity() == 3
        stats = sup.stats()
        assert stats["respawns"] == 3 and stats["deaths"] == 0
        assert {e["kind"] for e in sup.events} >= {"spawned", "serving"}
        assert sup.wait_ready(timeout_s=1.0)
    finally:
        sup.stop()


def test_respawn_after_replica_death():
    sup = _make(n=2)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 2, msg="serving")
        victim = sup.seats[0]
        old_url = victim.url
        victim.handle.server.shutdown()
        _tick_until(sup, lambda: sup.counters["deaths"] >= 1, msg="death detected")
        _tick_until(sup, lambda: sup.healthy_active() == 2, msg="capacity recovered")
        assert sup.counters["respawns"] >= 3
        urls = {r.url for r in sup.router.replicas}
        assert old_url not in urls and sup.seats[0].url in urls
        assert any(e["kind"] == "died" for e in sup.events)
    finally:
        sup.stop()


def test_hung_replica_is_killed_and_respawned():
    sup = _make(n=2)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 2, msg="serving")
        sup.seats[1].handle.server.healthz_delay_s = 5.0  # far above probe_timeout_s
        _tick_until(sup, lambda: sup.counters["deaths"] >= 1, msg="hang detected")
        _tick_until(sup, lambda: sup.healthy_active() == 2, msg="capacity recovered")
        died = [e for e in sup.events if e["kind"] == "died"][0]
        assert "probes" in died["reason"]
    finally:
        sup.stop()


def test_crash_loop_quarantine():
    injector = resilience.FaultInjector(crash_loop_replicas=[1], crash_loop_after_s=0.05)
    sup = _make(n=2, fault_injector=injector)
    try:
        _tick_until(sup, lambda: sup.counters["quarantines"] == 1, msg="quarantine")
        assert sup.seats[1].state == QUARANTINED
        assert sup.counters["deaths"] == FAST["flap_budget"] + 1  # the 3rd death quarantines
        respawns = sup.counters["respawns"]
        for _ in range(20):
            with sup._lock:
                sup._tick()
            time.sleep(0.01)
        assert sup.counters["respawns"] == respawns  # quarantine is final
        assert sup.healthy_active() == 1 and sup.seats[0].state == SERVING
        assert sup.wait_ready(timeout_s=1.0)  # the bar drops with the quarantine
    finally:
        sup.stop()


def test_backoff_doubles_then_resets():
    sup = _make(n=1, flap_window_s=0.4, flap_budget=50)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 1, msg="serving")
        seat = sup.seats[0]
        base = seat.backoff_s
        seat.handle.server.shutdown()
        _tick_until(sup, lambda: seat.backoff_s > base, msg="backoff doubled")
        assert seat.backoff_s == 2 * base
        _tick_until(sup, lambda: sup.healthy_active() == 1, msg="respawned")
        _tick_until(sup, lambda: seat.backoff_s == base and not seat.death_times, msg="backoff reset")
    finally:
        sup.stop()


def test_warm_spare_promotion():
    sup = _make(n=2, spares=1)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 2 and sup.spares_ready() == 1, msg="warm")
        spare_url = next(s.url for s in sup.seats if s.role == "spare")
        sup.seats[0].handle.server.shutdown()
        _tick_until(sup, lambda: sup.counters["promotions"] == 1, msg="promotion")
        assert sup.healthy_active() == 2 and spare_url in {r.url for r in sup.router.replicas}
        assert sup.seats[0].role == "spare"
        _tick_until(sup, lambda: sup.spares_ready() == 1, msg="spare pool refilled")
    finally:
        sup.stop()


def test_spawn_failure_backs_off_not_crashes():
    class NeverSpawns(ReplicaHandle):
        def spawn(self):
            raise RuntimeError("no capacity")

        @property
        def alive(self):
            return False

        def kill(self):
            pass

    sup = _make(n=1, factory=lambda i: NeverSpawns())
    try:
        _tick_until(sup, lambda: sum(e["kind"] == "spawn_failed" for e in sup.events) >= 2, msg="retried")
        assert sup.healthy_active() == 0
        assert sup.seats[0].backoff_s > FAST["respawn_backoff_s"]
    finally:
        sup.stop()


# ---------------------------------------------------------------------------
# Rolling weight sync
# ---------------------------------------------------------------------------


def test_rolling_sync_updates_every_replica(tmp_path):
    sup = _make(n=2, spares=1, watch_dir=str(tmp_path))
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 2 and sup.spares_ready() == 1, msg="warm")
        _ckpt(tmp_path, "checkpoint_05", 5)
        assert sup.sync_once() is True
        assert sup.synced_step == 5 and all(s.checkpoint_step == 5 for s in sup.seats)
        assert sup.counters["sync_replicas_synced"] == 3
        assert sup.counters["sync_min_capacity"] >= 1  # N-1 with N=2
        order = [e["seat"] for e in sup.events if e["kind"] == "sync_replica"]
        assert order[0] == next(s.index for s in sup.seats if s.role == "spare")
        assert sup.sync_once() is False  # the same checkpoint again
        bad = _ckpt(tmp_path, "checkpoint_09", 9)
        resilience.FaultInjector.truncate_checkpoint(bad)
        assert sup.sync_once() is False and sup.synced_step == 5
    finally:
        sup.stop()


def test_rolling_sync_reload_failure_respawns(tmp_path):
    sup = _make(n=2, overrides={0: dict(reload_ok=False)}, watch_dir=str(tmp_path))
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 2, msg="serving")
        _ckpt(tmp_path, "checkpoint_03", 3)
        assert sup.sync_once() is True
        assert sup.counters["sync_failures"] == 1 and sup.counters["sync_replicas_synced"] == 1
        _tick_until(sup, lambda: sup.healthy_active() == 2, msg="capacity recovered")
    finally:
        sup.stop()


def test_the_loop_scans_watch_dir(tmp_path):
    """The tick's own scan (sync_interval_s elapsed) rolls a checkpoint out."""
    sup = _make(n=1, watch_dir=str(tmp_path), sync_interval_s=0.0)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 1, msg="serving")
        _ckpt(tmp_path, "checkpoint_02", 2)
        _tick_until(sup, lambda: sup.synced_step == 2, msg="scan and sync")
        assert sup.counters["rolling_syncs"] == 1
    finally:
        sup.stop()


# ---------------------------------------------------------------------------
# Observability
# ---------------------------------------------------------------------------


def test_metrics_endpoint_serves_fleet_view():
    sup = _make(n=2, metrics_port=0)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 2, msg="serving")
        base = f"http://127.0.0.1:{sup.metrics_port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert "trlx_tpu_fleet_supervisor_respawns_total 2" in text
        assert "trlx_tpu_fleet_supervisor_capacity 2" in text
        assert "trlx_tpu_fleet_capacity" in text and 'trlx_tpu_fleet_replica_up{url="' in text
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["capacity"] == 2 and len(health["seats"]) == 2
        with urllib.request.urlopen(base + "/debug/slo", timeout=10) as resp:
            assert "slos" in json.loads(resp.read()) or resp.status == 200
    finally:
        sup.stop()


def test_stats_are_trainer_mergeable():
    sup = _make(n=1)
    try:
        _tick_until(sup, lambda: sup.healthy_active() == 1, msg="serving")
        stats = sup.stats()
        for key in ("respawns", "deaths", "quarantines", "promotions", "capacity", "spares_ready",
                    "sync_in_progress"):
            assert isinstance(stats[key], (int, float)), key
    finally:
        sup.stop()


def test_stop_kills_replicas_and_closes_router():
    sup = _make(n=2)
    _tick_until(sup, lambda: sup.healthy_active() == 2, msg="serving")
    servers = [s.handle.server for s in sup.seats]
    sup.stop()
    assert all(srv._httpd is None for srv in servers)
    assert sup.router._requests._shutdown


def test_stats_keys_match_jax():
    from trlx_tpu.inference.supervisor import FleetSupervisor as JFleetSupervisor
    from trlx_tpu.inference.supervisor import ThreadReplica as JThreadReplica

    ours = _make(n=1)
    theirs = _driven(JFleetSupervisor(lambda i: JThreadReplica(lambda: _FakeReplicaServer()), num_replicas=1,
                                      **FAST))
    try:
        _tick_until(ours, lambda: ours.healthy_active() == 1, msg="ours serving")
        _tick_until(theirs, lambda: theirs.healthy_active() == 1, msg="theirs serving")
        a, b = ours.stats(), theirs.stats()
        # a seat's snapshot less the compile and HBM ledgers' (item 4)
        assert a.keys() == b.keys() and set(a["seats"][0]) == set(b["seats"][0]) - {"compile_storms", "hbm_peak_bytes"}
        assert {k: v for k, v in a.items() if k != "seats"} == {k: v for k, v in b.items() if k != "seats"}
    finally:
        ours.stop()
        theirs.stop()


# ---------------------------------------------------------------------------
# The real replicas: the policy server process, a trainer's own fleet
# ---------------------------------------------------------------------------


def test_serve_policy_command_formats_to_a_json_argument():
    argv = serve_policy_command("random:gpt2-tiny", device="cpu", **{"inference.num_slots": 2})
    assert argv[1:3] == ["-m", "trlx_tpu_torch.inference.serve_policy"]
    payload = json.loads(argv[3].format(port=1234))
    assert payload == {"checkpoint": "random:gpt2-tiny", "port": 1234, "device": "cpu", "inference.num_slots": 2}


def test_serve_policy_refuses_adapters():
    """Multi-tenant serving is ported: an `adapter_dir` implies it, and
    the trunk must then be a LoRA policy, which `random:gpt2-tiny` without
    a `peft_config` is not (the store refuses it, as JAX's does)."""
    from trlx_tpu_torch.inference import serve_policy

    with pytest.raises(ValueError, match="AdapterStore needs a LoRA-enabled policy"):
        serve_policy.main({"checkpoint": "random:gpt2-tiny", "adapter_dir": "adapters", "device": "cpu"})
    with pytest.raises(ValueError, match="AdapterStore needs a LoRA-enabled policy"):
        serve_policy.main({"checkpoint": "random:gpt2-tiny", "inference.multi_tenant": True, "device": "cpu"})


def test_serve_policy_supervised_in_process():
    from trlx_tpu_torch.inference import remote_generate, serve_policy

    sup = serve_policy.main({"checkpoint": "random:gpt2-tiny", "device": "cpu", "replicas": 2,
                             "supervised": True, "background": True, "port": 0,
                             "supervisor_kwargs": dict(tick_s=0.02, probe_interval_s=0.05, start_timeout_s=10.0),
                             "inference.max_new_tokens": 4, "inference.max_prompt_len": 64})
    try:
        assert sup.healthy_active() == 2
        out = remote_generate(sup.seats[0].url)([72, 105], max_new_tokens=4)
        assert len(out["token_ids"]) <= 4
    finally:
        sup.stop()


MAX_NEW = 4
SUPPRESS = [i for i in range(259) if not (32 <= i < 127 or i == 258)]
PROMPTS = ["hello world", "jax tpu", "ppo", "fleet"] * 2


def test_supervised_ppo_fleet_recovers_and_counts_are_exact(tmp_path):
    """`rollout_backend="fleet"` and `rollout_fleet_supervised`: the
    trainer launches 2 thread replicas, collects through them, loses one,
    and the supervisor respawns it (on the last weights' snapshot) before
    the next collection: both collections hold the exact rollout count
    and no chunk degrades."""
    from trlx_tpu_torch.data.default_configs import default_ppo_config
    from trlx_tpu_torch.pipeline.offline_pipeline import PromptPipeline
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    config = default_ppo_config().evolve(
        model=dict(model_path="random:gpt2-tiny", num_layers_unfrozen=1, model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=32, batch_size=4, total_steps=4, tracker=None, checkpoint_dir=str(tmp_path), seed=11,
                   rollout_backend="fleet", rollout_fleet_supervised=True, rollout_fleet_size=2,
                   rollout_fleet_kwargs=dict(replica_retries=0, hedge=False),
                   rollout_fleet_supervisor_kwargs=dict(tick_s=0.02, probe_interval_s=0.1, respawn_backoff_s=0.1,
                                                        flap_window_s=30.0, flap_budget=3, sync_interval_s=3600.0,
                                                        start_timeout_s=10.0)),
        method=dict(num_rollouts=8, chunk_size=4, ppo_epochs=2,
                    gen_kwargs=dict(max_new_tokens=MAX_NEW, do_sample=False, suppress_tokens=SUPPRESS)),
        inference=dict(num_slots=4, max_prompt_len=32, max_new_tokens=MAX_NEW, max_wait_s=0.0),
    )
    trainer = PPOTrainer(config, reward_fn=lambda samples, **kw: [float(len(s)) for s in samples], device="cpu")
    trainer.add_prompt_pipeline(PromptPipeline(PROMPTS, max_prompt_length=8, tokenizer=trainer.tokenizer))
    try:
        trainer.make_experience(config.method.num_rollouts)
        assert len(trainer.store.history) == config.method.num_rollouts
        sup = trainer._rollout_supervisor
        assert sup is not None and sup.healthy_active() == 2
        # every seat decodes on its own copy of the weights
        own = {p.data_ptr() for p in trainer.model.parameters()}
        for seat in sup.seats:
            assert not any(p.data_ptr() in own for p in seat.handle.server.engine.model.parameters())
        seats = list(sup.seats)
        sup.seats[0].handle.server.shutdown()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not (sup.counters["deaths"] >= 1 and sup.healthy_active() == 2):
            time.sleep(0.02)
        assert sup.counters["deaths"] >= 1 and sup.healthy_active() == 2
        trainer.make_experience(config.method.num_rollouts)
        assert len(trainer.store.history) == 2 * config.method.num_rollouts
        assert all(len(np.asarray(e.response_tensor)) <= MAX_NEW for e in trainer.store.history)
    finally:
        trainer.shutdown_rollout_fleet()
        assert trainer._rollout_supervisor is None
    for seat in seats:
        assert seat.handle is None or not seat.handle.alive
