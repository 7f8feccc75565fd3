"""The port's scheduler under multi-tenant serving (trlx_tpu_torch/
inference/scheduler.py: weighted deficit round-robin admission, the
per-tenant gates and queue cap, the capacity shed, adapter_id
validation) against the JAX package's (`tests/test_adapters.py`'s
scheduler cases): both schedulers take the same requests, over the same
fake engine or over the two packages' engines on one set of weights
(tests/multitenant_cases.py), and must decide exactly alike."""

import time
from collections import Counter

import numpy as np
import pytest

import multitenant_cases as mc
from trlx_tpu.inference import QueueFullError as JQueueFullError
from trlx_tpu.inference import Scheduler as JScheduler
from trlx_tpu.inference.scheduler import InferenceRequest as JInferenceRequest
from trlx_tpu_torch.inference import InferenceEngine, QueueFullError, Scheduler
from trlx_tpu_torch.inference.scheduler import InferenceRequest

PACKAGES = {"jax": (JScheduler, JInferenceRequest), "port": (Scheduler, InferenceRequest)}


class _FakeEngine:
    """Just enough engine surface for white-box scheduler tests."""

    num_slots = 4
    max_prefill_batch = 4
    kv_paging = False
    multi_tenant = True
    spec_k = 0

    def blocks_available(self):
        return 0


def _fair(pkg, weights, tenant_queue_depth=0, engine=None):
    sched_cls, _ = PACKAGES[pkg]
    return sched_cls(engine or _FakeEngine(), max_wait_s=0.0, fair_share=True, tenant_weights=weights,
                     tenant_queue_depth=tenant_queue_depth)


def _req(pkg, tenant, i):
    return PACKAGES[pkg][1](id=i, prompt_ids=np.zeros(4, np.int32), max_new_tokens=4, deadline=None,
                            adapter_id=tenant)


def _drain_order(pkg):
    sched = _fair(pkg, {"hot": 1.0, "cold": 1.0, "vip": 2.0})
    i = 0
    for tenant, n in (("hot", 20), ("cold", 5), ("vip", 5)):
        for _ in range(n):
            sched._queue.append(_req(pkg, tenant, i))
            i += 1
    admitted = []
    while sched._queue:
        with sched._cond:
            batch, slots, _ = sched._pop_weighted(False, 0)
        assert batch, "fair-share pop stalled with backlog and free slots"
        admitted.append([(sched._tenant(r), r.id) for r in batch])
        sched._free.extend(slots)
    return admitted


def test_fair_share_wdrr_order():
    """Admission batches (tenant and request, in order) equal JAX's, and a
    saturating tenant cannot starve the others."""
    port = _drain_order("port")
    assert port == _drain_order("jax")
    flat = [t for batch in port for t, _ in batch]
    assert Counter(flat) == {"hot": 20, "cold": 5, "vip": 5}
    assert set(flat[:8]) == {"hot", "cold", "vip"}
    first16 = Counter(flat[:16])
    assert first16["vip"] >= first16["cold"]


def test_blocked_tenants_and_the_mid_admission_drain():
    """A tenant mid adapter reload is skipped without stalling the others,
    and a drain waits for a request popped for admission but not yet in a
    slot (it already holds its adapter pin)."""
    seen = {}
    for pkg in PACKAGES:
        sched = _fair(pkg, {})
        sched._blocked_tenants.add("hot")
        sched._queue.extend([_req(pkg, "hot", 0), _req(pkg, "cold", 1)])
        with sched._cond:
            batch, slots, _ = sched._pop_weighted(False, 0)
        first = [sched._tenant(r) for r in batch]
        left = [r.adapter_id for r in sched._queue]
        sched._free.extend(slots)
        sched.resume_tenant("hot")
        with sched._cond:
            batch, _, _ = sched._pop_weighted(False, 0)
        second = [sched._tenant(r) for r in batch]
        sched._admitting = [_req(pkg, "a1", 2)]
        busy = sched.drain_tenant("a1", timeout_s=0.05)
        sched.resume_tenant("a1")
        sched._admitting = []
        idle = sched.drain_tenant("a1", timeout_s=0.05)
        sched.resume_tenant("a1")
        seen[pkg] = (first, left, second, busy, idle)
    assert seen["port"] == seen["jax"] == (["cold"], ["hot"], ["hot"], False, True)


def test_per_tenant_queue_depth_cap():
    for pkg, err in (("jax", JQueueFullError), ("port", QueueFullError)):
        sched = _fair(pkg, {}, tenant_queue_depth=2)
        sched._running = True  # white box: enqueue without the loop thread
        sched._enqueue([_req(pkg, "hot", 0)])
        sched._enqueue([_req(pkg, "hot", 1)])
        with pytest.raises(err):
            sched._enqueue([_req(pkg, "hot", 2)])
        sched._enqueue([_req(pkg, "cold", 3)])  # other tenants unaffected
        assert len(sched._queue) == 3
        assert 'adapter_requests_rejected_total{adapter="hot"} 1' in sched.metrics.render()


def test_admission_sheds_over_capacity_adapter_burst(tmp_path):
    """More distinct tenants than store slots into an idle pool: admission
    sheds tenant groups until the rest fit, the shed ones admit once the
    first wave's pins drop, and every request completes, as in JAX."""
    adir = mc.adapter_root(tmp_path)
    seen = {}
    for pkg, eng in zip(PACKAGES, mc.engines(adir, num_slots=2, max_new=4, max_resident=1)):
        sched = PACKAGES[pkg][0](eng, max_wait_s=0.0, fair_share=True)
        reqs = [_req(pkg, "a1", 0), _req(pkg, "a2", 1)]
        for r in reqs:
            r.prompt_ids = np.arange(1, 5, dtype=np.int32)
        sched._queue.extend(reqs)
        trail = []
        sched._admit()
        trail.append((len(sched._slot_req), len(sched._queue)))
        while sched._slot_req:
            sched._decode_once()
        sched._admit()
        trail.append((len(sched._slot_req), len(sched._queue)))
        while sched._slot_req:
            sched._decode_once()
        seen[pkg] = (trail, [r.finish_reason for r in reqs], [r.token_ids for r in reqs],
                     eng.adapter_store.stats()["evictions"])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [(1, 1), (1, 0)] and seen["port"][1] == ["length", "length"]
    assert seen["port"][3] >= 1


def test_tiny_weight_tops_up_in_one_step():
    """The deficit top-up is one step a round, not 1/weight steps: a lone
    tenant at weight 1e-6 pops at once."""
    for pkg in PACKAGES:
        sched = _fair(pkg, {"slow": 1e-6})
        sched._queue.append(_req(pkg, "slow", 0))
        t0 = time.monotonic()
        with sched._cond:
            batch, _, _ = sched._pop_weighted(False, 0)
        assert [sched._tenant(r) for r in batch] == ["slow"]
        assert time.monotonic() - t0 < 0.5
        with pytest.raises(ValueError, match="must be > 0"):
            _fair(pkg, {"bad": 0.0})


def test_adapter_id_validation(tmp_path):
    """adapter_id on a single-tenant engine and an unknown adapter are
    refused at submit time (a 400), as in JAX."""
    adir = mc.adapter_root(tmp_path)
    _, _, _, tcfg = mc.policy()
    plain = InferenceEngine(mc.port_model(), tcfg, None, mc.gen(4), num_slots=1, max_prompt_len=64)
    ids = np.asarray([1, 2, 3], np.int32)
    with pytest.raises(ValueError, match="multi_tenant"):
        Scheduler(plain, max_wait_s=0.0)._validate(ids, 4, adapter_id="a1")
    for pkg, eng in zip(PACKAGES, mc.engines(adir, num_slots=1, max_new=4, max_resident=2)):
        sched = PACKAGES[pkg][0](eng, max_wait_s=0.0)
        with pytest.raises(ValueError, match="unknown adapter"):
            sched._validate(ids, 4, adapter_id="nope")
        sched._validate(ids, 4, adapter_id="a1")
        sched._validate(ids, 4, adapter_id=None)
