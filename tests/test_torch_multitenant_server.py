"""Multi-tenant serving over HTTP in the port (trlx_tpu_torch/inference/
server.py's `/admin/adapters`, per-adapter hot-reload and `/healthz`
resident set; `trainer.serve()` and `serve_policy` from the config; the
fleet router's adapter affinity), held to the JAX package where the
decision is JAX's: the tokens a tenant's request decodes (against JAX's
engine on the same weights and factors, tests/multitenant_cases.py), the
single-tenant server's answer, and the replica each router picks."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import multitenant_cases as mc
from trlx_tpu.inference.fleet import ReplicaRouter as JReplicaRouter
from trlx_tpu_torch.inference import InferenceServer, Scheduler, remote_generate
from trlx_tpu_torch.inference.fleet import ReplicaRouter


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read()) if "metrics" not in url else resp.read().decode()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _error(call):
    with pytest.raises(urllib.error.HTTPError) as err:
        call()
    return err.value.code, dict(err.value.headers), json.loads(err.value.read())


def _server(adir, **store):
    _, teng = mc.engines(adir, num_slots=2, max_new=4, **store)
    server = InferenceServer(Scheduler(teng, max_wait_s=0.0, fair_share=True), host="127.0.0.1", port=0,
                             reload_interval_s=3600.0)
    server.start_background()
    return server


def test_server_multi_tenant_end_to_end(tmp_path):
    """adapter_id routed per request (tokens as JAX's engine decodes
    them), `/admin/adapters` list, load, evict and reload, the resident
    set in /healthz, per-adapter metric series, and a per-adapter
    hot-reload through the watcher's poll."""
    adir = mc.adapter_root(tmp_path)
    server = _server(adir, max_resident=2)
    url = server.url
    ids = [1, 2, 3, 4]
    try:
        fn = remote_generate(url)
        base_out = fn(ids, max_new_tokens=4)["token_ids"]
        a1_out = fn(ids, max_new_tokens=4, adapter_id="a1")["token_ids"]
        jeng, _ = mc.engines(adir, num_slots=2, max_new=4)
        want = mc.run_engine(jeng, [(np.asarray(ids, np.int32), 4, None), (np.asarray(ids, np.int32), 4, "a1")])
        assert [base_out, a1_out] == want and base_out != a1_out

        snap = _get(url + "/admin/adapters")
        assert snap["resident"] == ["a1"] and snap["available"] == ["a1", "a2", "a3"]
        assert snap["stats"]["loads"] == 1
        health = _get(url + "/healthz")
        assert health["adapters"] == {"resident": ["a1"], "capacity": 2}
        metrics = _get(url + "/metrics")
        assert 'adapter_requests_total{adapter="a1"' in metrics
        assert 'adapter_tokens_generated_total{adapter="a1"}' in metrics
        assert "adapters_resident 1" in metrics

        assert "a2" in _post(url + "/admin/adapters", {"load": "a2"})["resident"]
        assert _post(url + "/admin/adapters", {"evict": "a2"})["resident"] == ["a1"]
        assert _error(lambda: _post(url + "/admin/adapters", {"evict": "nope"}))[0] == 400
        assert _error(lambda: _post(url + "/admin/adapters", {"load": "a1", "evict": "a2"}))[0] == 400
        assert _error(lambda: _post(url + "/generate", {"prompt_ids": [1, 2], "adapter_id": "nope"}))[0] == 400

        # a newer a1 checkpoint changes a1's decode, not base's
        mc.write_adapter(adir, "a1", seed=77, step=9)
        assert _post(url + "/admin/adapters", {"reload": "a1"})["reloaded"] is True
        a1_new = fn(ids, max_new_tokens=4, adapter_id="a1")["token_ids"]
        assert a1_new != a1_out and fn(ids, max_new_tokens=4)["token_ids"] == base_out
        # the watcher's poll finds a moved checkpoint without an admin call
        mc.write_adapter(adir, "a1", seed=10, step=10)
        assert server.watcher.poll_adapters() == 1
        assert fn(ids, max_new_tokens=4, adapter_id="a1")["token_ids"] == a1_out
        assert 'adapter_reload_events_total{adapter="a1"} 2' in _get(url + "/metrics")
    finally:
        server.shutdown()


def test_admin_load_over_capacity_answers_503(tmp_path):
    """Every store slot pinned: a load answers 503 with Retry-After (a
    retry after the requests finish can succeed); once the pin drops the
    LRU resident makes room."""
    adir = mc.adapter_root(tmp_path)
    server = _server(adir, max_resident=1)
    store = server.engine.adapter_store
    try:
        store.acquire("a1")
        code, headers, body = _error(lambda: _post(server.url + "/admin/adapters", {"load": "a2"}))
        assert code == 503 and headers.get("Retry-After") == "1" and "pinned" in body["error"]
        store.release("a1")
        out = _post(server.url + "/admin/adapters", {"load": "a2"})
        assert out["resident"] == ["a2"] and out["stats"]["evictions"] == 1
    finally:
        server.shutdown()


def _config(tmp_path, **inference):
    from trlx_tpu_torch.data.default_configs import default_sft_config

    return default_sft_config().evolve(
        model=dict(model_path="random:gpt2-tiny", peft_config=mc.PEFT, model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=32, total_steps=0, tracker=None, batch_size=2,
                   checkpoint_dir=str(tmp_path / "ck"), logging_dir=str(tmp_path / "logs")),
        inference=dict(dict(num_slots=2, max_prompt_len=32, max_new_tokens=4, max_wait_s=0.0,
                            reload_interval_s=3600.0), **inference),
    )


def test_serve_builds_multi_tenant_from_the_config(tmp_path):
    """`serve()` under `inference.multi_tenant` builds the store from
    `adapter_dir`, `max_resident_adapters` and the byte budget and gives
    the scheduler fair share and the tenant knobs; a tenant saved by
    `TorchTrainer.save` decodes as the trainer holding its factors does.
    `serve_policy` takes an `adapter_dir` as multi-tenant serving."""
    import torch

    from trlx_tpu_torch.inference import serve_policy
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    tenant = SFTTrainer(_config(tmp_path), device="cpu")
    with torch.no_grad():
        for k, v in tenant.model.state_dict().items():
            if k.endswith(".lora_b"):
                v.copy_(0.5 * torch.randn(v.shape, generator=torch.Generator().manual_seed(5)))
    tenant.save(str(tmp_path / "adapters" / "t1"))
    prompt = [104, 105, 32]
    want = tenant.serve(port=0, background=True)
    try:
        tuned = remote_generate(want.url)(prompt, max_new_tokens=4)["token_ids"]
    finally:
        want.shutdown()
    trunk = SFTTrainer(_config(tmp_path, multi_tenant=True, adapter_dir=str(tmp_path / "adapters"),
                               max_resident_adapters=3, adapter_hbm_budget_mb=1.0,
                               tenant_weights={"t1": 2.0}, tenant_queue_depth=5, kv_paging=True,
                               kv_block_size=8, prefix_cache=True), device="cpu")
    server = trunk.serve(port=0, background=True)
    try:
        store, sched = server.engine.adapter_store, server.scheduler
        assert store.capacity == 3 and store.hbm_budget_bytes == 1024 * 1024
        assert sched.fair_share and sched.tenant_weights == {"t1": 2.0} and sched.tenant_queue_depth == 5
        fn = remote_generate(server.url)
        assert fn(prompt, max_new_tokens=4, adapter_id="t1")["token_ids"] == tuned
        assert fn(prompt, max_new_tokens=4)["token_ids"] != tuned
        assert _get(server.url + "/healthz")["adapters"]["resident"] == ["t1"]
    finally:
        server.shutdown()
    srv = serve_policy.main({"checkpoint": "random:gpt2-tiny", "device": "cpu", "port": 0, "background": True,
                             "adapter_dir": str(tmp_path / "adapters"), "model.peft_config": mc.PEFT,
                             "inference.max_prompt_len": 32})
    try:
        assert srv.engine.multi_tenant and srv.engine.adapter_store.scan() == ["t1"]
    finally:
        srv.shutdown()


def test_router_adapter_affinity_matches_jax(tmp_path):
    """Both packages' routers over the same two multi-tenant replicas (a1
    resident on one, a2 on the other): a request prefers the replica
    holding its adapter, falls back to the other when that one is
    excluded, and the least-loaded rule decides among equals."""
    adir = mc.adapter_root(tmp_path)
    servers = [_server(adir, max_resident=2) for _ in range(2)]
    try:
        _post(servers[0].url + "/admin/adapters", {"load": "a1"})
        _post(servers[1].url + "/admin/adapters", {"load": "a2"})
        picks = {}
        for name, cls in (("jax", JReplicaRouter), ("port", ReplicaRouter)):
            router = cls([s.url for s in servers], replica_retries=0, hedge=False)
            try:
                router.probe_all(force=True)
                reps = router.replicas
                order = [reps.index(router._pick(adapter_id=a)) for a in ("a1", "a2", "a3", None)]
                order.append(reps.index(router._pick(exclude=[reps[1]], adapter_id="a2")))
                reps[0].inflight = 5
                order.append(reps.index(router._pick(adapter_id="a1")))
                reps[0].inflight = 0
                out = router.generate_one([1, 2, 3], max_new_tokens=4, adapter_id="a2")
                picks[name] = (order, [r.adapters for r in reps], [r.served for r in reps], out["token_ids"])
            finally:
                router.close()
        assert picks["port"] == picks["jax"]
        assert picks["port"][0] == [0, 1, 0, 0, 0, 0] and picks["port"][1] == [["a1"], ["a2"]]
    finally:
        for s in servers:
            s.shutdown()
