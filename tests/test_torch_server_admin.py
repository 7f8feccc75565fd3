"""The port's single-replica serving surface over HTTP on the CPU
(`SFTTrainer(config, device="cpu").serve(port=0)`, llama-tiny, f32):

- the default `inference` section (the fixed-slot pool) answers
  /generate, every decode dispatch a `kv_paging_off` fallback;
- checkpoint hot-reload, driven through `CheckpointWatcher.poll_once()`
  and `POST /admin/reload` (never a timed poll): an incomplete checkpoint
  is refused, a complete one is served and /healthz reports its step, and
  a greedy reply afterwards equals a fresh engine's on those weights;
- refused reloads leave the served weights and step as they were: a path
  outside `watch_dir`, a `model.pt` holding a pickled payload (read with
  `weights_only=True`, the payload never runs), and a checkpoint whose
  tensors do not fit the model (checked before the drain, and not tried
  again);
- `/admin/drain` answers 503 until `/admin/undrain`;
- SSE: the streamed token deltas concatenate to the non-streaming reply,
  for /generate and /chat;
- /chat: a turn over the retained blocks equals /generate over the whole
  transcript; 409 for a busy, a reset and an unknown session.

The JAX package's engine is held against the port's in
`test_torch_serving_pool.py`; this file exercises the port's server
alone."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from trlx_tpu_torch.inference import InferenceEngine, sse_stream

# one intra-op thread: the tensors here are tiny, and the suite runs in
# several worker processes at once, which extra threads only slow down
torch.set_num_threads(1)

TIMEOUT = 60  # seconds, every HTTP call


def _config(tmp, **inference):
    from trlx_tpu_torch.data.default_configs import default_sft_config

    return default_sft_config().evolve(
        model=dict(model_path="random:llama-tiny", model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=64, total_steps=0, tracker=None, batch_size=2,
                   checkpoint_dir=str(tmp / "ckpt"), logging_dir=str(tmp / "logs")),
        # a watcher thread that never polls by itself: the tests drive it
        inference=dict(max_new_tokens=8, gen_kwargs=dict(do_sample=False), reload_interval_s=3600.0,
                       **inference),
    )


def _trainer(cfg):
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    return SFTTrainer(cfg, device="cpu")


def _request(url, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A paged server with sessions, watching `watch`."""
    tmp = tmp_path_factory.mktemp("serve")
    cfg = _config(tmp, kv_paging=True, kv_block_size=8, num_slots=2, max_prompt_len=64,
                  sessions=True)
    trainer = _trainer(cfg)
    watch = tmp / "watch"
    watch.mkdir()
    server = trainer.serve(port=0, background=True, watch_dir=str(watch))
    yield trainer, server, watch, cfg
    server.shutdown()


def _greedy(trainer, gen_cfg, prompt_ids):
    """A fresh engine's greedy reply on `trainer`'s weights."""
    eng = InferenceEngine(trainer.model, trainer.model_cfg, None, gen_cfg, num_slots=1, max_prompt_len=64)
    eng.insert_requests([(np.asarray(prompt_ids, np.int32), gen_cfg.max_new_tokens)], [0])
    toks = []
    while True:
        t, _, v, f = eng.step()
        if v[0]:
            toks.append(int(t[0]))
        if f[0]:
            return toks


def test_default_inference_section_serves_the_fixed_slot_pool(tmp_path):
    cfg = _config(tmp_path, num_slots=2, max_prompt_len=32)
    assert cfg.inference.kv_paging is False
    server = _trainer(cfg).serve(port=0, background=True)
    try:
        code, out = _request(server.url, "/generate", {"prompt": "hello", "max_new_tokens": 6})
        assert code == 200 and len(out["token_ids"]) == 6 and out["checkpoint_step"] is None
        code, health = _request(server.url, "/healthz")
        n = health["kv"]["kv_kernel_fallbacks"]["kv_paging_off"]
        assert health["ready"] and n >= 5
        assert health["kv"] == {"kv_kernel_dispatches": 0, "kv_kernel_fallbacks": {"kv_paging_off": n}}
        with urllib.request.urlopen(server.url + "/metrics", timeout=TIMEOUT) as r:
            assert 'kv_kernel_fallbacks{reason="kv_paging_off"}' in r.read().decode()
    finally:
        server.shutdown()


def test_drain_answers_503_until_undrain(served):
    _, server, _, _ = served
    assert _request(server.url, "/admin/drain", {})[1] == {"draining": True, "idle": None}
    code, out = _request(server.url, "/generate", {"prompt": "hi", "max_new_tokens": 2})
    assert code == 503 and "draining" in out["error"]
    health = _request(server.url, "/healthz")[1]
    assert health["draining"] and not health["ready"]
    assert _request(server.url, "/admin/undrain", {})[1] == {"draining": False}
    assert _request(server.url, "/generate", {"prompt": "hi", "max_new_tokens": 2})[0] == 200


@pytest.mark.parametrize("path", ["/generate", "/chat"])
def test_sse_tokens_equal_the_reply(served, path):
    _, server, _, _ = served
    payload = {"prompt_ids": list(range(30, 45)), "max_new_tokens": 7}
    events = list(sse_stream(server.url + path, payload, timeout=TIMEOUT))
    done = events[-1]
    assert done["event"] == "done" and done["finish_reason"] == "length"
    streamed = [t for e in events[:-1] for t in e["token_ids"]]
    assert streamed == done["token_ids"]
    assert len(events) >= 2
    if path == "/generate":
        assert _request(server.url, "/generate", payload)[1]["token_ids"] == streamed
    else:
        assert done["turn"] == 1 and done["session_id"]


def test_chat_turns_reuse_blocks_and_equal_generate(served):
    _, server, _, _ = served
    turns = [list(range(40, 57)), list(range(70, 75))]
    history, sid = [], None
    for i, turn in enumerate(turns):
        code, out = _request(server.url, "/chat", {"prompt_ids": turn, **({"session_id": sid} if sid else {})})
        assert code == 200 and out["turn"] == i + 1
        sid = out["session_id"]
        history += turn
        assert out["token_ids"] == _request(server.url, "/generate", {"prompt_ids": history})[1]["token_ids"]
        history += out["token_ids"]
        if i:
            # 17 + 8 tokens retained 3 blocks of 8; the new turn prefills the rest
            assert out["retained_hit"] and out["retained_blocks"] == 3
            assert out["prefill_tokens"] == len(history) - len(out["token_ids"]) - 3 * 8
    assert _request(server.url, "/healthz")[1]["sessions"]["session_retained_hits_total"] >= 1


def test_chat_busy_and_unknown_sessions_answer_409(served):
    _, server, _, _ = served
    sid = _request(server.url, "/chat", {"prompt_ids": [1, 2, 3]})[1]["session_id"]
    store = server.engine.session_store
    store.begin_turn(sid)  # a turn in flight
    try:
        code, out = _request(server.url, "/chat", {"prompt_ids": [4], "session_id": sid})
        assert code == 409 and out["session_busy"] and out["session_id"] == sid
    finally:
        store.end_turn(store.get(sid))
    code, out = _request(server.url, "/chat", {"prompt_ids": [4], "session_id": "nope"})
    assert code == 409 and out["session_reset"] and out["reason"] == "unknown_session"


def _checkpoint(tmp, cfg, name, step, scale):
    """A checkpoint of a trainer whose weights are the served ones scaled
    by `scale`, at `step`; returns (path, that trainer)."""
    trainer = _trainer(cfg)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.mul_(scale)
    trainer.iter_count = step
    path = os.path.join(tmp, name)
    trainer.save(path)
    return path, trainer


def test_hot_reload_through_the_watcher_and_admin(served, tmp_path):
    trainer, server, watch, cfg = served
    prompt = list(range(50, 70))
    sid = _request(server.url, "/chat", {"prompt_ids": prompt})[1]["session_id"]
    # an incomplete checkpoint (no manifest) is invisible and refused
    partial, _ = _checkpoint(str(watch), cfg, "checkpoint_9", 9, 1.5)
    os.remove(os.path.join(partial, "manifest.json"))
    assert not server.watcher.poll_once()
    code, out = _request(server.url, "/admin/reload", {"path": partial})
    assert code == 200 and out == {"reloaded": False, "checkpoint_step": None, "reloads": 0}
    # a complete one is picked up by the watcher's scan
    path3, t3 = _checkpoint(str(watch), cfg, "checkpoint_3", 3, 1.3)
    v0 = server.engine.param_version
    assert server.watcher.poll_once()
    health = _request(server.url, "/healthz")[1]
    assert health["checkpoint_step"] == 3 and health["reloads"] == 1 and health["ready"]
    assert health["param_version"] == v0 + 1
    out = _request(server.url, "/generate", {"prompt_ids": prompt})[1]
    assert out["checkpoint_step"] == 3
    assert out["token_ids"] == _greedy(t3, server.engine.gen_cfg, prompt)
    assert not server.watcher.poll_once()  # already live
    # the session was written under the old weights: reset, never stale
    code, out = _request(server.url, "/chat", {"prompt_ids": [5], "session_id": sid})
    assert code == 409 and out["reason"] == "weights_updated"
    # /admin/reload takes an explicit path under watch_dir
    path7, t7 = _checkpoint(str(watch), cfg, "checkpoint_7", 7, 0.8)
    code, out = _request(server.url, "/admin/reload", {"path": path7})
    assert code == 200 and out == {"reloaded": True, "checkpoint_step": 7, "reloads": 2}
    assert _request(server.url, "/generate", {"prompt_ids": prompt})[1]["token_ids"] == \
        _greedy(t7, server.engine.gen_cfg, prompt)
    with urllib.request.urlopen(server.url + "/metrics", timeout=TIMEOUT) as r:
        text = r.read().decode()
    assert "checkpoint_reloads_total 2" in text and "checkpoint_step 7" in text


def _served_state(server, prompt):
    health = _request(server.url, "/healthz")[1]
    reply = _request(server.url, "/generate", {"prompt_ids": prompt})[1]
    return health["checkpoint_step"], health["reloads"], health["param_version"], reply["token_ids"]


class _Payload:
    """Unpickling this calls os.makedirs(marker)."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.makedirs, (self.marker,)


def test_reload_refuses_outside_paths_and_pickled_payloads(served, tmp_path):
    trainer, server, watch, cfg = served
    prompt = list(range(20, 40))
    state = _served_state(server, prompt)
    # a complete checkpoint outside the watched directory
    outside, _ = _checkpoint(str(tmp_path), cfg, "checkpoint_40", 40, 0.9)
    code, out = _request(server.url, "/admin/reload", {"path": outside})
    assert code == 400 and "not under the watched directory" in out["error"]
    code, out = _request(server.url, "/admin/reload", {"path": os.path.join(str(watch), "..", "x")})
    assert code == 400
    # a manifest-complete checkpoint whose model.pt holds a pickled call
    evil, _ = _checkpoint(str(watch), cfg, "checkpoint_41", 41, 0.9)
    marker = str(tmp_path / "ran")
    torch.save({"lm.embed_tokens.weight": _Payload(marker)}, os.path.join(evil, "model.pt"))
    code, out = _request(server.url, "/admin/reload", {"path": evil})
    assert code == 200 and out["reloaded"] is False
    assert not server.watcher.poll_once()  # the newest checkpoint, refused once and not retried
    assert not os.path.exists(marker)
    assert _served_state(server, prompt) == state
    # the payload is live: an unrestricted unpickle runs it
    torch.load(os.path.join(evil, "model.pt"), weights_only=False)
    assert os.path.isdir(marker)


def test_reload_of_a_misfit_checkpoint_changes_nothing(served, monkeypatch):
    """A checkpoint whose tensors do not fit the served model is refused
    before the scheduler drains, and the watcher does not retry it."""
    trainer, server, watch, cfg = served
    prompt = list(range(20, 40))
    state = _served_state(server, prompt)
    path, _ = _checkpoint(str(watch), cfg, "checkpoint_50", 50, 0.9)
    params = torch.load(os.path.join(path, "model.pt"), weights_only=True)
    params.pop(sorted(params)[0])
    torch.save(params, os.path.join(path, "model.pt"))
    drains, checks, check = [], [], server.engine.check_params
    monkeypatch.setattr(server.scheduler, "drain", lambda *a: drains.append(a) or True)
    monkeypatch.setattr(server.engine, "check_params", lambda p: checks.append(1) or check(p))
    assert not server.watcher.poll_once()
    assert not server.watcher.poll_once()
    assert drains == [] and len(checks) == 1
    assert _served_state(server, prompt) == state
    assert _request(server.url, "/healthz")[1]["ready"]
