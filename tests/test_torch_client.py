"""The port's client side against the JAX package's and against the
port's own server on the CPU:

- `resilience.CircuitBreaker`, `retry` and `compute_backoff` on an
  injected clock, sleep and random source: the same states, delays,
  attempts and errors as the JAX package's;
- `RetryingJSONClient` (`utils/http.py`) against a draining server: the
  503s are retried with the server's Retry-After, then surface as a
  TransientError that counts against the breaker; a 4xx is an
  application error, not retried;
- `inference/client.py` against `SFTTrainer(config, device="cpu").serve()`:
  `remote_generate` (one prompt and a fan-out), `stream_generate`, and a
  `ChatSession` over two turns and through a session reset."""

import json
import random
import urllib.request

import pytest
import torch

from trlx_tpu import resilience as j_resilience
from trlx_tpu_torch import resilience
from trlx_tpu_torch.inference import ChatSession, remote_generate, stream_generate
from trlx_tpu_torch.utils.http import RetryingJSONClient

torch.set_num_threads(1)

TIMEOUT = 60  # seconds, every HTTP call
PACKAGES = {"jax": j_resilience, "torch": resilience}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker_script(res):
    clock = Clock()
    br = res.CircuitBreaker(failure_threshold=3, recovery_time=10.0, clock=clock)
    log = []

    def check():
        try:
            br.check()
            log.append(("pass", br.state))
        except res.CircuitOpenError:
            log.append(("open", br.state))

    for _ in range(2):
        br.record_failure()
        check()
    br.record_failure()  # the third: opens
    check()
    clock.t += 9.9
    check()
    clock.t += 0.2  # half-open: one probe passes, the next fails fast
    check()
    check()
    br.record_failure()  # the probe failed: open again
    check()
    clock.t += 10.0
    check()
    br.record_success()  # the probe succeeded: closed
    check()
    log.append(("failures", br.failures, br.opened_at))
    return log


def test_circuit_breaker_transitions_match_jax():
    logs = {pkg: _breaker_script(res) for pkg, res in PACKAGES.items()}
    assert logs["torch"] == logs["jax"]
    assert [state for kind, state, *_ in logs["torch"][:-1]] == [
        "closed", "closed", "open", "open", "half-open", "half-open", "open", "half-open", "closed",
    ]


def _retry_script(res, fail_times, **kw):
    clock = Clock()
    slept, seen = [], []

    def sleep(d):
        slept.append(d)
        clock.t += d

    calls = []

    @res.retry(sleep=sleep, clock=clock, rng=random.Random(7), base_delay=0.5, max_delay=4.0,
               on_retry=lambda a, e, d: seen.append((a, str(e), d)), **kw)
    def flaky():
        calls.append(clock.t)
        if len(calls) <= fail_times:
            err = res.TransientError(f"fail {len(calls)}")
            if len(calls) == 2:
                err.retry_after = 3.0  # a 503's hint
            raise err
        return "ok"

    try:
        out = flaky()
    except res.TransientError as e:
        out = ("raised", str(e))
    return out, slept, seen, calls


@pytest.mark.parametrize("fail_times,kw", [
    (3, dict(retries=5)),
    (9, dict(retries=4)),
    (9, dict(retries=10, max_elapsed=6.0)),
    (2, dict(retries=5, jitter=0.0)),
])
def test_retry_and_backoff_match_jax(fail_times, kw):
    runs = {pkg: _retry_script(res, fail_times, **kw) for pkg, res in PACKAGES.items()}
    assert runs["torch"] == runs["jax"]
    rng_j, rng_t = random.Random(3), random.Random(3)
    for attempt in range(6):
        assert resilience.compute_backoff(attempt, 0.25, 10.0, 0.5, rng_t) == \
            j_resilience.compute_backoff(attempt, 0.25, 10.0, 0.5, rng_j)


def test_retry_lets_other_errors_through():
    calls = []

    @resilience.retry(retries=3, sleep=lambda d: None)
    def broken():
        calls.append(1)
        raise KeyError("not transient")

    with pytest.raises(KeyError):
        broken()
    assert calls == [1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from trlx_tpu_torch.data.default_configs import default_sft_config
    from trlx_tpu_torch.trainer.sft_trainer import SFTTrainer

    tmp = tmp_path_factory.mktemp("client")
    cfg = default_sft_config().evolve(
        model=dict(model_path="random:llama-tiny", model_extra_configs={"dtype": "float32"}),
        tokenizer=dict(tokenizer_path="byte"),
        train=dict(seq_length=64, total_steps=0, tracker=None, batch_size=2,
                   checkpoint_dir=str(tmp / "ckpt"), logging_dir=str(tmp / "logs")),
        inference=dict(kv_paging=True, kv_block_size=8, num_slots=2, max_prompt_len=64, max_new_tokens=6,
                       sessions=True, gen_kwargs=dict(do_sample=False)),
    )
    srv = SFTTrainer(cfg, device="cpu").serve(port=0, background=True)
    yield srv
    srv.shutdown()


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_remote_and_stream_generate(server):
    gen = remote_generate(server.url, timeout=TIMEOUT)
    one = gen([5, 6, 7, 8], max_new_tokens=5)
    assert len(one["token_ids"]) == 5 and one["finish_reason"] == "length"
    many = gen(["ab", "cde", [5, 6, 7, 8]], max_new_tokens=5)
    assert [o["token_ids"] for o in many][2] == one["token_ids"]
    assert many[0]["text"] == _post(server.url, "/generate", {"prompt": "ab", "max_new_tokens": 5})["text"]
    events = list(stream_generate(server.url, [5, 6, 7, 8], timeout=TIMEOUT, max_new_tokens=5))
    assert [t for e in events[:-1] for t in e["token_ids"]] == events[-1]["token_ids"] == one["token_ids"]
    assert gen.client.breaker.state == "closed"


def test_client_retries_503_then_fails_and_4xx_is_not_retried(server):
    sleeps = []
    client = RetryingJSONClient(server.url + "/generate", timeout=TIMEOUT, retries=2, breaker_threshold=1,
                                _sleep=sleeps.append)
    _post(server.url, "/admin/drain", {})
    try:
        with pytest.raises(resilience.TransientError, match="503"):
            client.post({"prompt": "hi"})
        assert len(sleeps) == 2 and all(s >= 1.0 for s in sleeps)  # the server's Retry-After
        assert client.breaker.state == "open"
        with pytest.raises(resilience.CircuitOpenError):
            client.post({"prompt": "hi"})
    finally:
        _post(server.url, "/admin/undrain", {})
    bad = RetryingJSONClient(server.url + "/generate", timeout=TIMEOUT, retries=3, _sleep=sleeps.append)
    with pytest.raises(RuntimeError, match="payload needs"):
        bad.post({"nothing": 1})
    assert len(sleeps) == 2 and bad.breaker.state == "closed"


def test_chat_session_two_turns_and_a_reset(server):
    chat = ChatSession(server.url, timeout=TIMEOUT, _sleep=lambda d: None)
    first = chat.send([10, 11, 12, 13, 14, 15, 16, 17, 18])
    second = chat.send([20, 21])
    assert first["turn"] == 1 and second["turn"] == 2 and second["session_id"] == first["session_id"]
    assert second["retained_hit"]
    transcript = [10, 11, 12, 13, 14, 15, 16, 17, 18] + first["token_ids"] + [20, 21]
    assert second["token_ids"] == _post(server.url, "/generate", {"prompt_ids": transcript})["token_ids"]
    # the server drops the session's state (as a weight swap does): the
    # client re-creates it from its transcript, transparently
    server.engine.session_store.invalidate_all("weights_updated")
    third = chat.send([30])
    assert chat.resets == 1 and third["turn"] == 1 and third["session_id"] != first["session_id"]
    transcript += second["token_ids"] + [30]
    assert third["token_ids"] == _post(server.url, "/generate", {"prompt_ids": transcript})["token_ids"]
