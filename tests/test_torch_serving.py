"""The port's reward-model server and client (trlx_tpu_torch/serving.py),
mirroring the JAX package's tests/test_serving.py case for case (round
trip, metadata, client-side batching, dense scores, a scoring error as
500, injected 5xx and drops, the breaker, the cached mean), then the wire
both ways: the port's client against the JAX server and the JAX client
against the port's server must return the same scores.
"""

import numpy as np
import pytest

from trlx_tpu import serving as j_serving
from trlx_tpu_torch.serving import RewardModelServer, remote_reward_fn


@pytest.fixture
def server():
    def reward(samples, prompts=None, outputs=None, **metadata):
        base = [float(len(s)) for s in samples]
        if metadata.get("bonus"):
            base = [b + float(x) for b, x in zip(base, metadata["bonus"])]
        return base

    srv = RewardModelServer(reward, host="127.0.0.1", port=0)
    url = srv.start_background()
    yield url
    srv.shutdown()


def test_round_trip(server):
    fn = remote_reward_fn(server)
    scores = fn(["ab", "abcd"], prompts=["a", "a"], outputs=["b", "bcd"])
    assert scores == [2.0, 4.0]


def test_metadata_passthrough(server):
    fn = remote_reward_fn(server)
    scores = fn(["ab", "abcd"], bonus=[10, 20])
    assert scores == [12.0, 24.0]


def test_client_side_batching(server):
    fn = remote_reward_fn(server, batch_size=2)
    samples = ["x" * i for i in range(1, 8)]
    assert fn(samples, prompts=["p"] * 7, outputs=["o"] * 7) == [float(i) for i in range(1, 8)]


def test_dense_scores_pass_through():
    def dense_reward(samples, **kw):
        return [np.asarray([0.1] * len(s), dtype=np.float32) for s in samples]

    srv = RewardModelServer(dense_reward, host="127.0.0.1", port=0)
    url = srv.start_background()
    try:
        fn = remote_reward_fn(url)
        scores = fn(["ab", "abc"])
        assert [len(s) for s in scores] == [2, 3]
    finally:
        srv.shutdown()


def test_server_error_propagates(server):
    def boom(samples, **kw):
        raise RuntimeError("reward model fell over")

    srv = RewardModelServer(boom, host="127.0.0.1", port=0)
    url = srv.start_background()
    try:
        with pytest.raises(RuntimeError, match="reward server error"):
            remote_reward_fn(url)(["a"])
    finally:
        srv.shutdown()


def _len_reward(samples, prompts=None, outputs=None, **metadata):
    return [float(len(s)) for s in samples]


def test_reward_client_survives_injected_5xx():
    """30% injected 5xx rate: the retrying client still returns correct
    scores for every request."""
    from trlx_tpu_torch.resilience import FaultInjector

    inj = FaultInjector(rate=0.3, seed=7, mode="http_500")
    srv = RewardModelServer(_len_reward, host="127.0.0.1", port=0, fault_injector=inj)
    url = srv.start_background()
    try:
        fn = remote_reward_fn(url, retries=6, retry_base_delay=0.001,
                              retry_max_delay=0.01, _sleep=lambda s: None)
        for _ in range(10):
            assert fn(["ab", "abcd"]) == [2.0, 4.0]
        assert inj.injected > 0  # faults actually fired
    finally:
        srv.shutdown()


def test_reward_client_survives_injected_drops_and_5xx():
    """Mixed faults — dropped connections AND 5xx — at a 30% rate."""
    from trlx_tpu_torch.resilience import FaultInjector

    inj = FaultInjector(rate=0.3, seed=11, mode="mixed")
    srv = RewardModelServer(_len_reward, host="127.0.0.1", port=0, fault_injector=inj)
    url = srv.start_background()
    try:
        fn = remote_reward_fn(url, retries=8, retry_base_delay=0.001,
                              retry_max_delay=0.01, _sleep=lambda s: None)
        scores = []
        for _ in range(10):
            scores.extend(fn(["ab", "abcd"]))
        assert scores == [2.0, 4.0] * 10
        assert inj.injected > 0
    finally:
        srv.shutdown()


def test_reward_client_circuit_breaker_opens():
    """After the configured consecutive-failure threshold the breaker
    opens and subsequent calls fail fast without touching the server."""
    from trlx_tpu_torch.resilience import CircuitOpenError, FaultInjector, TransientError

    inj = FaultInjector(rate=1.0, mode="http_500")  # server always fails
    srv = RewardModelServer(_len_reward, host="127.0.0.1", port=0, fault_injector=inj)
    url = srv.start_background()
    try:
        fn = remote_reward_fn(url, retries=0, breaker_threshold=3,
                              breaker_recovery=60.0, _sleep=lambda s: None)
        for _ in range(3):
            with pytest.raises(TransientError):
                fn(["a"])
        requests_before = inj._calls
        with pytest.raises(CircuitOpenError):
            fn(["a"])
        assert inj._calls == requests_before  # failed fast, no HTTP request
    finally:
        srv.shutdown()


def test_reward_client_degrades_to_cached_mean():
    """With fallback_to_mean, an open breaker returns the running mean of
    previously-successful scores instead of killing the rollout."""
    from trlx_tpu_torch.resilience import FaultInjector

    srv = RewardModelServer(_len_reward, host="127.0.0.1", port=0)
    url = srv.start_background()
    try:
        fn = remote_reward_fn(url, retries=0, breaker_threshold=2,
                              breaker_recovery=60.0, fallback_to_mean=True,
                              _sleep=lambda s: None)
        assert fn(["ab", "abcd"]) == [2.0, 4.0]  # healthy: mean becomes 3.0
        srv.fault_injector = FaultInjector(rate=1.0, mode="http_500")
        # below the threshold transient failures still propagate
        from trlx_tpu_torch.resilience import TransientError

        with pytest.raises(TransientError):
            fn(["xyz"])
        # the threshold-crossing failure opens the breaker: degrade to mean
        assert fn(["xyz"]) == [3.0]
        # breaker open: no server round-trip, still the cached mean
        assert fn(["xyz", "q"]) == [3.0, 3.0]
    finally:
        srv.shutdown()


def _wire_reward(samples, prompts=None, outputs=None, **metadata):
    """Scalar or dense by sample, and metadata-dependent."""
    out = []
    for i, s in enumerate(samples):
        if s.startswith("d"):
            out.append(np.arange(len(s), dtype=np.float32) * 0.5)
        else:
            out.append(float(len(s)) + float(metadata.get("bonus", [0] * len(samples))[i]))
    return out


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_wire_compatibility_both_ways(direction):
    server_cls = j_serving.RewardModelServer if direction == "port_client_jax_server" else RewardModelServer
    client = remote_reward_fn if direction == "port_client_jax_server" else j_serving.remote_reward_fn
    other = j_serving.remote_reward_fn if client is remote_reward_fn else remote_reward_fn
    srv = server_cls(_wire_reward, host="127.0.0.1", port=0)
    url = srv.start_background()
    try:
        samples = ["abc", "dense", "x", "dd"]
        kw = dict(prompts=["p"] * 4, outputs=["o"] * 4, bonus=np.array([1, 2, 3, 4]))
        got = client(url, batch_size=3)(samples, **kw)
        want = other(url)(samples, **kw)
        local = _wire_reward(samples, bonus=[1, 2, 3, 4])
        assert got == want
        for g, w in zip(got, local):
            np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))
    finally:
        srv.shutdown()
