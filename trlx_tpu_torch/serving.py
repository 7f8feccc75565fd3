"""Reward-model serving: a remote scoring service and its client.

Port of the JAX package's `serving.py` (plain Python and numpy, copied
so the port imports nothing of that package; the wire format is the
same, so either package's client talks to either package's server). The
trainers keep the pluggable `reward_fn(samples, prompts, outputs,
**metadata)` contract; `RewardModelServer` runs any such callable (a
reward model on its own card, `models/reward.py:make_reward_fn`) behind
HTTP JSON, and `remote_reward_fn(url)` is a `reward_fn` that scores
through it.

Server:   python -m trlx_tpu_torch.serving  (toy length reward on :8500)
          or RewardModelServer(reward_fn, port=8500).serve()
Client:   trlx_tpu_torch.train(reward_fn=remote_reward_fn("http://host:8500"), ...)
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np

from trlx_tpu_torch import resilience
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


class RewardModelServer:
    """Serve a reward_fn over HTTP POST /score.

    Request JSON:  {"samples": [...], "prompts": [...], "outputs": [...],
                    ...metadata}
    Response JSON: {"scores": [...]} — each score a float or a list of
    per-token floats (dense rewards pass through unchanged).

    `fault_injector` (resilience.FaultInjector) deterministically injects
    transient failures — 5xx responses or dropped connections — for
    testing the client's retry/circuit-breaker path.
    """

    def __init__(
        self,
        reward_fn: Callable,
        host: str = "0.0.0.0",
        port: int = 8500,
        fault_injector: Optional["resilience.FaultInjector"] = None,
    ):
        self.reward_fn = reward_fn
        self.host = host
        self.port = port
        self.fault_injector = fault_injector
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _make_handler(self):
        reward_fn = self.reward_fn
        server = self  # live reference: tests can swap fault_injector mid-run

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                if self.path.rstrip("/") not in ("", "/score", "/v2/score"):
                    self.send_error(404)
                    return
                injector = server.fault_injector
                if injector is not None and injector.should_fail():
                    mode = injector.mode
                    if mode == "mixed":  # alternate 5xx / dropped connection
                        mode = "drop" if injector.injected % 2 else "http_500"
                    if mode == "drop":
                        # read the request then slam the connection shut —
                        # the client sees a reset/short read, not an HTTP
                        # status
                        self.close_connection = True
                        try:
                            self.connection.close()
                        except OSError:
                            pass
                        return
                    body = b'{"error": "injected transient failure"}'
                    self.send_response(503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    samples = payload.pop("samples")
                    scores = reward_fn(samples=samples, **payload)
                    scores = [
                        np.asarray(s, dtype=np.float32).tolist() if np.ndim(s) else float(s)
                        for s in scores
                    ]
                    body = json.dumps({"scores": scores}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as e:  # surface scoring errors to the client
                    body = json.dumps({"error": repr(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

            def do_GET(self):  # noqa: N802  (health check)
                body = b'{"status": "ok"}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("reward-server: " + fmt % args)

        return Handler

    def start_background(self) -> str:
        """Start serving on a daemon thread; returns the base URL."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        url = f"http://{'127.0.0.1' if self.host == '0.0.0.0' else self.host}:{self.port}"
        logger.info(f"Reward server listening on {url}")
        return url

    def serve(self):
        """Blocking serve (the standalone reward-model process)."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        logger.info(f"Reward server listening on :{self.port}")
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def remote_reward_fn(
    url: str,
    timeout: float = 120.0,
    batch_size: int = 0,
    retries: int = 4,
    retry_base_delay: float = 0.25,
    retry_max_delay: float = 10.0,
    retry_max_elapsed: Optional[float] = None,
    breaker_threshold: int = 8,
    breaker_recovery: float = 30.0,
    fallback_to_mean: bool = False,
    _sleep: Optional[Callable[[float], None]] = None,
) -> Callable:
    """A reward_fn that scores through a RewardModelServer, with optional
    client-side batching for large rollout chunks.

    Fault tolerance: the transport sits on the shared retry/circuit-
    breaker HTTP stack (`trlx_tpu_torch.utils.http.RetryingJSONClient`,
    also under `remote_generate`) — transient failures (connection drops,
    timeouts, HTTP 502/503/504) are retried with exponential backoff +
    jitter instead of killing the PPO run; scoring errors raised by the
    reward_fn itself (HTTP 500 with an ``error`` payload from user code,
    4xx) stay fatal. After `breaker_threshold` consecutive transport
    failures the circuit breaker opens and calls fail fast for
    `breaker_recovery` seconds; with `fallback_to_mean` an open breaker
    degrades to the running mean of previously returned scores (zero
    before any success) so a rollout batch still completes while the
    reward server restarts.
    """
    from trlx_tpu_torch.utils.http import RetryingJSONClient

    client = RetryingJSONClient(
        url.rstrip("/") + "/score",
        timeout=timeout,
        retries=retries,
        retry_base_delay=retry_base_delay,
        retry_max_delay=retry_max_delay,
        retry_max_elapsed=retry_max_elapsed,
        breaker_threshold=breaker_threshold,
        breaker_recovery=breaker_recovery,
        error_label="reward server",
        _sleep=_sleep,
    )
    # running mean of every scalar score successfully returned, for the
    # degrade path once the breaker opens
    score_stats = {"sum": 0.0, "count": 0}

    def cached_mean(n: int, why: str) -> List:
        mean = score_stats["sum"] / max(score_stats["count"], 1)
        logger.warning_once(
            f"{why}: degrading to cached mean score ({mean:.4f}) until the "
            "reward server recovers"
        )
        return [mean] * n

    def call(payload: dict) -> List:
        try:
            scores = client.post(payload)["scores"]
        except resilience.CircuitOpenError:
            if not fallback_to_mean:
                raise
            return cached_mean(len(payload["samples"]), "Reward-server circuit open")
        except resilience.TransientError:
            if fallback_to_mean and client.breaker.state != "closed":
                return cached_mean(
                    len(payload["samples"]), "Reward server unreachable after retries"
                )
            raise
        for s in scores:
            if np.ndim(s) == 0:
                score_stats["sum"] += float(s)
                score_stats["count"] += 1
        return scores

    def reward_fn(samples: List[str], prompts=None, outputs=None, tokenizer=None, **metadata):
        payload_meta = {
            k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in metadata.items()
        }
        base = dict(payload_meta)
        if prompts is not None:
            base["prompts"] = list(prompts)
        if outputs is not None:
            base["outputs"] = list(outputs)

        if not batch_size or len(samples) <= batch_size:
            return call({**base, "samples": list(samples)})
        scores: List = []
        for i in range(0, len(samples), batch_size):
            sub = {
                k: v[i : i + batch_size] if isinstance(v, list) and len(v) == len(samples) else v
                for k, v in base.items()
            }
            scores.extend(call({**sub, "samples": list(samples[i : i + batch_size])}))
        return scores

    return reward_fn


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Serve a toy reward model")
    parser.add_argument("--port", type=int, default=8500)
    args = parser.parse_args()

    def toy_reward(samples, **kwargs):
        return [float(len(s)) / 100.0 for s in samples]

    RewardModelServer(toy_reward, port=args.port).serve()


if __name__ == "__main__":
    main()
