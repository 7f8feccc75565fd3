"""Shared fault-tolerant HTTP JSON client.

Port of the JAX package's `utils/http.py` (plain Python, copied so the
port imports nothing of that package). The policy inference client
(`trlx_tpu_torch.inference.client`) sits on it; the reward client will
when reward serving is ported (ROADMAP queue A, item 4).

Error taxonomy (single source of truth, mirrored from the reward
client's original classification):

- transport failures — connection refused/reset, timeouts, dropped
  connections mid-response, truncated JSON bodies — raise
  `resilience.TransientError` and are retried with exponential backoff
  + jitter;
- HTTP 502/503/504 (and any 5xx carrying the fault-injector's
  "injected transient" marker) are treated as transient too: they are
  what a restarting or backpressuring server answers;
- any other HTTP error, and a 200 body containing an ``error`` key,
  is an application failure: it propagates immediately as RuntimeError
  (retrying user-code bugs only hides them).

After `breaker_threshold` consecutive transport failures the circuit
breaker opens and calls fail fast (`resilience.CircuitOpenError`) for
`breaker_recovery` seconds; callers can catch it to degrade (the reward
client's fallback-to-mean path).
"""

import json
from typing import Callable, Optional

from trlx_tpu_torch import resilience
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

#: 5xx statuses a healthy-but-overloaded/restarting server legitimately
#: answers; anything else in the 5xx range is an application error.
TRANSIENT_HTTP_CODES = (502, 503, 504)


class RetryingJSONClient:
    """POST JSON payloads to one endpoint with retries + circuit breaking.

    `post(payload)` returns the parsed response dict, raising
    `resilience.TransientError` once retries are exhausted,
    `resilience.CircuitOpenError` when the breaker is open, and
    `RuntimeError` for application errors. The breaker is public so
    callers can inspect `client.breaker.state` for degrade decisions.
    """

    def __init__(
        self,
        url: str,
        timeout: float = 120.0,
        retries: int = 4,
        retry_base_delay: float = 0.25,
        retry_max_delay: float = 10.0,
        retry_max_elapsed: Optional[float] = None,
        breaker_threshold: int = 8,
        breaker_recovery: float = 30.0,
        error_label: str = "server",
        _sleep: Optional[Callable[[float], None]] = None,
    ):
        self.url = url
        self.timeout = timeout
        self.error_label = error_label
        self.breaker = resilience.CircuitBreaker(
            failure_threshold=breaker_threshold, recovery_time=breaker_recovery
        )
        retry_kwargs = dict(
            retries=retries,
            base_delay=retry_base_delay,
            max_delay=retry_max_delay,
            max_elapsed=retry_max_elapsed,
            retry_on=(resilience.TransientError,),
        )
        if _sleep is not None:  # deterministic tests inject a fake sleep
            retry_kwargs["sleep"] = _sleep
        self._retried_call = resilience.retry(**retry_kwargs)(self._raw_call)

    def _raw_call(self, payload: dict) -> dict:
        import http.client
        import urllib.error
        import urllib.request

        label = self.error_label
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code >= 500:
                try:
                    detail = json.loads(e.read()).get("error", str(e))
                except Exception:
                    detail = str(e)
                if "injected transient" in str(detail) or e.code in TRANSIENT_HTTP_CODES:
                    err = resilience.TransientError(f"{label} {e.code}: {detail}")
                    # a 503's Retry-After is the server's own backoff hint
                    # (computed from queue depth) — `resilience.retry`
                    # prefers it over the local schedule when present
                    hint = e.headers.get("Retry-After") if e.headers else None
                    if hint is not None:
                        try:
                            err.retry_after = float(hint)
                        except ValueError:
                            pass  # HTTP-date form: fall back to local backoff
                    raise err from e
                raise RuntimeError(f"{label} error: {detail}") from e
            # 4xx: surface the server's own error detail (clients key off
            # it — e.g. ChatSession re-creates on "reset" messages)
            try:
                detail = json.loads(e.read()).get("error", str(e))
            except Exception:
                detail = str(e)
            raise RuntimeError(f"{label} error: {detail}") from e
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
            raise resilience.TransientError(f"{label} unreachable: {e}") from e
        except http.client.HTTPException as e:
            # dropped connection mid-response (RemoteDisconnected,
            # IncompleteRead, BadStatusLine) — transport-level, retryable
            raise resilience.TransientError(f"{label} dropped connection: {e}") from e
        except json.JSONDecodeError as e:
            # truncated body from a dying server — retryable
            raise resilience.TransientError(f"{label} short read: {e}") from e
        if isinstance(out, dict) and "error" in out:
            raise RuntimeError(f"{label} error: {out['error']}")
        return out

    def post(self, payload: dict) -> dict:
        """One call through breaker + retries. Breaker bookkeeping happens
        here; `CircuitOpenError` is raised before touching the network."""
        self.breaker.check()
        try:
            out = self._retried_call(payload)
        except resilience.TransientError:
            self.breaker.record_failure()
            raise
        self.breaker.record_success()
        return out
