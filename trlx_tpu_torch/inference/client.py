"""Remote generation client.

Port of the JAX package's `inference/client.py` (plain Python).
`remote_generate(url)` is a callable backed by the retry/circuit-breaker
HTTP stack (`trlx_tpu_torch.utils.http.RetryingJSONClient`), so the server's 503
backpressure answers (Retry-After) and transient transport failures are
retried with backoff instead of surfacing to the caller, and a dead
server trips the breaker to fail fast.

`ChatSession` is the client half of the server's session layer: it
holds the `session_id` and a local transcript of the conversation, so
a `409 session_reset` (TTL expiry, weight hot-swap, replica failover)
is recovered transparently by re-creating the session from the full
history — the one thing the server, which dropped the state, cannot do.

`sse_stream` / `stream_generate` read the server's token-streaming
(SSE) responses: each yielded dict is one `data:` event; the last one
carries `"event": "done"` plus the full non-streaming reply body.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Union

from trlx_tpu_torch.utils.http import RetryingJSONClient


def remote_generate(
    url: str,
    timeout: float = 300.0,
    retries: int = 4,
    retry_base_delay: float = 0.25,
    retry_max_delay: float = 10.0,
    retry_max_elapsed: Optional[float] = None,
    breaker_threshold: int = 8,
    breaker_recovery: float = 30.0,
    concurrency: int = 8,
    _sleep: Optional[Callable[[float], None]] = None,
) -> Callable:
    """Build a client for an `InferenceServer`.

    The returned callable accepts one prompt (str or token-id list) or a
    list of prompts; lists fan out over `concurrency` threads — the
    server's continuous batching turns the concurrent singles into one
    shared decode batch. Per-call kwargs: `max_new_tokens`, `deadline_s`,
    and — against a multi-tenant server — `adapter_id` (which LoRA
    adapter decodes the request; omitted = the base policy; requests for
    different adapters still share every decode step server-side).
    Returns the response dict (or list of dicts): `text` (when the
    server has a tokenizer), `token_ids`, `finish_reason`, `latency_s`.
    """
    client = RetryingJSONClient(
        url.rstrip("/") + "/generate",
        timeout=timeout,
        retries=retries,
        retry_base_delay=retry_base_delay,
        retry_max_delay=retry_max_delay,
        retry_max_elapsed=retry_max_elapsed,
        breaker_threshold=breaker_threshold,
        breaker_recovery=breaker_recovery,
        error_label="inference server",
        _sleep=_sleep,
    )

    def one(prompt: Union[str, List[int]], **kwargs) -> Dict:
        payload = dict(kwargs)
        if isinstance(prompt, str):
            payload["prompt"] = prompt
        else:
            payload["prompt_ids"] = list(map(int, prompt))
        return client.post(payload)

    def generate(prompts, **kwargs):
        if isinstance(prompts, str) or (
            isinstance(prompts, (list, tuple))
            and prompts
            and isinstance(prompts[0], int)
        ):
            return one(prompts, **kwargs)
        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            return list(pool.map(lambda p: one(p, **kwargs), prompts))

    generate.client = client  # expose breaker state for callers/tests
    return generate


# ----------------------------------------------------------------------
# Token streaming (SSE)
# ----------------------------------------------------------------------


def sse_stream(url: str, payload: Dict, timeout: float = 300.0) -> Iterator[Dict]:
    """POST `payload` with ``"stream": true`` and yield each SSE
    ``data:`` event as a dict. The connection closes after the final
    ``"event": "done"`` event (HTTP/1.0 close-delimited body). Raises
    `urllib.error.HTTPError` on pre-stream refusals (400/409/503) —
    streaming cannot be transparently retried mid-flight, so callers own
    the retry decision."""
    import urllib.request

    body = dict(payload)
    body["stream"] = True
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b"data: "):
                yield json.loads(line[len(b"data: "):])


def stream_generate(
    url: str, prompt: Union[str, List[int]], timeout: float = 300.0, **kwargs
) -> Iterator[Dict]:
    """Stream one completion from ``POST /generate``. Yields
    ``{"token_ids": [...]}`` deltas, then the done event; concatenating
    the deltas' token_ids equals the done event's token_ids bitwise."""
    payload = dict(kwargs)
    if isinstance(prompt, str):
        payload["prompt"] = prompt
    else:
        payload["prompt_ids"] = list(map(int, prompt))
    yield from sse_stream(url.rstrip("/") + "/generate", payload, timeout=timeout)


# ----------------------------------------------------------------------
# Multi-turn chat sessions
# ----------------------------------------------------------------------


class ChatSession:
    """Client handle on one server-side conversation (``POST /chat``).

    Keeps a local transcript so a ``409 session_reset`` — TTL expiry,
    session eviction, checkpoint hot-swap, adapter reload — is recovered
    by re-creating the session from the full history in one request.
    Recovery needs a consistent transcript mode: all-token-id turns
    replay as ids; all-text turns (against a server with a tokenizer)
    replay as concatenated text; mixing both makes a reset fatal.

    One turn at a time per session — the server answers 409
    ``session_busy`` otherwise, which is surfaced, not retried.
    """

    def __init__(
        self,
        url: str,
        adapter_id: Optional[str] = None,
        timeout: float = 300.0,
        retries: int = 4,
        breaker_threshold: int = 8,
        breaker_recovery: float = 30.0,
        _sleep: Optional[Callable[[float], None]] = None,
    ):
        self.url = url.rstrip("/")
        self.adapter_id = adapter_id
        self.timeout = timeout
        self.client = RetryingJSONClient(
            self.url + "/chat",
            timeout=timeout,
            retries=retries,
            breaker_threshold=breaker_threshold,
            breaker_recovery=breaker_recovery,
            error_label="inference server",
            _sleep=_sleep,
        )
        self.session_id: Optional[str] = None
        self.turns = 0
        self.resets = 0  # transparent re-creations after 409 session_reset
        self._ids: List[int] = []  # full id transcript (id-mode recovery)
        self._text = ""  # full text transcript (text-mode recovery)
        self._ids_ok = True
        self._text_ok = True

    # -- payload / transcript bookkeeping ------------------------------

    def _payload(self, turn: Union[str, List[int]], full: bool = False,
                 **kwargs) -> Dict:
        payload = dict(kwargs)
        if self.adapter_id is not None:
            payload["adapter_id"] = self.adapter_id
        if full:
            # session is gone server-side: replay the whole conversation
            # plus this turn as a fresh session
            if self._ids_ok and not isinstance(turn, str):
                payload["prompt_ids"] = self._ids + list(map(int, turn))
            elif self._text_ok and isinstance(turn, str):
                payload["prompt"] = self._text + turn
            else:
                raise RuntimeError(
                    "session reset and local history cannot replay it "
                    "(mixed prompt/prompt_ids turns or no reply text)"
                )
            return payload
        if self.session_id is not None:
            payload["session_id"] = self.session_id
        if isinstance(turn, str):
            payload["prompt"] = turn
        else:
            payload["prompt_ids"] = list(map(int, turn))
        return payload

    def _after_turn(self, turn: Union[str, List[int]], out: Dict) -> None:
        self.session_id = out.get("session_id", self.session_id)
        self.turns = int(out.get("turn", self.turns + 1))
        if isinstance(turn, str):
            self._ids_ok = False
            self._text += turn
        else:
            self._text_ok = False
            self._ids += list(map(int, turn))
        self._ids += list(map(int, out.get("token_ids", [])))
        if "text" in out:
            self._text += out["text"]
        else:
            self._text_ok = False

    # -- turns ---------------------------------------------------------

    def send(self, turn: Union[str, List[int]], **kwargs) -> Dict:
        """One conversation turn; returns the server's reply dict. A 409
        session_reset re-creates the session from the local transcript
        and retries once."""
        try:
            out = self.client.post(self._payload(turn, **kwargs))
        except RuntimeError as e:
            if self.session_id is None or "reset" not in str(e):
                raise
            self.resets += 1
            self.session_id = None
            out = self.client.post(self._payload(turn, full=True, **kwargs))
        self._after_turn(turn, out)
        return out

    def stream(self, turn: Union[str, List[int]], **kwargs) -> Iterator[Dict]:
        """Streaming variant of `send`: yields token-delta events then
        the done event (which also updates the local transcript). No
        automatic reset recovery — the refusal arrives before the stream
        opens, so callers re-drive `stream` after a `send`-style reset
        or simply catch the HTTPError."""
        payload = self._payload(turn, **kwargs)
        done = None
        for event in sse_stream(self.url + "/chat", payload, timeout=self.timeout):
            if event.get("event") == "done":
                done = event
            yield event
        if done is not None:
            self._after_turn(turn, done)
