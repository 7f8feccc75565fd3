"""HTTP front end for the continuous-batching engine.

Port of the JAX package's `inference/server.py` for the serving slice:
`POST /generate` (one prompt, or `n` completions of it, with optional
stop strings), `GET /healthz` (liveness/readiness + paged-pool
occupancy), `GET /metrics` (Prometheus text) and `GET /debug/slo`
(`/debug/trace` too when tracing is on).

Not ported yet, answered with HTTP 501: token streaming (`"stream"`),
`POST /chat` sessions and the `/admin/*` surface (drain, reload,
adapters); checkpoint watch/reload raises at construction (ROADMAP queue
A, serving features).
"""

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from trlx_tpu_torch.inference.metrics import dedupe_metadata
from trlx_tpu_torch.inference.scheduler import DrainingError, QueueFullError, Scheduler
from trlx_tpu_torch.observability.slo import SLOEngine
from trlx_tpu_torch.observability.tracing import new_id
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

NOT_PORTED = "not ported yet (ROADMAP queue A, serving features)"


class InferenceServer:
    """Serve a `Scheduler` (and its engine) over HTTP."""

    def __init__(
        self,
        scheduler: Scheduler,
        tokenizer=None,
        host: str = "0.0.0.0",
        port: int = 8600,
        watch_dir: Optional[str] = None,
        tracer=None,
        slos=None,
    ):
        if watch_dir:
            raise NotImplementedError(f"checkpoint watch/reload is {NOT_PORTED}")
        self.scheduler = scheduler
        self.engine = scheduler.engine
        self.metrics = scheduler.metrics
        self.slo = SLOEngine(slos=slos, recorder=getattr(scheduler, "recorder", None))
        self.tracer = tracer if tracer is not None else getattr(scheduler, "tracer", None)
        self.tokenizer = tokenizer
        if tokenizer is not None and getattr(scheduler, "detokenize", None) is None:
            # stop-sequence scanning needs id->text
            scheduler.detokenize = lambda ids: tokenizer.decode(list(ids))
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._shutdown_done = False

    @property
    def ready(self) -> bool:
        """Readiness: the engine holds weights and the scheduler is not in
        reject-new drain mode."""
        return self.engine.has_params and self.scheduler.accepting

    # ------------------------------------------------------------------

    def _encode_prompt(self, payload: Dict, truncate: bool = True) -> np.ndarray:
        if "prompt_ids" in payload:
            return np.asarray(payload["prompt_ids"], np.int32).reshape(-1)
        if "prompt" in payload:
            if self.tokenizer is None:
                raise ValueError("server has no tokenizer; send prompt_ids")
            ids = np.asarray(
                self.tokenizer.encode(str(payload["prompt"])), np.int32
            )
            # /chat never truncates: silently dropping leading tokens
            # would desync the turn from the session's retained history
            return ids[-self.engine.max_prompt_len :] if truncate else ids
        raise ValueError("payload needs 'prompt' or 'prompt_ids'")

    @staticmethod
    def _parse_stop(payload: Dict) -> Optional[List[str]]:
        stop = payload.get("stop")
        if stop is None:
            return None
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list):
            raise ValueError("'stop' must be a string or a list of strings")
        return [str(s) for s in stop]

    def _handle_generate(self, payload: Dict,
                         request_id: Optional[str] = None) -> Dict:
        ids = self._encode_prompt(payload)
        unsupported = set(payload) - {
            "prompt", "prompt_ids", "max_new_tokens", "deadline_s", "n",
            "adapter_id", "trace_id", "stop", "stream",
        }
        if unsupported:
            raise ValueError(
                f"unsupported request keys {sorted(unsupported)}; sampling "
                "knobs are fixed at server start (inference.gen_kwargs)"
            )
        n = int(payload.get("n", 1))
        adapter_id = payload.get("adapter_id")
        stop = self._parse_stop(payload)
        tracer = self.tracer
        traces = None
        if tracer is not None:
            # trace_id arrives from the router (payload or X-Trace-Id
            # header, merged by the handler); absent = locally originated
            trace_id = payload.get("trace_id")
            traces = [
                tracer.new_trace(trace_id=trace_id, request_id=request_id)
                for _ in range(n)
            ]
        if n == 1:
            reqs = [self.scheduler.submit(
                ids,
                max_new_tokens=payload.get("max_new_tokens"),
                deadline_s=payload.get("deadline_s"),
                adapter_id=adapter_id,
                request_id=request_id,
                trace=(traces[0] if traces else None),
                stop_sequences=stop,
            )]
        else:
            # GRPO-style fan-out: one prompt, n independent completions —
            # enqueued adjacently so a paged engine shares the prompt's
            # KV blocks across the whole group (one full prefill)
            reqs = self.scheduler.submit_n(
                ids, n,
                max_new_tokens=payload.get("max_new_tokens"),
                deadline_s=payload.get("deadline_s"),
                adapter_id=adapter_id,
                request_id=request_id,
                traces=traces,
                stop_sequences=stop,
            )
        for req in reqs:
            req.wait()
        # anchor the serialize span at the scheduler's finish timestamp
        # (the decode span's end) so the handler wake-up latency is
        # attributed to the reply handoff instead of an untraced gap
        t_ser0 = 0.0
        if traces is not None:
            t_ser0 = min(
                (r.finish_time for r in reqs if r.finish_time is not None),
                default=time.monotonic(),
            )
        step = None  # checkpoint reload is not ported: no step to report

        def seq(req):
            out = {
                "id": req.id,
                "token_ids": req.token_ids,
                "token_logprobs": req.token_logprobs,
                "finish_reason": req.finish_reason,
                "latency_s": req.latency_s,
                "ttft_s": req.ttft_s,
                # which weights produced this rollout — routers enforce
                # the staleness bound per-reply, not just per-probe
                "checkpoint_step": step,
            }
            if request_id is not None:
                out["request_id"] = request_id
            if req.finish_reason not in ("eos", "length", "stop"):
                # which pipeline stage the request died in — the 504
                # body surfaces this (satellite: stage attribution)
                out["stage"] = req.stage
            if self.tokenizer is not None:
                out["text"] = self.tokenizer.decode(req.token_ids)
            return out

        if n == 1:
            out = seq(reqs[0])
            if traces is not None:
                # reply-build time (incl. detokenization); the final
                # json.dumps + socket write is sub-ms and not covered
                traces[0].add("serialize", t_ser0, time.monotonic())
                out["trace_id"] = traces[0].trace_id
                out["trace"] = traces[0].to_dict()["spans"]
            return out
        reasons = [r.finish_reason for r in reqs]
        if "error" in reasons:
            worst = "error"
        elif "shutdown" in reasons:
            worst = "shutdown"
        elif "deadline" in reasons:
            worst = "deadline"
        else:
            worst = reasons[0]
        result = {
            "n": n,
            "sequences": [seq(r) for r in reqs],
            "finish_reason": worst,
            "checkpoint_step": step,
        }
        if request_id is not None:
            result["request_id"] = request_id
        if worst not in ("eos", "length", "stop"):
            bad = next(r for r in reqs if r.finish_reason == worst)
            result["stage"] = bad.stage
        if traces is not None:
            t_ser1 = time.monotonic()
            merged = []
            for tr in traces:
                tr.add("serialize", t_ser0, t_ser1)
                merged.extend(tr.to_dict()["spans"])
            result["trace_id"] = traces[0].trace_id
            result["trace"] = merged
        return result

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes, content_type: str = "application/json",
                       headers: Optional[Dict[str, str]] = None):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, obj: Dict, headers=None):
                self._reply(code, json.dumps(obj).encode(), headers=headers)

            def do_POST(self):  # noqa: N802
                path = self.path.rstrip("/")
                if path.startswith("/admin/") or path == "/chat":
                    self._reply_json(501, {"error": f"{path} is {NOT_PORTED}"})
                    return
                if path not in ("", "/generate"):
                    self.send_error(404)
                    return
                # every request gets an id at ingress (client-supplied or
                # fresh), echoed in the reply and every error body
                rid = self.headers.get("X-Request-Id") or new_id()
                self._rid = rid
                logging.set_trace_context(request_id=rid)
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if payload.get("stream"):
                        self._reply_json(501, {"error": f"token streaming is {NOT_PORTED}",
                                               "request_id": rid})
                        return
                    if "trace_id" not in payload:
                        hdr_tid = self.headers.get("X-Trace-Id")
                        if hdr_tid:
                            payload["trace_id"] = hdr_tid
                    result = server._handle_generate(payload, request_id=rid)
                except QueueFullError as e:
                    self._reply_json(
                        503,
                        {"error": "queue full, retry later", "queue_depth": e.depth,
                         "request_id": rid},
                        headers={"Retry-After": str(max(1, int(e.retry_after)))},
                    )
                    return
                except DrainingError as e:
                    self._reply_json(
                        503,
                        {"error": "server draining, retry elsewhere", "request_id": rid},
                        headers={"Retry-After": str(max(1, int(e.retry_after)))},
                    )
                    return
                except (ValueError, TypeError) as e:
                    self._reply_json(400, {"error": str(e), "request_id": rid})
                    return
                except NotImplementedError as e:
                    self._reply_json(501, {"error": str(e), "request_id": rid})
                    return
                except Exception as e:  # surface engine errors to the client
                    self._reply_json(500, {"error": repr(e), "request_id": rid})
                    return
                if result["finish_reason"] == "error":
                    self._reply_json(500, {"error": f"engine failed: {server.scheduler.failure!r}", **result})
                elif result["finish_reason"] == "deadline":
                    self._reply_json(504, {"error": "deadline exceeded", **result})
                elif result["finish_reason"] == "shutdown":
                    self._reply_json(503, {"error": "server shutting down", "request_id": rid})
                else:
                    self._reply_json(200, result)

            def do_GET(self):  # noqa: N802
                path = self.path.rstrip("/")
                if path.split("?")[0] == "/debug/trace":
                    if server.tracer is None:
                        self._reply_json(404, {"error": "tracing is off (set inference.tracing)"})
                        return
                    query = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
                    try:
                        last = int(query.get("last", ["32"])[0])
                    except ValueError:
                        last = 32
                    self._reply_json(200, {"traces": server.tracer.recent(last)})
                    return
                if path == "/debug/slo":
                    server.slo.ingest_registry(server.metrics)
                    self._reply_json(200, server.slo.evaluate())
                    return
                if path == "/metrics":
                    server.slo.ingest_registry(server.metrics)
                    text = dedupe_metadata(
                        server.metrics.render()
                        + server.slo.render_prometheus(ns="trlx_tpu_inference")
                    )
                    self._reply(200, text.encode(), content_type="text/plain; version=0.0.4")
                    return
                if path in ("", "/healthz"):
                    ready = server.ready
                    kv = server.engine.kv_stats()
                    self._reply_json(200, {
                        "status": "ok" if ready else "degraded",
                        "live": True,
                        "ready": ready,
                        "reloading": False,
                        "draining": not server.scheduler.accepting,
                        "slots_total": server.engine.num_slots,
                        "slots_active": server.engine.active_slots,
                        "queue_depth": int(server.metrics.get("queue_depth")),
                        "param_version": server.engine.param_version,
                        "checkpoint_step": None,
                        "reloads": 0,
                        **({"kv": kv} if kv else {}),
                    })
                    return
                self.send_error(404)

            def log_message(self, fmt, *args):
                msg = fmt % args
                rid = getattr(self, "_rid", None)
                if rid is not None:
                    msg = f"{msg} request_id={rid}"
                logger.debug("inference-server: " + msg)

        return Handler

    # ------------------------------------------------------------------

    def _bind(self) -> None:
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._shutdown_done = False
        self.scheduler.start()

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host == "0.0.0.0" else self.host
        return f"http://{host}:{self.port}"

    def start_background(self) -> str:
        """Start serving on a daemon thread; returns the base URL."""
        self._bind()
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info(f"Inference server listening on {self.url}")
        return self.url

    def serve(self) -> None:
        """Blocking serve (the standalone policy-server process)."""
        self._bind()
        logger.info(f"Inference server listening on :{self.port}")
        try:
            self._httpd.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self, drain_s: float = 0.0) -> None:
        """Stop serving. With `drain_s > 0` the scheduler first finishes
        in-flight requests (reject-new) so they reply before the listener
        closes; with 0 they finish as "shutdown"."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        if drain_s > 0:
            self.scheduler.reject_new()
            if not self.scheduler.wait_idle(drain_s):
                logger.warning(
                    f"shutdown: drain timed out after {drain_s}s; "
                    "remaining requests will finish as 'shutdown'"
                )
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.scheduler.stop()
