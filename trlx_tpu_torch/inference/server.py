"""HTTP front end for the continuous-batching engine, with checkpoint
hot-reload.

Port of the JAX package's `inference/server.py`:

- ``POST /generate``: one prompt, or `n` completions of it, with optional
  stop strings and, on a multi-tenant server, the `adapter_id` that
  decodes it (omitted: the base policy); ``"stream": true`` (n = 1)
  answers server-sent events;
- ``POST /chat``: a turn of a multi-turn session whose KV blocks stay
  resident between turns (`inference.sessions`; paged pool only); 409
  when the session was reset or has a turn in flight;
- ``GET /healthz`` (liveness, readiness, pool and session occupancy, the
  served checkpoint step), ``GET /metrics`` (Prometheus text), ``GET
  /debug/slo`` (``/debug/trace`` too when tracing is on);
- ``POST /admin/drain|undrain|reload``: reject-new drain, reopening, and
  a drain-swap to an explicit checkpoint path or the newest in
  `watch_dir`;
- ``GET/POST /admin/adapters`` (multi-tenant serving): GET lists the
  resident and on-disk adapters and the store's counters; POST takes one
  of ``{"load": name}``, ``{"evict": name}``, ``{"reload": name}``. A
  load that finds every slot pinned answers 503 with Retry-After; a
  single-tenant server answers 400, as the JAX server does.

Hot-reload: with `watch_dir` set, a daemon thread polls for the newest
manifest-complete checkpoint of the port's trainer (manifest written
last: a half-written checkpoint is never loaded), drains the scheduler,
swaps the weights into the engine and resumes admission. Only the
checkpoint's tensor-only `model.pt` is read (`torch.load(...,
weights_only=True)`: unpickling runs no code from the file), and with a
`watch_dir` an ``/admin/reload`` path must lie under it.

A `resilience.FaultInjector` set on `fault_injector` (swappable while
the server runs) injects its HTTP faults at the top of every /generate
and /chat request, wedges /healthz for `healthz_hang_s`, and overrides
the reported checkpoint step with `stale_checkpoint_step`.

On a multi-tenant server the watcher also reloads adapters one at a time
(`poll_adapters`, `reload_adapter`): a resident adapter whose checkpoint
under `adapter_dir` moved is drained alone (the other tenants keep
decoding), re-read into its slot of the store, and its salted prefix
blocks flush. ``/healthz`` reports the resident set, which fleet routers
read for adapter affinity.
"""

import json
import os
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from trlx_tpu_torch import resilience
from trlx_tpu_torch.inference.adapters import AdapterCapacityError, AdapterError
from trlx_tpu_torch.resilience import MODEL_FILE
from trlx_tpu_torch.inference.metrics import dedupe_metadata
from trlx_tpu_torch.inference.scheduler import DrainingError, QueueFullError, Scheduler
from trlx_tpu_torch.inference.sessions import SessionBusyError, SessionLimitError, SessionResetError
from trlx_tpu_torch.observability.slo import SLOEngine
from trlx_tpu_torch.observability.tracing import new_id
from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

_GENERATE_KEYS = {
    "prompt", "prompt_ids", "max_new_tokens", "deadline_s", "n",
    "adapter_id", "trace_id", "stop", "stream",
}


class _Listener(ThreadingHTTPServer):
    # a rollout fleet posts a whole chunk at once (128 connections at the
    # chip smoke's): socketserver's listen backlog of 5 would reset some
    request_queue_size = 256


def load_checkpoint_params(directory: str) -> Dict[str, torch.Tensor]:
    """The policy's state dict from a checkpoint of the port's trainer
    (`TorchTrainer.save` writes it alone to `model.pt`), on the CPU. The
    file is read with `weights_only=True`, which refuses any pickled
    object but tensors and plain containers."""
    params = torch.load(os.path.join(directory, MODEL_FILE), map_location="cpu", weights_only=True)
    if not isinstance(params, dict) or not params:
        raise ValueError(f"checkpoint at {directory} holds no policy params")
    return params


class CheckpointWatcher(threading.Thread):
    """Poll `watch_dir` for newer manifest-complete checkpoints and swap
    them into the engine. Truncated or mid-write checkpoints have no
    manifest and are invisible, so a swap is always a complete state.

    With a `scheduler`, each swap drains on sync: admission pauses,
    in-flight requests decode to completion (bounded by
    `drain_timeout_s`), the weights swap, and admission resumes, so no
    request mixes tokens from two checkpoints. `reloading` is True for the
    whole window, which turns the server's readiness off."""

    def __init__(self, engine, watch_dir: Optional[str], interval_s: float = 5.0,
                 metrics=None, scheduler=None, drain_timeout_s: float = 30.0):
        super().__init__(name="trlx-tpu-torch-ckpt-watcher", daemon=True)
        self.engine = engine
        self.watch_dir = watch_dir
        self.interval_s = interval_s
        self.metrics = metrics
        self.scheduler = scheduler
        self.drain_timeout_s = float(drain_timeout_s)
        self.loaded_step: Optional[int] = None
        self.loaded_path: Optional[str] = None
        self._loaded_key = None  # (path, step, wall_time) of the live weights
        self._failed_key = None  # the last checkpoint that failed to load: not retried
        self.reloads = 0
        self.reloading = False  # True while a swap is in flight (readiness off)
        self._reload_lock = threading.Lock()  # poll loop vs /admin/reload
        self._stop = threading.Event()

    def poll_once(self) -> bool:
        """One scan; returns True if a new checkpoint was swapped in."""
        if not self.watch_dir:
            return False  # admin-reload-only watcher
        path = resilience.find_latest_valid_checkpoint(self.watch_dir)
        if path is None:
            return False
        return self.load_path(path)

    def load_path(self, path: str) -> bool:
        """Drain-swap to the manifest-complete checkpoint at `path` (the
        core of `poll_once`, also driven by ``POST /admin/reload``).
        Returns False when `path` is already live or fails to load. The
        weights are read and checked against the engine's before the
        drain, and a checkpoint that failed is not tried again, so a bad
        one neither flaps readiness nor drains the scheduler each poll."""
        path = os.path.realpath(path)
        manifest = resilience.read_manifest(path)
        if manifest is None:
            logger.warning(f"hot-reload: {path} has no complete manifest; refusing")
            return False
        step = int(manifest.get("step", -1))
        # key on (path, step, wall_time): a re-promotion into the same
        # directory name (atomic dir swap) is still picked up
        key = (path, step, manifest.get("wall_time"))
        with self._reload_lock:
            if key in (self._loaded_key, self._failed_key):
                return False
            try:
                params = load_checkpoint_params(path)
                self.engine.check_params(params)
            except Exception as e:
                logger.warning(f"hot-reload: refusing {path}: {e}")
                self._failed_key = key
                return False
            self.reloading = True
            try:
                if self.scheduler is not None:
                    if not self.scheduler.drain(self.drain_timeout_s):
                        logger.warning(
                            "hot-reload: drain timed out after "
                            f"{self.drain_timeout_s}s; swapping with requests in flight"
                        )
                try:
                    self.engine.set_params(params)
                except Exception as e:
                    logger.warning(f"hot-reload: failed to swap in {path}: {e}")
                    self._failed_key = key
                    return False
            finally:
                if self.scheduler is not None:
                    self.scheduler.resume_admission()
                self.reloading = False
            self.loaded_step, self.loaded_path = step, path
            self._loaded_key = key
            self.reloads += 1
        if self.metrics is not None:
            self.metrics.inc("checkpoint_reloads_total")
            self.metrics.set_gauge("checkpoint_step", step)
        logger.info(f"hot-reload: serving checkpoint {path} (step {step})")
        return True

    # -- per-adapter hot-reload (multi-tenant serving) ------------------

    def poll_adapters(self) -> int:
        """Hot-reload every resident adapter whose on-disk checkpoint
        moved, each drained alone (the per-tenant analogue of
        `poll_once`). Returns the number of adapters swapped."""
        store = self.engine.adapter_store
        if store is None:
            return 0
        return sum(1 for name in store.changed() if self.reload_adapter(name))

    def reload_adapter(self, name: str) -> bool:
        """Drain-swap one adapter: that tenant's admission pauses, its
        requests in flight decode to their end, its factors are re-read
        into the same stack slot and its salted prefix blocks flush (their
        K/V was computed under the old factors). Other tenants keep
        decoding throughout. Returns False when the on-disk version
        already matches, the drain timed out or the load failed."""
        store = self.engine.adapter_store
        if self.scheduler is not None and not self.scheduler.drain_tenant(name, self.drain_timeout_s):
            logger.warning(f"adapter hot-reload: drain of '{name}' timed out after "
                           f"{self.drain_timeout_s}s; deferring to the next poll")
            self.scheduler.resume_tenant(name)
            return False
        try:
            try:
                reloaded = store.reload(name)
            except Exception as e:
                logger.warning(f"adapter hot-reload: failed for '{name}': {e}")
                return False
            if reloaded:
                self.engine.flush_adapter_prefixes(name)
                if self.metrics is not None:
                    self.metrics.inc("adapter_reload_events_total", labels={"adapter": str(name)})
                logger.info(f"adapter hot-reload: '{name}' serving new factors")
            return reloaded
        finally:
            if self.scheduler is not None:
                self.scheduler.resume_tenant(name)

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # keep watching
                logger.exception("checkpoint watcher scan failed")
            try:
                self.poll_adapters()
            except Exception:  # keep watching
                logger.exception("adapter watcher scan failed")

    def stop(self) -> None:
        self._stop.set()


class InferenceServer:
    """Serve a `Scheduler` (and its engine) over HTTP."""

    def __init__(
        self,
        scheduler: Scheduler,
        tokenizer=None,
        host: str = "0.0.0.0",
        port: int = 8600,
        watch_dir: Optional[str] = None,
        reload_interval_s: float = 5.0,
        tracer=None,
        slos=None,
        fault_injector: Optional["resilience.FaultInjector"] = None,
        drain_on_term_s: float = 30.0,
    ):
        self.scheduler = scheduler
        # how long the blocking `serve()` lets in-flight requests finish
        # after SIGTERM/SIGINT before it closes
        self.drain_on_term_s = float(drain_on_term_s)
        # read per request, so a test (or a chaos run) may swap it live
        self.fault_injector = fault_injector
        self.engine = scheduler.engine
        self.metrics = scheduler.metrics
        self.slo = SLOEngine(slos=slos, recorder=getattr(scheduler, "recorder", None))
        self.tracer = tracer if tracer is not None else getattr(scheduler, "tracer", None)
        self.tokenizer = tokenizer
        if tokenizer is not None and getattr(scheduler, "detokenize", None) is None:
            # stop-sequence scanning and /chat text replies need id->text
            scheduler.detokenize = lambda ids: tokenizer.decode(list(ids))
        self.host = host
        self.port = port
        # the watcher always exists (it is also the /admin/reload
        # drain-swap); its poll thread starts only with a watch_dir
        self.watcher = CheckpointWatcher(
            self.engine, watch_dir or None, reload_interval_s, self.metrics,
            scheduler=self.scheduler,
        )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._shutdown_done = False

    @property
    def ready(self) -> bool:
        """Readiness (vs liveness): able to take traffic now. The engine
        holds weights, no checkpoint reload is draining or swapping, and
        the scheduler is not in reject-new drain mode."""
        return self.engine.has_params and not self.watcher.reloading and self.scheduler.accepting

    def _effective_checkpoint_step(self) -> Optional[int]:
        """The checkpoint step reported to routers (None until a reload).
        The stale-checkpoint fault overrides it, so a router's staleness
        bound is testable without real stale checkpoints."""
        injector = self.fault_injector
        override = getattr(injector, "stale_checkpoint_step", None) if injector else None
        if override is not None:
            return int(override)
        return self.watcher.loaded_step

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
        unsupported = set(payload) - _GENERATE_KEYS
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
        if n == 1:
            return self._reply_body(reqs[0], traces[0] if traces else None, request_id)
        # anchor the serialize span at the scheduler's finish timestamp
        # (the decode span's end) so the handler wake-up latency is
        # attributed to the reply handoff instead of an untraced gap
        t_ser0 = 0.0
        if traces is not None:
            t_ser0 = min(
                (r.finish_time for r in reqs if r.finish_time is not None),
                default=time.monotonic(),
            )
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
            "sequences": [self._reply_body(r, None, request_id) for r in reqs],
            "finish_reason": worst,
            "checkpoint_step": self._effective_checkpoint_step(),
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

    # ------------------------------------------------------------------
    # Sessions (/chat) and token streaming (SSE)
    # ------------------------------------------------------------------

    def _submit_chat(self, payload: Dict, request_id: Optional[str] = None, stream_q=None):
        """Resolve the session, build the full-conversation prompt and
        submit the turn. Returns ``(req, sess, trace)``. On any submit
        failure the session's busy flag is cleared so the turn can be
        retried."""
        store = self.engine.session_store
        if store is None:
            raise ValueError("sessions are off (start the server with inference.sessions)")
        unsupported = set(payload) - {
            "session_id", "prompt", "prompt_ids", "max_new_tokens",
            "deadline_s", "adapter_id", "stream", "stop", "trace_id",
        }
        if unsupported:
            raise ValueError(
                f"unsupported chat request keys {sorted(unsupported)}; "
                "sampling knobs are fixed at server start (inference.gen_kwargs)"
            )
        turn_ids = self._encode_prompt(payload, truncate=False)
        adapter_id = payload.get("adapter_id")
        session_id = payload.get("session_id")
        if session_id is None:
            # new sessions only through an omitted id: treating an unknown
            # id as "create" would misread delta tokens as a full prompt
            # after an eviction the client did not see
            sess = store.create(adapter_id)
        else:
            sess = store.begin_turn(str(session_id), adapter_id)
        try:
            full_ids = np.concatenate([sess.tokens, turn_ids]) if sess.tokens.size else turn_ids
            trace = None
            if self.tracer is not None:
                trace = self.tracer.new_trace(trace_id=payload.get("trace_id"), request_id=request_id)
            req = self.scheduler.submit(
                full_ids,
                max_new_tokens=payload.get("max_new_tokens"),
                deadline_s=payload.get("deadline_s"),
                adapter_id=adapter_id,
                request_id=request_id,
                trace=trace,
                stop_sequences=self._parse_stop(payload),
                session=sess,
                stream=stream_q,
            )
        except BaseException:
            store.end_turn(sess)
            raise
        return req, sess, trace

    def _reply_body(self, req, trace, request_id: Optional[str], extra: Optional[Dict] = None) -> Dict:
        """A finished request's reply: /generate's (one sequence of it
        when n > 1), the stream's done event, /chat's (with `extra`). With
        a trace, its serialize span runs from the request's finish (the
        decode span's end) to now, so the handler's wake-up is attributed
        to the reply handoff."""
        out = {
            "id": req.id,
            **(extra or {}),
            "token_ids": req.token_ids,
            "token_logprobs": req.token_logprobs,
            "finish_reason": req.finish_reason,
            "latency_s": req.latency_s,
            "ttft_s": req.ttft_s,
            "checkpoint_step": self._effective_checkpoint_step(),
        }
        if request_id is not None:
            out["request_id"] = request_id
        if req.finish_reason not in ("eos", "length", "stop"):
            out["stage"] = req.stage
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(req.token_ids)
        if trace is not None:
            t0 = req.finish_time if req.finish_time is not None else time.monotonic()
            trace.add("serialize", t0, time.monotonic())
            out["trace_id"] = trace.trace_id
            out["trace"] = trace.to_dict()["spans"]
        return out

    def _chat_reply(self, req, sess, trace, request_id: Optional[str]) -> Dict:
        # per-turn retention stats: a follow-up turn reports retained_hit
        # and a prefill of its delta only
        return self._reply_body(req, trace, request_id, {
            "session_id": sess.id,
            "turn": sess.turns,
            "retained_blocks": sess.last_reused_blocks,
            "retained_hit": sess.last_reused_blocks > 0,
            "prefill_tokens": sess.last_prefill_tokens,
            "session_tokens": int(sess.tokens.size),
        })

    def _handle_chat(self, payload: Dict, request_id: Optional[str] = None) -> Dict:
        req, sess, trace = self._submit_chat(payload, request_id)
        req.wait()
        return self._chat_reply(req, sess, trace, request_id)

    def _handle_stream(self, handler, path: str, payload: Dict, request_id: Optional[str] = None) -> None:
        """Server-sent-events token streaming for /generate and /chat.

        Each delta is one ``data: {"token_ids": [...]}`` event; the last
        event carries the full non-streaming reply body plus ``"event":
        "done"``, and the deltas' token_ids concatenate to its token_ids.
        The connection closes after the done event (HTTP/1.0 framing: the
        close delimits the body). Submission errors raise before any
        header is written, so they surface as ordinary JSON error
        replies."""
        q: "queue.Queue" = queue.Queue()
        sess = None
        if path == "/chat":
            req, sess, trace = self._submit_chat(payload, request_id, stream_q=q)
        else:
            ids = self._encode_prompt(payload)
            unsupported = set(payload) - _GENERATE_KEYS
            if unsupported:
                raise ValueError(
                    f"unsupported request keys {sorted(unsupported)}; sampling "
                    "knobs are fixed at server start (inference.gen_kwargs)"
                )
            if int(payload.get("n", 1)) != 1:
                raise ValueError("streaming supports n=1 only")
            trace = None
            if self.tracer is not None:
                trace = self.tracer.new_trace(trace_id=payload.get("trace_id"), request_id=request_id)
            req = self.scheduler.submit(
                ids,
                max_new_tokens=payload.get("max_new_tokens"),
                deadline_s=payload.get("deadline_s"),
                adapter_id=payload.get("adapter_id"),
                request_id=request_id,
                trace=trace,
                stop_sequences=self._parse_stop(payload),
                stream=q,
            )
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.end_headers()
        broken = False
        while True:
            item = q.get()
            if item is None:
                break
            if broken:
                continue  # the client went away: keep draining to the sentinel
            try:
                handler.wfile.write(b"data: " + json.dumps(item).encode() + b"\n\n")
                handler.wfile.flush()
            except OSError:
                broken = True
        req.wait()
        if sess is not None:
            final = self._chat_reply(req, sess, trace, request_id)
        else:
            final = self._reply_body(req, trace, request_id)
        final["event"] = "done"
        if not broken:
            try:
                handler.wfile.write(b"data: " + json.dumps(final).encode() + b"\n\n")
                handler.wfile.flush()
            except OSError:
                pass
        handler.close_connection = True

    # ------------------------------------------------------------------
    # Admin surface
    # ------------------------------------------------------------------

    def _handle_admin(self, path: str, payload: Dict) -> Dict:
        """``POST /admin/drain|undrain|reload``: drain flips the scheduler
        into reject-new/finish-inflight mode (readiness goes off); reload
        runs the watcher's drain-swap on an explicit checkpoint path (which
        must lie under watch_dir when the server has one) or a watch_dir
        scan when no path is given; undrain reopens admission."""
        if path == "/admin/drain":
            self.scheduler.reject_new()
            wait_s = payload.get("wait_s")
            idle = self.scheduler.wait_idle(float(wait_s)) if wait_s else None
            return {"draining": True, "idle": idle}
        if path == "/admin/undrain":
            self.scheduler.accept_new()
            return {"draining": False}
        if path == "/admin/reload":
            ckpt = payload.get("path")
            if ckpt is not None:
                ckpt = os.path.realpath(str(ckpt))
                watch = self.watcher.watch_dir and os.path.realpath(self.watcher.watch_dir)
                if watch and os.path.commonpath([ckpt, watch]) != watch:
                    raise ValueError(f"reload path {ckpt} is not under the watched directory")
                reloaded = self.watcher.load_path(ckpt)
            elif self.watcher.watch_dir:
                reloaded = self.watcher.poll_once()
            else:
                raise ValueError("reload needs 'path' (server has no watch_dir)")
            return {
                "reloaded": bool(reloaded),
                "checkpoint_step": self._effective_checkpoint_step(),
                "reloads": self.watcher.reloads,
            }
        if path == "/admin/adapters":
            store = self._adapter_store(required=True)
            actions = [k for k in ("load", "evict", "reload") if k in payload]
            if len(actions) != 1:
                raise ValueError('POST /admin/adapters takes exactly one of '
                                 '{"load": name} / {"evict": name} / {"reload": name}')
            action, name = actions[0], str(payload[actions[0]])
            out: Dict[str, Any] = {"action": action, "adapter": name}
            if action == "load":
                out["slot"] = store.load(name)
            elif action == "evict":
                store.evict(name)
                self.engine.flush_adapter_prefixes(name)
            else:
                out["reloaded"] = self.watcher.reload_adapter(name)
            out.update(self._adapter_snapshot())
            return out
        raise ValueError(f"unknown admin endpoint {path}")

    def _adapter_store(self, required: bool = False):
        store = self.engine.adapter_store
        if store is None and required:
            raise ValueError("server is not multi-tenant (start with inference.multi_tenant and an adapter_dir)")
        return store

    def _adapter_snapshot(self) -> Dict:
        store = self._adapter_store(required=True)
        return {"resident": store.resident(), "available": store.scan(), "stats": store.stats()}

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
                if path.startswith("/admin/"):
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        payload = json.loads(self.rfile.read(length) or b"{}")
                        self._reply_json(200, server._handle_admin(path, payload))
                    except AdapterCapacityError as e:
                        # every slot is pinned by requests in flight: a
                        # retry after they finish can succeed
                        self._reply_json(503, {"error": str(e)}, headers={"Retry-After": "1"})
                    except (ValueError, TypeError, AdapterError) as e:
                        self._reply_json(400, {"error": str(e)})
                    except Exception as e:
                        self._reply_json(500, {"error": repr(e)})
                    return
                if path not in ("", "/generate", "/chat"):
                    self.send_error(404)
                    return
                # every request gets an id at ingress (client-supplied or
                # fresh), echoed in the reply and every error body
                rid = self.headers.get("X-Request-Id") or new_id()
                self._rid = rid
                logging.set_trace_context(request_id=rid)
                if self._inject_fault(rid):
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if "trace_id" not in payload:
                        hdr_tid = self.headers.get("X-Trace-Id")
                        if hdr_tid:
                            payload["trace_id"] = hdr_tid
                    if payload.get("stream"):
                        # the SSE path writes its own headers and events; a
                        # submission error raises before the headers go out
                        server._handle_stream(self, path or "/generate", payload, request_id=rid)
                        return
                    if path == "/chat":
                        result = server._handle_chat(payload, request_id=rid)
                    else:
                        result = server._handle_generate(payload, request_id=rid)
                except SessionResetError as e:
                    # the retained state is gone (weights swap, TTL, unknown
                    # id): the client re-creates the session from its history
                    self._reply_json(409, {
                        "error": str(e), "session_reset": True,
                        "session_id": e.session_id, "reason": e.reason, "request_id": rid,
                    })
                    return
                except SessionBusyError as e:
                    self._reply_json(409, {
                        "error": str(e), "session_busy": True,
                        "session_id": e.session_id, "request_id": rid,
                    })
                    return
                except SessionLimitError as e:
                    self._reply_json(503, {"error": str(e), "request_id": rid}, headers={"Retry-After": "1"})
                    return
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

            def _drop(self):
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass

            def _inject_fault(self, rid) -> bool:
                """The injector's HTTP fault for this request, if it is
                scheduled one; True when the request was answered (or
                dropped) here. "slow" answers correctly, late."""
                injector = server.fault_injector
                if injector is None or not injector.should_fail():
                    return False
                mode = injector.mode
                if mode == "mixed":
                    mode = "drop" if injector.injected % 2 else "http_500"
                if mode == "drop":
                    self._drop()
                    return True
                if mode == "hang":
                    # an unresponsive replica: hold the socket, then drop
                    # it; clients escape only through a timeout or a hedge
                    time.sleep(injector.hang_s)
                    self._drop()
                    return True
                if mode == "slow":
                    time.sleep(injector.slow_s)
                    return False
                self._reply_json(503, {"error": "injected transient failure", "request_id": rid})
                return True

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
                if path == "/admin/adapters":
                    try:
                        self._reply_json(200, server._adapter_snapshot())
                    except (ValueError, AdapterError) as e:
                        self._reply_json(400, {"error": str(e)})
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
                    injector = server.fault_injector
                    if injector is not None and getattr(injector, "healthz_hang_s", 0):
                        # a wedged replica: the process is up, its health
                        # endpoint never answers (supervisors must see
                        # this through probe deadlines)
                        time.sleep(injector.healthz_hang_s)
                        self._drop()
                        return
                    watcher = server.watcher
                    ready = server.ready
                    kv = server.engine.kv_stats()
                    sstats = server.engine.session_stats()
                    store = server._adapter_store()
                    self._reply_json(200, {
                        # liveness ("process is up") vs readiness ("can take
                        # traffic now"): a reload in flight is live, not ready
                        "status": "ok" if ready else "degraded",
                        "live": True,
                        "ready": ready,
                        "reloading": bool(watcher.reloading),
                        "draining": not server.scheduler.accepting,
                        "slots_total": server.engine.num_slots,
                        "slots_active": server.engine.active_slots,
                        "queue_depth": int(server.metrics.get("queue_depth")),
                        "param_version": server.engine.param_version,
                        "checkpoint_step": server._effective_checkpoint_step(),
                        "reloads": watcher.reloads,
                        **({"kv": kv} if kv else {}),
                        **({"sessions": sstats} if sstats else {}),
                        # the resident adapters (multi-tenant only): fleet
                        # routers prefer a replica already holding the
                        # request's adapter (no load on the hot path)
                        **({"adapters": {"resident": store.resident(), "capacity": store.capacity}}
                           if store is not None else {}),
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
        self._httpd = _Listener((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._shutdown_done = False
        self.scheduler.start()
        store = self._adapter_store()
        if self.watcher.watch_dir or (store is not None and store.adapter_dir):
            # the poll thread also drives per-adapter hot-reload, so a
            # multi-tenant server needs it even without a watch_dir
            self.watcher.start()

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
        """Blocking serve (the standalone policy-server process).

        SIGTERM and SIGINT start a drain, then exit: the scheduler turns to
        reject-new (new requests answer 503 with Retry-After, so a fleet
        router fails them over), in-flight decodes run to their end and
        reply over the still-open listener, and only then does the
        listener close; the previous handlers come back and the call ends
        with `shutdown(drain_s=drain_on_term_s)`."""
        import signal

        self._bind()
        logger.info(f"Inference server listening on :{self.port}")

        def graceful(signum):
            logger.warning(f"signal {signum}: draining scheduler (reject-new) before exit")
            self.scheduler.reject_new()
            self.scheduler.wait_idle(self.drain_on_term_s)
            self._httpd.shutdown()  # ends serve_forever below

        def on_term(signum, frame):
            threading.Thread(target=graceful, args=(signum,), name="trlx-tpu-torch-server-drain",
                             daemon=True).start()

        previous = {}
        try:  # handlers install only from the main thread
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, on_term)
        except ValueError:
            previous = {}
        try:
            self._httpd.serve_forever()
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
            self.shutdown(drain_s=self.drain_on_term_s)

    def shutdown(self, drain_s: float = 0.0) -> None:
        """Stop serving. With `drain_s > 0` the scheduler first finishes
        in-flight requests (reject-new) so they reply before the listener
        closes; with 0 they finish as "shutdown"."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self.watcher.stop()
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

    def release(self) -> None:
        """Shut down, then drop the engine's device state (its KV pool and
        its module): what a killed in-process replica must give back, since
        its handle keeps the server object reachable."""
        self.shutdown()
        self.engine.release()
