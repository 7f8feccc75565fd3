"""Fault-tolerant rollout fleet: a router fronting N inference replicas.

Port of the JAX package's `inference/fleet.py` (plain Python over HTTP;
the port's own copy). A rollout cycle must not drop a prompt when a
replica of the pool is preempted, hangs, decodes slowly or serves a
stale checkpoint. `ReplicaRouter` is that robustness layer:

- **health probes with a liveness/readiness split**: each replica's
  ``GET /healthz`` is polled lazily, at most every `probe_interval_s`;
  ``live`` is "the process is up", ``ready`` is "it can take traffic now"
  (off while a checkpoint reload drains and swaps). A failed probe marks
  the replica down until a later probe brings it back.
- **per-replica circuit breakers, least-loaded dispatch, failover**:
  every replica sits behind its own `RetryingJSONClient` (a small retry
  budget and its own `CircuitBreaker`). Dispatch picks the eligible
  replica with the fewest requests in flight; a request that fails is
  retried on the next eligible replica (each replica at most once a
  request), so no request is dropped while any replica can serve it.
- **hedged requests**: after a p95-derived delay (or a fixed
  `hedge_after_s`) a pending request is duplicated onto a second
  replica; the first answer wins, the loser is cancelled (not started
  yet) or abandoned (an HTTP request in flight cannot be aborted: its
  reply is discarded and counted in `hedges_wasted`).
- **bounded-staleness weight sync**: the router tracks each replica's
  ``checkpoint_step`` (from /healthz and every reply) against
  `set_trainer_step`. A replica more than `max_staleness_steps` behind
  gets no new request until it reloads, and a reply that arrives stale
  is rejected and re-dispatched. Replicas that report no step (serving
  live in-process weights) are exempt.
- **whole-fleet-down degradation**: when no replica can serve a request,
  `FleetUnavailableError` is raised; the PPO trainer catches it and
  generates the chunk locally, with a one-time warning.
- **sessions**: `chat` keeps a conversation on the replica holding its
  retained KV and keeps its whole id transcript, so a dead replica or a
  reset session is recovered by replaying the transcript elsewhere.

Thread safety: `generate` fans prompts out over a coordinator pool; the
HTTP posts run on a separate request pool (so hedges cannot deadlock the
coordinators). Replica bookkeeping happens under one router lock.
"""

import json
import threading
import time
import urllib.request
from collections import deque
from concurrent import futures
from typing import Any, Dict, List, Optional, Sequence, Union

from trlx_tpu_torch import resilience
from trlx_tpu_torch.inference.metrics import dedupe_metadata
from trlx_tpu_torch.observability.slo import SLOEngine
from trlx_tpu_torch.utils import logging
from trlx_tpu_torch.utils.http import RetryingJSONClient

logger = logging.get_logger(__name__)


class FleetUnavailableError(RuntimeError):
    """No replica in the fleet could serve a request: every eligible
    replica was tried and failed, or none is live/ready/fresh. Callers
    degrade (the PPO trainer falls back to local generation)."""


class Replica:
    """One fleet member: its URL, retry/breaker client, and the router's
    view of its health (updated by probes and dispatch outcomes)."""

    def __init__(
        self,
        url: str,
        timeout: float = 300.0,
        retries: int = 1,
        retry_base_delay: float = 0.1,
        retry_max_delay: float = 2.0,
        breaker_threshold: int = 3,
        breaker_recovery: float = 10.0,
        _sleep=None,
    ):
        self.url = url.rstrip("/")
        self.client = RetryingJSONClient(
            self.url + "/generate",
            timeout=timeout,
            retries=retries,
            retry_base_delay=retry_base_delay,
            retry_max_delay=retry_max_delay,
            breaker_threshold=breaker_threshold,
            breaker_recovery=breaker_recovery,
            error_label=f"replica {self.url}",
            _sleep=_sleep,
        )
        self.chat_client = RetryingJSONClient(
            self.url + "/chat",
            timeout=timeout,
            retries=retries,
            retry_base_delay=retry_base_delay,
            retry_max_delay=retry_max_delay,
            breaker_threshold=breaker_threshold,
            breaker_recovery=breaker_recovery,
            error_label=f"replica {self.url}",
            _sleep=_sleep,
        )
        # one breaker per replica, not per endpoint: /chat failures and
        # /generate failures are the same replica dying
        self.chat_client.breaker = self.client.breaker
        # optimistic until the first probe says otherwise: a router built
        # before its replicas finish binding should not blacklist them
        self.live = True
        self.ready = True
        self.draining = False
        self.checkpoint_step: Optional[int] = None
        self.param_version: Optional[int] = None
        self.inflight = 0
        self.served = 0
        self.failures = 0
        self.last_probe = 0.0  # monotonic; 0 = never probed
        self.last_error: Optional[str] = None
        # paged KV-pool occupancy from the last probe ({} on fixed-slot
        # replicas) — supervisors export these per-replica. The JAX
        # router's compile/HBM forensics wait for those ledgers (ROADMAP
        # queue A, item 4.7)
        self.kv: Dict[str, Any] = {}
        # resident adapter ids from the last probe ([] on single-tenant
        # replicas): dispatch prefers a replica already holding the
        # request's adapter, so the hot path does not wait on a disk load
        self.adapters: List[str] = []

    @property
    def breaker(self) -> resilience.CircuitBreaker:
        return self.client.breaker

    def snapshot(self) -> Dict[str, Any]:
        return {
            "url": self.url,
            "live": self.live,
            "ready": self.ready,
            "draining": self.draining,
            "checkpoint_step": self.checkpoint_step,
            "breaker": self.breaker.state,
            "inflight": self.inflight,
            "served": self.served,
            "failures": self.failures,
            "last_error": self.last_error,
            "kv": dict(self.kv),
            "adapters": list(self.adapters),
        }


class ReplicaRouter:
    """Route generation requests across a fleet of inference replicas.

    `generate(prompts, **kw)` returns one response dict per prompt, in
    order, or raises `FleetUnavailableError` when any prompt cannot be
    served by any replica (all-or-nothing per chunk: a partial chunk
    would silently shrink the rollout count). Per-call kwargs mirror
    `remote_generate` (`max_new_tokens`, `deadline_s`); sampling knobs
    are fixed at replica start.

    :param urls: base URLs of the `InferenceServer` replicas.
    :param max_staleness_steps: a replica whose `checkpoint_step` is more
        than this far behind `set_trainer_step` receives no new requests
        until it reloads; replicas reporting no step are exempt.
    :param hedge_after_s: fixed hedging delay; None derives it from the
        p95 of the last `hedge_min_samples`+ request latencies (no
        hedging until that many samples exist).
    :param concurrency: prompts dispatched at once by `generate`.
    """

    def __init__(
        self,
        urls: Sequence[str],
        timeout: float = 300.0,
        concurrency: int = 8,
        max_staleness_steps: int = 1,
        probe_interval_s: float = 2.0,
        probe_timeout_s: float = 5.0,
        replica_retries: int = 1,
        retry_base_delay: float = 0.1,
        retry_max_delay: float = 2.0,
        breaker_threshold: int = 3,
        breaker_recovery: float = 10.0,
        hedge: bool = True,
        hedge_after_s: Optional[float] = None,
        hedge_min_samples: int = 16,
        hedge_max_delay_s: float = 5.0,
        _sleep=None,
        tracer=None,
        slos=None,
        slo_postmortem_dir: Optional[str] = None,
    ):
        # cross-process tracing (None = off): every dispatch opens a
        # parent span, each replica attempt / hedge / failover is a child
        # span, and the winner's replica-returned span tree is grafted
        # under its attempt — one timeline per request across processes
        self.tracer = tracer
        # fleet-level SLO feed: router-side dispatch wall time per post.
        # This is deliberately measured from the caller's side — a
        # replica whose handler stalls before the scheduler ever sees the
        # request (overloaded accept loop, injected latency fault) is
        # invisible to that replica's own scheduler histograms but fully
        # visible here.
        self.slo = SLOEngine(slos=slos, postmortem_dir=slo_postmortem_dir)
        # an empty fleet is allowed (a supervisor registers members as
        # they come up); dispatch against it degrades via
        # FleetUnavailableError like a whole-fleet outage
        # kept for add_replica: a promoted spare / respawned replica gets
        # the same client knobs as the founding members
        self._replica_kwargs = dict(
            timeout=timeout,
            retries=replica_retries,
            retry_base_delay=retry_base_delay,
            retry_max_delay=retry_max_delay,
            breaker_threshold=breaker_threshold,
            breaker_recovery=breaker_recovery,
            _sleep=_sleep,
        )
        self.replicas = [Replica(u, **self._replica_kwargs) for u in urls]
        self.max_staleness_steps = int(max_staleness_steps)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.hedge = bool(hedge)
        self.hedge_after_s = hedge_after_s
        self.hedge_min_samples = int(hedge_min_samples)
        self.hedge_max_delay_s = float(hedge_max_delay_s)
        self.trainer_step: Optional[int] = None
        self.counters: Dict[str, int] = {
            "requests": 0,
            "failovers": 0,
            "hedges": 0,
            "hedges_cancelled": 0,
            "hedges_wasted": 0,
            "stale_rejected": 0,
            "session_turns": 0,
            "session_failovers": 0,
            "session_resets": 0,
        }
        # session affinity: caller key -> (replica url, server session
        # id, full id transcript). The transcript is the recovery path —
        # a failover or 409 session_reset replays the whole conversation
        # as a fresh session on another (or the same) replica.
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._latencies: deque = deque(maxlen=256)
        n = max(int(concurrency), 1)
        self._coordinators = futures.ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="trlx-tpu-torch-fleet-coord"
        )
        # hedges double the worst-case posts in flight; a separate pool
        # keeps them from starving (or deadlocking) the coordinators
        self._requests = futures.ThreadPoolExecutor(
            max_workers=2 * n + 2, thread_name_prefix="trlx-tpu-torch-fleet-req"
        )

    # ------------------------------------------------------------------
    # Health probing
    # ------------------------------------------------------------------

    def probe(self, rep: Replica) -> bool:
        """One /healthz round trip; updates live/ready/checkpoint_step.
        Legacy replicas without the readiness split count as ready while
        their status is "ok"."""
        try:
            with urllib.request.urlopen(
                rep.url + "/healthz", timeout=self.probe_timeout_s
            ) as resp:
                info = json.loads(resp.read())
        except Exception as e:  # connection refused/reset, timeout, bad body
            rep.live = False
            rep.ready = False
            rep.last_error = f"probe: {e}"
            rep.last_probe = time.monotonic()
            return False
        rep.live = bool(info.get("live", info.get("status") == "ok"))
        rep.ready = bool(info.get("ready", rep.live))
        step = info.get("checkpoint_step")
        rep.checkpoint_step = int(step) if step is not None else None
        rep.param_version = info.get("param_version")
        kv = info.get("kv")
        rep.kv = dict(kv) if isinstance(kv, dict) else {}
        adapters = info.get("adapters")
        rep.adapters = list(adapters.get("resident") or []) if isinstance(adapters, dict) else []
        rep.last_probe = time.monotonic()
        rep.last_error = None
        return rep.live

    def probe_all(self, force: bool = False) -> int:
        """Probe every replica whose last probe is older than
        `probe_interval_s` (all of them with `force`); returns how many
        are live AND ready afterwards."""
        now = time.monotonic()
        n_up = 0
        with self._lock:  # membership can change under a supervisor
            replicas = list(self.replicas)
        for rep in replicas:
            if force or rep.last_probe == 0.0 or now - rep.last_probe >= self.probe_interval_s:
                self.probe(rep)
            n_up += int(rep.live and rep.ready)
        return n_up

    # ------------------------------------------------------------------
    # Eligibility + dispatch choice
    # ------------------------------------------------------------------

    def set_trainer_step(self, step: Optional[int]) -> None:
        """Anchor the staleness bound: replicas more than
        `max_staleness_steps` behind this step become ineligible."""
        self.trainer_step = None if step is None else int(step)

    def _fresh_step(self, checkpoint_step: Optional[int]) -> bool:
        if checkpoint_step is None or self.trainer_step is None:
            return True  # unversioned replica (live params) / unanchored router
        return self.trainer_step - int(checkpoint_step) <= self.max_staleness_steps

    def _eligible(self, rep: Replica) -> bool:
        return (
            rep.live
            and rep.ready
            and not rep.draining
            and rep.breaker.state != "open"
            and self._fresh_step(rep.checkpoint_step)
        )

    def _pick(self, exclude: Sequence[Replica] = (), adapter_id: Optional[str] = None) -> Optional[Replica]:
        """Least-loaded dispatch among eligible replicas (ties broken by
        fewest lifetime requests, then list order). With an `adapter_id`,
        replicas already holding that adapter resident sort first:
        affinity, not pinning, so a replica without it still serves the
        request (its store loads the adapter on demand) when the ones
        holding it are excluded or down."""
        with self._lock:
            candidates = [
                (int(bool(adapter_id) and adapter_id not in rep.adapters), rep.inflight, rep.served, i, rep)
                for i, rep in enumerate(self.replicas)
                if rep not in exclude and self._eligible(rep)
            ]
        if not candidates:
            return None
        return min(candidates)[4]

    # ------------------------------------------------------------------
    # Request path
    # ------------------------------------------------------------------

    def _post(self, rep: Replica, payload: Dict) -> Dict:
        """One breaker-guarded post to one replica, with inflight/latency
        bookkeeping (runs on the request pool; exceptions propagate)."""
        with self._lock:
            rep.inflight += 1
        t0 = time.monotonic()
        try:
            out = rep.client.post(dict(payload))
        except Exception as e:
            with self._lock:
                rep.inflight -= 1
                rep.failures += 1
                rep.last_error = str(e)
            self.slo.record(latency_s=time.monotonic() - t0, ok=False)
            raise
        dt = time.monotonic() - t0
        with self._lock:
            rep.inflight -= 1
            rep.served += 1
            self._latencies.append(dt)
        self.slo.record(latency_s=dt)
        return out

    def _hedge_delay(self) -> Optional[float]:
        """Seconds to wait before duplicating a pending request, or None
        for no hedging (disabled, or not enough latency samples yet)."""
        if not self.hedge:
            return None
        if self.hedge_after_s is not None:
            return float(self.hedge_after_s)
        with self._lock:
            if len(self._latencies) < self.hedge_min_samples:
                return None
            lat = sorted(self._latencies)
        p95 = lat[min(len(lat) - 1, int(0.95 * len(lat)))]
        return min(p95, self.hedge_max_delay_s)

    def generate_one(self, prompt: Union[str, List[int]], **kwargs) -> Dict:
        """Serve one prompt with failover + hedging. Raises
        `FleetUnavailableError` only after every eligible replica has
        been attempted (and one forced re-probe found nothing new)."""
        payload = dict(kwargs)
        if isinstance(prompt, str):
            payload["prompt"] = prompt
        else:
            payload["prompt_ids"] = list(map(int, prompt))
        with self._lock:
            self.counters["requests"] += 1
        adapter_id = payload.get("adapter_id")  # the affinity hint for _pick

        # explicit trace context: local variables only — attempts run on
        # pool threads, so nothing ambient would survive the hop anyway
        trace = dispatch = None
        attempt_spans: Dict[futures.Future, Any] = {}
        if self.tracer is not None:
            trace = self.tracer.new_trace(trace_id=payload.get("trace_id"))
            # the replica opens its server-side trace under the same id
            # and returns its spans in the reply for grafting
            payload["trace_id"] = trace.trace_id
            dispatch = trace.span("dispatch")

        tried: List[Replica] = []
        reprobed = False
        last_exc: Optional[BaseException] = None
        while True:
            rep = self._pick(exclude=tried, adapter_id=adapter_id)
            if rep is None and not reprobed:
                # a replica may have recovered (or finished reloading)
                # since its last probe — one forced pass before giving up
                reprobed = True
                if self.probe_all(force=True):
                    rep = self._pick(exclude=tried, adapter_id=adapter_id)
            if rep is None:
                if dispatch is not None:
                    dispatch.end(status="error")
                    self.tracer.finish(trace)
                # whole-fleet unavailability is a rejection, not a
                # latency sample: the request never reached a replica
                self.slo.record(ok=False, rejected=True)
                raise FleetUnavailableError(
                    f"no eligible replica (tried {[r.url for r in tried] or 'none'};"
                    f" last error: {last_exc})"
                )

            fut0 = self._requests.submit(self._post, rep, payload)
            pending: Dict[futures.Future, Replica] = {fut0: rep}
            if dispatch is not None:
                attempt_spans[fut0] = dispatch.child("attempt", replica=rep.url)
            tried.append(rep)

            delay = self._hedge_delay()
            if delay is not None:
                done, _ = futures.wait(
                    set(pending), timeout=delay, return_when=futures.FIRST_COMPLETED
                )
                if not done:
                    hedge_rep = self._pick(exclude=tried, adapter_id=adapter_id)
                    if hedge_rep is not None:
                        hfut = self._requests.submit(self._post, hedge_rep, payload)
                        pending[hfut] = hedge_rep
                        if dispatch is not None:
                            attempt_spans[hfut] = dispatch.child(
                                "attempt", replica=hedge_rep.url, hedge=True
                            )
                        tried.append(hedge_rep)
                        with self._lock:
                            self.counters["hedges"] += 1

            outstanding = set(pending)
            while outstanding:
                done, outstanding = futures.wait(
                    outstanding, return_when=futures.FIRST_COMPLETED
                )
                winner = None
                winner_fut = None
                for fut in done:
                    rep_f = pending[fut]
                    try:
                        out = fut.result()
                    except (resilience.TransientError, resilience.CircuitOpenError) as e:
                        last_exc = e
                        sp = attempt_spans.get(fut)
                        if sp is not None:
                            sp.attrs["error"] = str(e)
                            sp.end(status="error")
                        with self._lock:
                            self.counters["failovers"] += 1
                        continue
                    if not self._fresh_step(out.get("checkpoint_step")):
                        # the replica reloaded to (or reported) a
                        # checkpoint beyond the staleness bound mid-flight:
                        # never mix this rollout in — re-dispatch
                        last_exc = resilience.TransientError(
                            f"stale rollout from {rep_f.url} (checkpoint_step "
                            f"{out.get('checkpoint_step')} vs trainer step "
                            f"{self.trainer_step})"
                        )
                        sp = attempt_spans.get(fut)
                        if sp is not None:
                            sp.end(status="stale_rejected")
                        with self._lock:
                            self.counters["stale_rejected"] += 1
                        self.probe(rep_f)  # refresh its step so _pick skips it
                        continue
                    winner = out
                    winner_fut = fut
                    break
                if winner is not None:
                    for fut in outstanding:  # the hedging loser
                        if fut.cancel():
                            sp = attempt_spans.get(fut)
                            if sp is not None:
                                sp.end(status="cancelled")
                            with self._lock:
                                self.counters["hedges_cancelled"] += 1
                        else:
                            # in-flight HTTP cannot be aborted: the reply
                            # is discarded when it lands
                            sp = attempt_spans.get(fut)
                            if sp is not None:
                                sp.end(status="wasted")
                            with self._lock:
                                self.counters["hedges_wasted"] += 1
                    if dispatch is not None:
                        wsp = attempt_spans.get(winner_fut)
                        if wsp is not None:
                            wsp.end(status="ok")
                            # graft the replica's server-side span tree
                            # under the winning attempt — one
                            # cross-process timeline for this request
                            trace.adopt(winner.get("trace") or (), parent=wsp)
                        if winner.get("request_id"):
                            trace.request_id = winner["request_id"]
                        dispatch.end()
                        self.tracer.finish(trace)
                    return winner
            # every attempt of this round failed -> failover continues
            # with the replicas not yet tried

    def generate(self, prompts, **kwargs) -> Union[Dict, List[Dict]]:
        """Serve one prompt or a list of prompts (fanned out over
        `concurrency` coordinators). All-or-nothing: if any prompt is
        unservable by the whole fleet, `FleetUnavailableError` carries
        the count so the caller can degrade for the entire chunk."""
        single = isinstance(prompts, str) or (
            isinstance(prompts, (list, tuple))
            and bool(prompts)
            and isinstance(prompts[0], int)
        )
        self.probe_all()
        if single:
            return self.generate_one(prompts, **kwargs)
        futs = [
            self._coordinators.submit(self.generate_one, p, **kwargs) for p in prompts
        ]
        results: List[Optional[Dict]] = []
        errors: List[BaseException] = []
        for fut in futs:
            try:
                results.append(fut.result())
            except FleetUnavailableError as e:
                results.append(None)
                errors.append(e)
        if errors:
            raise FleetUnavailableError(
                f"{len(errors)}/{len(prompts)} prompts unservable by the fleet; "
                f"first: {errors[0]}"
            )
        return results

    # ------------------------------------------------------------------
    # Multi-turn sessions (sticky routing + transcript recovery)
    # ------------------------------------------------------------------

    def _chat_post(self, rep: Replica, payload: Dict) -> Dict:
        """`_post` against the replica's /chat endpoint (same inflight /
        latency / breaker bookkeeping)."""
        with self._lock:
            rep.inflight += 1
        t0 = time.monotonic()
        try:
            out = rep.chat_client.post(dict(payload))
        except Exception as e:
            with self._lock:
                rep.inflight -= 1
                rep.failures += 1
                rep.last_error = str(e)
            self.slo.record(latency_s=time.monotonic() - t0, ok=False)
            raise
        dt = time.monotonic() - t0
        with self._lock:
            rep.inflight -= 1
            rep.served += 1
            self._latencies.append(dt)
        self.slo.record(latency_s=dt)
        return out

    def _chat_fresh(self, ids: List[int], **kwargs) -> (
        "tuple[Replica, Dict]"
    ):
        """Create a brand-new server session for the full transcript
        `ids`, with generate-style failover across eligible replicas."""
        payload = dict(kwargs)
        payload["prompt_ids"] = list(map(int, ids))
        adapter_id = payload.get("adapter_id")
        tried: List[Replica] = []
        reprobed = False
        last_exc: Optional[BaseException] = None
        while True:
            rep = self._pick(exclude=tried, adapter_id=adapter_id)
            if rep is None and not reprobed:
                reprobed = True
                if self.probe_all(force=True):
                    rep = self._pick(exclude=tried, adapter_id=adapter_id)
            if rep is None:
                raise FleetUnavailableError(
                    f"no eligible replica for chat (tried "
                    f"{[r.url for r in tried] or 'none'}; last error: {last_exc})"
                )
            tried.append(rep)
            try:
                return rep, self._chat_post(rep, payload)
            except (resilience.TransientError, resilience.CircuitOpenError) as e:
                last_exc = e
                with self._lock:
                    self.counters["failovers"] += 1

    def chat(self, turn_ids: List[int], session_key: str, **kwargs) -> Dict:
        """One conversation turn with session affinity.

        `session_key` is the caller's conversation id (e.g. one rollout's
        environment episode). Turns for the same key stick to the replica
        holding the session's retained KV; the router keeps the full id
        transcript, so a replica failure, a 409 `session_reset` (TTL,
        eviction, weight swap), or a removed replica is recovered by
        replaying the conversation as a fresh session — possibly
        elsewhere. Turns are token ids only: a text turn could not be
        replayed without a tokenizer. Reply dicts are the server's /chat
        schema (`retained_hit`, `prefill_tokens`, `ttft_s`, ...)."""
        turn_ids = list(map(int, turn_ids))
        with self._lock:
            self.counters["requests"] += 1
            self.counters["session_turns"] += 1
            entry = self._sessions.get(session_key)
        self.probe_all()
        out = None
        rep = None
        if entry is not None:
            try:
                rep = self._by_url(entry["url"])
            except KeyError:
                rep = None  # replica removed from the fleet
            if rep is not None and self._eligible(rep):
                payload = dict(kwargs)
                payload["session_id"] = entry["session_id"]
                payload["prompt_ids"] = turn_ids
                try:
                    out = self._chat_post(rep, payload)
                except (resilience.TransientError, resilience.CircuitOpenError):
                    with self._lock:
                        self.counters["session_failovers"] += 1
                    out = None
                except RuntimeError as e:
                    # 409 session_reset (or unknown id after a replica
                    # respawn): replay below. Anything else — including
                    # 409 session_busy — is a caller error and surfaces.
                    if "reset" not in str(e):
                        raise
                    with self._lock:
                        self.counters["session_resets"] += 1
                    out = None
        if out is None:
            full = (entry["ids"] if entry is not None else []) + turn_ids
            rep, out = self._chat_fresh(full, **kwargs)
        with self._lock:
            self._sessions[session_key] = {
                "url": rep.url,
                "session_id": out["session_id"],
                "ids": (entry["ids"] if entry is not None else [])
                + turn_ids + list(map(int, out.get("token_ids", []))),
            }
        return out

    def end_session(self, session_key: str) -> None:
        """Forget a conversation's affinity + transcript (the server side
        expires on its own TTL)."""
        with self._lock:
            self._sessions.pop(session_key, None)

    # ------------------------------------------------------------------
    # Drain (weight-sync coordination) + introspection
    # ------------------------------------------------------------------

    def _by_url(self, url: str) -> Replica:
        url = url.rstrip("/")
        with self._lock:
            for rep in self.replicas:
                if rep.url == url:
                    return rep
        raise KeyError(f"unknown replica {url}")

    # ------------------------------------------------------------------
    # Membership (fleet supervisor: respawns + spare promotion)
    # ------------------------------------------------------------------

    def add_replica(self, url: str) -> Replica:
        """Register a new serving member (a respawned replica on a fresh
        port, or a promoted warm spare). Idempotent per URL; the new
        replica uses the router's founding client knobs and is probed
        before its first dispatch."""
        url = url.rstrip("/")
        with self._lock:
            for rep in self.replicas:
                if rep.url == url:
                    return rep
            rep = Replica(url, **self._replica_kwargs)
            rep.last_probe = 0.0  # force a probe before first dispatch
            self.replicas.append(rep)
        self.probe(rep)
        return rep

    def remove_replica(self, url: str) -> None:
        """Forget a member (a dead/quarantined replica). In-flight
        requests already posted to it finish on their own; no new
        dispatch will pick it. Unknown URLs are a no-op."""
        url = url.rstrip("/")
        with self._lock:
            self.replicas = [rep for rep in self.replicas if rep.url != url]

    def capacity(self) -> int:
        """How many replicas are currently dispatchable (live, ready, not
        draining, breaker closed, fresh) — the serving capacity a rolling
        sync must keep at >= N-1."""
        with self._lock:
            return sum(int(self._eligible(rep)) for rep in self.replicas)

    def drain(self, url: str, timeout_s: float = 30.0) -> bool:
        """Stop dispatching to `url` and wait for its in-flight requests
        to finish (router-side drain, e.g. before an orchestrated
        reload). Returns True when fully drained; the replica stays
        excluded until `undrain`."""
        rep = self._by_url(url)
        rep.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if rep.inflight == 0:
                    return True
            time.sleep(0.01)
        with self._lock:
            return rep.inflight == 0

    def undrain(self, url: str) -> None:
        self._by_url(url).draining = False

    def stats(self) -> Dict[str, Any]:
        """Router counters + per-replica snapshots (for logs/tests)."""
        with self._lock:
            out: Dict[str, Any] = dict(self.counters)
            replicas = list(self.replicas)
        out["capacity"] = self.capacity()
        out["replicas"] = [rep.snapshot() for rep in replicas]
        return out

    def render_metrics(self) -> str:
        """Prometheus text view of the router: lifetime counters plus
        per-replica gauges (labelled by url), so a fleet is scrapable
        like a single server. A supervisor's `/metrics` endpoint serves
        this concatenated with its own lifecycle counters."""
        ns = "trlx_tpu_fleet"
        with self._lock:
            counters = dict(self.counters)
            replicas = list(self.replicas)
        lines: List[str] = []
        for name, value in sorted(counters.items()):
            lines.append(f"# TYPE {ns}_{name}_total counter")
            lines.append(f"{ns}_{name}_total {value}")
        lines.append(f"# TYPE {ns}_capacity gauge")
        lines.append(f"{ns}_capacity {self.capacity()}")
        gauges = (
            ("replica_up", lambda r: int(r.live)),
            ("replica_ready", lambda r: int(r.ready)),
            ("replica_draining", lambda r: int(r.draining)),
            ("replica_breaker_open", lambda r: int(r.breaker.state == "open")),
            ("replica_inflight", lambda r: r.inflight),
        )
        for name, fn in gauges:
            lines.append(f"# TYPE {ns}_{name} gauge")
            for rep in replicas:
                lines.append(f'{ns}_{name}{{url="{rep.url}"}} {fn(rep)}')
        # paged KV-pool series, only for replicas whose probes report them
        kv_gauges = (
            ("replica_kv_blocks_free", "kv_blocks_free"),
            ("replica_kv_blocks_used", "kv_blocks_used"),
            ("replica_kv_pool_bytes", "kv_pool_bytes"),
        )
        for name, key in kv_gauges:
            rows = [r for r in replicas if key in r.kv]
            if not rows:
                continue
            lines.append(f"# TYPE {ns}_{name} gauge")
            for rep in rows:
                lines.append(f'{ns}_{name}{{url="{rep.url}"}} {rep.kv[key]}')
        for name, attr in (("replica_served", "served"),
                           ("replica_failures", "failures")):
            lines.append(f"# TYPE {ns}_{name}_total counter")
            for rep in replicas:
                lines.append(
                    f'{ns}_{name}_total{{url="{rep.url}"}} {getattr(rep, attr)}'
                )
        kv_counters = (
            ("replica_prefix_cache_hits", "prefix_cache_hits"),
            ("replica_prefix_cache_misses", "prefix_cache_misses"),
            ("replica_prefix_cache_evictions", "prefix_cache_evictions"),
        )
        for name, key in kv_counters:
            rows = [r for r in replicas if key in r.kv]
            if not rows:
                continue
            lines.append(f"# TYPE {ns}_{name}_total counter")
            for rep in rows:
                lines.append(f'{ns}_{name}_total{{url="{rep.url}"}} {rep.kv[key]}')
        text = "\n".join(lines) + "\n" + self.slo.render_prometheus(ns=ns)
        return dedupe_metadata(text)

    def close(self, timeout_s: float = 5.0) -> None:
        """Tear down the dispatch pools. Pending (not yet started) work
        is cancelled and worker threads are joined with a bounded
        timeout, so no hedge/coordinator thread survives to log or touch
        sockets after a test (or trainer) has moved on. In-flight HTTP
        posts cannot be aborted; the join waits up to `timeout_s` for
        them, then gives up rather than blocking teardown forever."""
        for pool in (self._coordinators, self._requests):
            pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + float(timeout_s)
        for pool in (self._coordinators, self._requests):
            for t in list(getattr(pool, "_threads", ()) or ()):
                t.join(timeout=max(0.0, deadline - time.monotonic()))
