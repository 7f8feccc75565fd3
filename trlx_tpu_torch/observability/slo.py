"""Declarative SLOs + multi-window burn-rate evaluation.

The serving stack exports rich Prometheus series and the bench harness
asserts SLOs offline (BENCH_load_slo.json), but nothing at runtime
answered "are we currently violating the latency/availability promises".
This module closes that gap with the standard SRE construction:

  - an `SLO` declares a promise: "at least `target` of events are good",
    where good is defined by the SLO kind (latency under `threshold_s`,
    request succeeded, request not rejected, TTFT under `threshold_s`);
  - the error budget is `1 - target`;
  - the burn rate over a window is `bad_fraction / (1 - target)` —
    burn 1.0 spends the budget exactly at the promised rate, burn 14.4
    (Google SRE workbook) exhausts a 30-day budget in 2 days;
  - an SLO is *alerting* in a window when its burn rate exceeds
    `burn_alert` with at least `min_events` observations, and *burning*
    when every window alerts (the multi-window AND suppresses blips);
  - lifetime budget exhaustion fires ONE postmortem bundle via the
    once-per-trigger-key mechanism (postmortem.maybe_dump).

Feeds: `record()` takes one event directly (the fleet router calls it
per dispatched request; synthetic streams drive the unit tests), and
`ingest_registry()` snapshot-diffs an InferenceMetrics registry
(histogram bucket deltas + outcome counter deltas) so the server-side
engine needs no hook in the request path — the /metrics scrape or
/debug/slo poll cadence drives sampling.

Dependency-free, like the rest of this package's observability.
"""

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from trlx_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

# scheduler finish reasons that count as a successful request ("ok" is
# the stand-in for an unlabeled requests_total increment)
GOOD_OUTCOMES = ("eos", "length", "stop", "ok")


@dataclass
class SLO:
    """One promise over the request stream. `kind` defines what an event
    is and when it is bad:

      latency   — completed requests; bad when latency > threshold_s
      ttft      — streamed requests; bad when TTFT > threshold_s
      availability — all requests; bad when not ok
      rejection — all admission decisions; bad when rejected
    """

    name: str
    kind: str  # "latency" | "ttft" | "availability" | "rejection"
    target: float  # promised good fraction; error budget = 1 - target
    threshold_s: float = 0.0
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_alert: float = 2.0  # alerting when burn rate >= this
    min_events: int = 10  # no alert below this many observations
    description: str = ""

    def windows(self) -> Tuple[Tuple[str, float], ...]:
        return (("fast", self.fast_window_s), ("slow", self.slow_window_s))


def default_slos() -> List[SLO]:
    """Defaults mirroring the offline assertions in BENCH_load_slo.json
    (saturation round: p50 0.40s / p99 13.7s / 0 dropped): thresholds sit
    just above the measured trajectory so a healthy serving stack burns
    ~0 budget and a regression shows up as burn > 1."""
    return [
        SLO("latency_p50", "latency", target=0.50, threshold_s=0.5,
            description="half of requests complete within 500ms"),
        SLO("latency_p99", "latency", target=0.99, threshold_s=15.0,
            description="99% of requests complete within 15s"),
        SLO("ttft_p95", "ttft", target=0.95, threshold_s=5.0,
            description="95% of streamed requests see a token within 5s"),
        SLO("availability", "availability", target=0.999,
            description="99.9% of requests finish without an error"),
        SLO("rejection_rate", "rejection", target=0.95,
            description="at most 5% of requests rejected on admission"),
    ]


class _Event:
    __slots__ = ("ts", "latency_s", "ok", "rejected", "ttft_s")

    def __init__(self, ts, latency_s, ok, rejected, ttft_s):
        self.ts = ts
        self.latency_s = latency_s
        self.ok = ok
        self.rejected = rejected
        self.ttft_s = ttft_s


class SLOEngine:
    """Evaluates a set of SLOs over a shared request-event stream.

    :param recorder: optional FlightRecorder — alert transitions become
        ring events (kind "slo_alert"/"slo_clear").
    :param postmortem_dir: when set, lifetime budget exhaustion bundles
        ONE postmortem per SLO (maybe_dump trigger "slo-budget-<name>").
    :param clock: injectable monotonic clock for tests.
    """

    def __init__(self, slos: Optional[List[SLO]] = None, recorder=None,
                 postmortem_dir: Optional[str] = None, clock=time.monotonic,
                 max_events: int = 65536, metrics_config: Optional[Dict] = None):
        self.slos = list(slos) if slos is not None else default_slos()
        self.recorder = recorder
        self.postmortem_dir = postmortem_dir
        self._clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(max_events))
        # engine-lifetime good/bad tallies per SLO (budget accounting
        # survives the bounded event ring)
        self._lifetime: Dict[str, List[int]] = {
            s.name: [0, 0] for s in self.slos  # [bad, total]
        }
        self._alerting: Dict[Tuple[str, str], bool] = {}
        self._exhausted: set = set()
        # registry-ingestion cursors: last cumulative counts per source
        self._cursor: Dict[str, float] = {}
        self._metrics_config = metrics_config or {}

    # ------------------------------------------------------------------
    # Feeds
    # ------------------------------------------------------------------

    def record(self, latency_s: Optional[float] = None, ok: bool = True,
               rejected: bool = False, ttft_s: Optional[float] = None,
               now: Optional[float] = None) -> None:
        """One request outcome. `latency_s` None = never completed (e.g.
        rejected on admission); `ttft_s` None = not streamed."""
        ev = _Event(self._clock() if now is None else now,
                    latency_s, bool(ok), bool(rejected), ttft_s)
        with self._lock:
            self._events.append(ev)
            for slo in self.slos:
                applicable, bad = self._judge(slo, ev)
                if applicable:
                    tally = self._lifetime[slo.name]
                    tally[0] += int(bad)
                    tally[1] += 1

    @staticmethod
    def _judge(slo: SLO, ev: _Event) -> Tuple[bool, bool]:
        """(applicable, bad) of one event under one SLO."""
        if slo.kind == "latency":
            if ev.latency_s is None:
                return False, False
            return True, ev.latency_s > slo.threshold_s
        if slo.kind == "ttft":
            if ev.ttft_s is None:
                return False, False
            return True, ev.ttft_s > slo.threshold_s
        if slo.kind == "availability":
            if ev.rejected:
                return False, False  # backpressure is not an outage
            return True, not ev.ok
        if slo.kind == "rejection":
            return True, ev.rejected
        return False, False

    def ingest_registry(self, metrics, now: Optional[float] = None) -> int:
        """Snapshot-diff an InferenceMetrics registry into events: new
        request_latency_seconds observations become latency events (bad
        split at the histogram bucket boundary nearest each latency SLO's
        threshold), ttft_seconds likewise, and requests_total /
        requests_rejected_total deltas become availability / rejection
        events. Returns how many events were synthesized. Poll cadence
        (the /metrics scrape or /debug/slo request) drives sampling."""
        now = self._clock() if now is None else now
        n = 0
        hists = metrics.histograms_snapshot()
        counters = metrics.counters_snapshot()
        n += self._ingest_histogram(hists, "request_latency_seconds",
                                    "latency", now)
        n += self._ingest_histogram(hists, "ttft_seconds", "ttft", now)
        n += self._ingest_outcomes(counters, now)
        return n

    def _slo_thresholds(self, kind: str) -> List[float]:
        return sorted({s.threshold_s for s in self.slos if s.kind == kind})

    def _ingest_histogram(self, hists, base: str, kind: str,
                          now: float) -> int:
        """Aggregate all series of `base` (labeled or not); emit one event
        per NEW observation, with its value approximated by the midpoint
        convention: good/bad is decided per-threshold from the bucket
        deltas, so each event carries the smallest threshold it violates
        (exact w.r.t. bucket boundaries)."""
        thresholds = self._slo_thresholds(kind)
        if not thresholds:
            return 0
        # merge counts across label sets
        merged_buckets: Optional[Tuple[float, ...]] = None
        merged = None
        for name, (buckets, counts, _total, _n) in hists.items():
            if name.split("{")[0] != base:
                continue
            if merged is None:
                merged_buckets = buckets
                merged = list(counts)
            else:
                for i, c in enumerate(counts):
                    merged[i] += c
        if merged is None:
            return 0
        n_emitted = 0
        # per-bucket cumulative delta since the last ingest
        for i, count in enumerate(merged):
            key = f"{base}[{i}]"
            prev = self._cursor.get(key, 0.0)
            delta = int(count - prev)
            self._cursor[key] = float(count)
            if delta <= 0:
                continue
            # the bucket's upper edge stands in for the value: exact for
            # threshold comparisons when thresholds align with edges
            value = (merged_buckets[i] if i < len(merged_buckets)
                     else float("inf"))
            for _ in range(delta):
                if kind == "latency":
                    self.record(latency_s=value, now=now)
                else:
                    self.record(ttft_s=value, now=now)
                n_emitted += 1
        return n_emitted

    def _ingest_outcomes(self, counters: Dict[str, float], now: float) -> int:
        n_emitted = 0
        for name, count in counters.items():
            base = name.split("{")[0]
            if base == "requests_total":
                outcome = "ok"
                if "{" in name and 'outcome="' in name:
                    outcome = name.split('outcome="', 1)[1].split('"', 1)[0]
                prev = self._cursor.get(name, 0.0)
                delta = int(count - prev)
                self._cursor[name] = float(count)
                for _ in range(max(delta, 0)):
                    self.record(ok=outcome in GOOD_OUTCOMES, now=now)
                    n_emitted += 1
            elif base == "requests_rejected_total":
                prev = self._cursor.get(name, 0.0)
                delta = int(count - prev)
                self._cursor[name] = float(count)
                for _ in range(max(delta, 0)):
                    self.record(rejected=True, now=now)
                    n_emitted += 1
        return n_emitted

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Burn rates for every (SLO, window), alert states, lifetime
        budget; fires flight-recorder transitions and the budget
        postmortem as side effects."""
        now = self._clock() if now is None else now
        with self._lock:
            events = list(self._events)
            lifetime = {k: tuple(v) for k, v in self._lifetime.items()}
        out: List[Dict[str, Any]] = []
        for slo in self.slos:
            budget = max(1.0 - slo.target, 1e-9)
            windows = []
            for wname, wsec in slo.windows():
                bad = total = 0
                cutoff = now - wsec
                for ev in reversed(events):
                    if ev.ts < cutoff:
                        break
                    applicable, is_bad = self._judge(slo, ev)
                    if applicable:
                        total += 1
                        bad += int(is_bad)
                frac = bad / total if total else 0.0
                burn = frac / budget
                alerting = total >= slo.min_events and burn >= slo.burn_alert
                self._note_transition(slo, wname, alerting, burn)
                windows.append({
                    "window": wname,
                    "window_s": wsec,
                    "events": total,
                    "bad": bad,
                    "bad_fraction": round(frac, 6),
                    "burn_rate": round(burn, 4),
                    "alerting": alerting,
                })
            lt_bad, lt_total = lifetime[slo.name]
            lt_frac = lt_bad / lt_total if lt_total else 0.0
            budget_spent = lt_frac / budget
            exhausted = lt_total >= slo.min_events and budget_spent >= 1.0
            if exhausted:
                self._maybe_budget_postmortem(slo, budget_spent, windows)
            out.append({
                "name": slo.name,
                "kind": slo.kind,
                "target": slo.target,
                "threshold_s": slo.threshold_s,
                "burn_alert": slo.burn_alert,
                "description": slo.description,
                "windows": windows,
                "burning": all(w["alerting"] for w in windows),
                "budget": {
                    "events": lt_total,
                    "bad": lt_bad,
                    "spent_fraction": round(budget_spent, 4),
                    "exhausted": exhausted,
                },
            })
        return {"ts": now, "slos": out}

    def _note_transition(self, slo: SLO, window: str, alerting: bool,
                         burn: float) -> None:
        key = (slo.name, window)
        prev = self._alerting.get(key, False)
        if alerting == prev:
            return
        self._alerting[key] = alerting
        if self.recorder is not None:
            self.recorder.record(
                "slo_alert" if alerting else "slo_clear",
                slo=slo.name, window=window, burn_rate=round(burn, 4),
            )

    def _maybe_budget_postmortem(self, slo: SLO, spent: float,
                                 windows: List[Dict]) -> None:
        if slo.name in self._exhausted:
            return
        self._exhausted.add(slo.name)
        if self.recorder is not None:
            self.recorder.record("slo_budget_exhausted", slo=slo.name,
                                 spent_fraction=round(spent, 4))
        if self.postmortem_dir is not None:
            logger.warning(
                f"SLO {slo.name} exhausted its error budget "
                f"({spent:.4f} spent); postmortem bundles are not ported yet "
                "(ROADMAP queue A, item 4.7)"
            )

    # ------------------------------------------------------------------
    # Output
    # ------------------------------------------------------------------

    def render_prometheus(self, ns: str = "trlx_tpu") -> str:
        """`slo_burn_rate{slo,window}` + alert/budget gauges, Prometheus
        text format, for concatenation onto a /metrics render."""
        report = self.evaluate()
        lines = [
            f"# HELP {ns}_slo_burn_rate error-budget burn rate per SLO and window",
            f"# TYPE {ns}_slo_burn_rate gauge",
        ]
        for slo in report["slos"]:
            for w in slo["windows"]:
                lines.append(
                    f'{ns}_slo_burn_rate{{slo="{slo["name"]}",'
                    f'window="{w["window"]}"}} {w["burn_rate"]}'
                )
        lines.append(f"# HELP {ns}_slo_burning 1 when every window of the SLO is alerting")
        lines.append(f"# TYPE {ns}_slo_burning gauge")
        for slo in report["slos"]:
            lines.append(
                f'{ns}_slo_burning{{slo="{slo["name"]}"}} {int(slo["burning"])}')
        lines.append(f"# HELP {ns}_slo_budget_spent_fraction lifetime error budget consumed (1.0 = exhausted)")
        lines.append(f"# TYPE {ns}_slo_budget_spent_fraction gauge")
        for slo in report["slos"]:
            lines.append(
                f'{ns}_slo_budget_spent_fraction{{slo="{slo["name"]}"}} '
                f'{slo["budget"]["spent_fraction"]}')
        return "\n".join(lines) + "\n"
