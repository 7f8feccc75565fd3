"""Dependency-free Prometheus-text metrics for the inference server.

Counters, gauges, and fixed-bucket histograms behind one lock, rendered
in the Prometheus exposition format by `render()` — enough for a scrape
target without pulling in prometheus_client. Metric names are
namespaced `trlx_tpu_inference_*` at render time.

Labeled series: every write accepts an optional ``labels`` dict and the
registry stores the series under its full exposition name
(``name{k="v"}``, labels sorted) — one TYPE line per base name, one
sample line per label combination. The unlabeled API is the labels=None
case, unchanged.
"""

import threading
import time
from typing import Dict, List, Optional, Tuple


def dedupe_metadata(text: str) -> str:
    """Drop repeated `# HELP` / `# TYPE` lines for the same metric name.

    Concatenating independent registry renders (fleet/supervisor stitch
    per-replica registries plus their own series) repeats metadata for
    any series both sides export, which violates the exposition format
    ("Only one TYPE line may exist for a given metric name"). Keeps the
    FIRST occurrence of each (HELP|TYPE, metric) pair; sample lines pass
    through untouched."""
    seen = set()
    out: List[str] = []
    for line in text.split("\n"):
        if line.startswith("# TYPE ") or line.startswith("# HELP "):
            parts = line.split(" ", 3)  # "#", kind, metric, [rest]
            key = (parts[1], parts[2] if len(parts) > 2 else "")
            if key in seen:
                continue
            seen.add(key)
        out.append(line)
    return "\n".join(out)


def _series(name: str, labels: Optional[Dict[str, str]]) -> str:
    """Full exposition-format series name. Labels render sorted so the
    same logical series always maps to the same registry key; values are
    escaped per the Prometheus text format."""
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return name + "{" + ",".join(parts) + "}"

# log-ish spaced latency buckets: 1ms .. 60s
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0,
)

NAMESPACE = "trlx_tpu_inference"


class _Histogram:
    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +Inf tail
        self.total = 0.0
        self.n = 0
        # OpenMetrics exemplars: bucket index -> (value, trace_id, unix
        # ts) of the LAST traced observation that landed there. A p99
        # bucket on /metrics then links to the /debug/trace entry that
        # caused it.
        self.exemplars: Dict[int, Tuple[float, str, float]] = {}

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                self.counts[i] += 1
                idx = i
                break
        else:
            self.counts[-1] += 1
            idx = len(self.buckets)
        if trace_id:
            self.exemplars[idx] = (value, str(trace_id), time.time())
        self.total += value
        self.n += 1


class InferenceMetrics:
    """Thread-safe metric registry for one server instance."""

    def __init__(self, num_slots: int):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {"slots_total": float(num_slots)}
        self._hists: Dict[str, _Histogram] = {}
        # instantaneous throughput: EWMA over decode steps
        self._tokens_per_s = 0.0

    def inc(self, name: str, by: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        self.add(name, by, labels=labels)

    def add(self, name: str, by: float, labels: Optional[Dict[str, str]] = None) -> None:
        name = _series(name, labels)
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + by

    def set_counter(self, name: str, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        """Sync a counter to an absolute value — for tallies whose source
        of truth lives elsewhere (the engine's KV block pool) and are
        mirrored into the registry rather than accumulated here."""
        name = _series(name, labels)
        with self._lock:
            self._counters[name] = float(value)

    def set_gauge(self, name: str, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        name = _series(name, labels)
        with self._lock:
            self._gauges[name] = float(value)

    def get(self, name: str, labels: Optional[Dict[str, str]] = None) -> float:
        name = _series(name, labels)
        with self._lock:
            return self._counters.get(name, self._gauges.get(name, 0.0))

    def observe(self, name: str, value: float, labels: Optional[Dict[str, str]] = None,
                trace_id: Optional[str] = None) -> None:
        name = _series(name, labels)
        with self._lock:
            if name not in self._hists:
                self._hists[name] = _Histogram()
            self._hists[name].observe(value, trace_id=trace_id)

    def histograms_snapshot(self) -> Dict[str, Tuple[Tuple[float, ...], List[int], float, int]]:
        """{series name: (bucket edges, per-bucket counts incl. the +Inf
        tail, sum, count)} — the SLO engine's snapshot-diff feed."""
        with self._lock:
            return {
                name: (h.buckets, list(h.counts), h.total, h.n)
                for name, h in self._hists.items()
            }

    def counters_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def record_token_rate(self, tokens: int, step_seconds: float, alpha: float = 0.2) -> None:
        if step_seconds <= 0:
            return
        rate = tokens / step_seconds
        with self._lock:
            prev = self._tokens_per_s
            self._tokens_per_s = rate if prev == 0.0 else (1 - alpha) * prev + alpha * rate
            self._gauges["tokens_per_second"] = self._tokens_per_s

    def render(self) -> str:
        """Prometheus text exposition."""
        lines: List[str] = []
        with self._lock:
            seen_gauge_types = set()
            for name, value in sorted(self._gauges.items()):
                base = name.split("{")[0]
                if base not in seen_gauge_types:
                    seen_gauge_types.add(base)
                    lines.append(f"# TYPE {NAMESPACE}_{base} gauge")
                lines.append(f"{NAMESPACE}_{name} {value}")
            seen_types = set()
            for name, value in sorted(self._counters.items()):
                base = name.split("{")[0]
                if base not in seen_types:
                    seen_types.add(base)
                    lines.append(f"# TYPE {NAMESPACE}_{base} counter")
                lines.append(f"{NAMESPACE}_{name} {value}")
            seen_hist_types = set()
            for name, h in sorted(self._hists.items()):
                # labeled histograms fold `le` into the series' own label
                # set (base{k="v",le="..."}); unlabeled keep the plain form
                base, brace, label_body = name.partition("{")
                label_prefix = label_body[:-1] + "," if brace else ""
                if base not in seen_hist_types:
                    seen_hist_types.add(base)
                    lines.append(f"# TYPE {NAMESPACE}_{base} histogram")
                def _ex(idx: int) -> str:
                    # OpenMetrics exemplar: `... # {trace_id="..."} v ts`
                    # — links the bucket to the request trace that landed
                    # in it (resolvable via GET /debug/trace)
                    ex = h.exemplars.get(idx)
                    if ex is None:
                        return ""
                    value, trace_id, ts = ex
                    return f' # {{trace_id="{trace_id}"}} {value} {ts}'

                cum = 0
                for i, (edge, c) in enumerate(zip(h.buckets, h.counts)):
                    cum += c
                    lines.append(
                        f'{NAMESPACE}_{base}_bucket{{{label_prefix}le="{edge}"}} '
                        f'{cum}{_ex(i)}'
                    )
                cum += h.counts[-1]
                lines.append(
                    f'{NAMESPACE}_{base}_bucket{{{label_prefix}le="+Inf"}} '
                    f'{cum}{_ex(len(h.buckets))}'
                )
                suffix = "{" + label_body if brace else ""
                lines.append(f"{NAMESPACE}_{base}_sum{suffix} {h.total}")
                lines.append(f"{NAMESPACE}_{base}_count{suffix} {h.n}")
        return "\n".join(lines) + "\n"
