"""Dependency-free metrics registry with Prometheus text exposition.

Counterpart of dnet_tpu/obs/metrics.py, the same registry without its
runtime-sanitizer hooks (the sanitizer is not ported).  A minimal
in-process implementation of the three instrument kinds the serving path
needs — Counter, Gauge, Histogram — plus the v0.0.4 text exposition format
scraped at `GET /metrics` (api/http.py, shard/http.py).

Design constraints, in priority order:

- **Hot-path cheap.**  Observations happen per decode step / per frame; an
  observe is a lock acquire + one float add + one bisect.  No string work
  until exposition.
- **Process-global, never replaced.**  Instrumented modules hold family
  handles at import time; `MetricsRegistry.reset()` zeroes values in place
  so those handles never go stale (tests reset between cases).
- **Bounded cardinality.**  A labeled family caps its child count at
  ``MAX_SERIES_PER_METRIC``; past the cap, new label combinations collapse
  into a shared ``_overflow`` child instead of growing without bound (a
  per-nonce label bug must not OOM the server it was meant to observe).
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

METRIC_NAME_RE = re.compile(r"^dnet_[a-z0-9_]+$")

# Fixed ms-scale buckets: decode steps land in the 1-100ms decades, ring
# hops and prefills up to seconds; one shared scale keeps every latency
# histogram comparable on the same dashboard.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

OVERFLOW_LABEL = "_overflow"


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats print as integers."""
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...],
               extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += v

    def _reset(self) -> None:
        with self._lock:
            self.value = 0.0


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self.value -= v

    def _reset(self) -> None:
        with self._lock:
            self.value = 0.0


class _HistogramChild:
    __slots__ = ("_lock", "_edges", "counts", "sum", "count")

    def __init__(self, edges: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._edges = edges
        self.counts = [0] * (len(edges) + 1)  # per-bucket, +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.observe_n(v, 1)

    def observe_n(self, v: float, n: int) -> None:
        """n identical observations under ONE lock round-trip — the
        amortization convention (a fused R-step chunk or verify block
        records its per-token share tokens-served times) without n
        acquire/release cycles per dispatch."""
        if n <= 0:
            return
        # bucket semantics match Prometheus: le is INCLUSIVE (v == edge
        # lands in that bucket), everything past the last edge is +Inf
        i = bisect.bisect_left(self._edges, v)
        with self._lock:
            self.counts[i] += n
            self.sum += v * n
            self.count += n

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (0..1) by linear interpolation inside the
        containing bucket; observations in +Inf report the last finite
        edge (the histogram cannot see past it)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= target and c > 0:
                if i >= len(self._edges):
                    return self._edges[-1]
                lo = self._edges[i - 1] if i > 0 else 0.0
                hi = self._edges[i]
                frac = (target - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self._edges[-1]

    def _reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self._edges) + 1)
            self.sum = 0.0
            self.count = 0


_CHILD_CLS = {"counter": _CounterChild, "gauge": _GaugeChild,
              "histogram": _HistogramChild}


class MetricFamily:
    """One named metric: the unlabeled value itself, or a set of labeled
    children.  Convenience mutators (inc/set/observe/...) act on the
    default (label-less) child and raise on labeled families."""

    def __init__(
        self,
        name: str,
        kind: str,
        help_text: str,
        labelnames: Tuple[str, ...] = (),
        buckets: Optional[Tuple[float, ...]] = None,
        max_series: int = 64,
    ) -> None:
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {METRIC_NAME_RE.pattern}"
            )
        if not help_text.strip():
            raise ValueError(f"metric {name} needs a help string")
        if kind == "histogram":
            edges = tuple(float(b) for b in (buckets or DEFAULT_MS_BUCKETS))
            if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
                raise ValueError("histogram buckets must be strictly increasing")
            if any(math.isinf(b) for b in edges):
                raise ValueError("+Inf bucket is implicit; pass finite edges")
            self.buckets = edges
        else:
            if buckets is not None:
                raise ValueError(f"{kind} takes no buckets")
            self.buckets = None
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._lock = threading.Lock()
        self._children: "OrderedDict[Tuple[str, ...], object]" = OrderedDict()
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        cls = _CHILD_CLS[self.kind]
        return cls(self.buckets) if self.kind == "histogram" else cls()

    def labels(self, **kv: str):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_series:
                    # cardinality cap: collapse new combos into one shared
                    # overflow series rather than growing without bound
                    key = (OVERFLOW_LABEL,) * len(self.labelnames)
                    child = self._children.get(key)
                    if child is None:
                        child = self._new_child()
                        self._children[key] = child
                else:
                    child = self._new_child()
                    self._children[key] = child
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self._children[()]

    # -- unlabeled conveniences ----------------------------------------
    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def set(self, v: float) -> None:
        self._default().set(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def observe_n(self, v: float, n: int) -> None:
        self._default().observe_n(v, n)

    def percentile(self, q: float) -> float:
        return self._default().percentile(q)

    @property
    def value(self) -> float:
        return self._default().value

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum

    def series_count(self) -> int:
        with self._lock:
            return len(self._children)

    def reset(self) -> None:
        with self._lock:
            for child in self._children.values():
                child._reset()

    # -- exposition -----------------------------------------------------
    def expose_lines(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            if self.kind == "histogram":
                # snapshot under the child's lock: a scrape racing an
                # observe() must not emit a _count that disagrees with the
                # +Inf cumulative bucket (Prometheus invariant)
                with child._lock:
                    counts = list(child.counts)
                    h_sum = child.sum
                    h_count = child.count
                cum = 0
                for edge, c in zip(self.buckets, counts):
                    cum += c
                    ls = _label_str(self.labelnames, key, (("le", _fmt(edge)),))
                    yield f"{self.name}_bucket{ls} {cum}"
                cum += counts[-1]
                ls = _label_str(self.labelnames, key, (("le", "+Inf"),))
                yield f"{self.name}_bucket{ls} {cum}"
                ls = _label_str(self.labelnames, key)
                yield f"{self.name}_sum{ls} {_fmt(h_sum)}"
                yield f"{self.name}_count{ls} {h_count}"
            else:
                with child._lock:
                    value = child.value
                ls = _label_str(self.labelnames, key)
                yield f"{self.name}{ls} {_fmt(value)}"


class MetricsRegistry:
    """Name -> family map with idempotent registration and one exposition."""

    MAX_SERIES_PER_METRIC = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, MetricFamily]" = OrderedDict()

    def _register(
        self,
        name: str,
        kind: str,
        help_text: str,
        labelnames: Tuple[str, ...],
        buckets: Optional[Tuple[float, ...]],
    ) -> MetricFamily:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} already registered as {existing.kind}"
                        f"{existing.labelnames}; cannot re-register as "
                        f"{kind}{tuple(labelnames)}"
                    )
                return existing
            fam = MetricFamily(
                name, kind, help_text, tuple(labelnames), buckets,
                max_series=self.MAX_SERIES_PER_METRIC,
            )
            self._metrics[name] = fam
            return fam

    def counter(self, name: str, help_text: str,
                labelnames: Tuple[str, ...] = ()) -> MetricFamily:
        return self._register(name, "counter", help_text, labelnames, None)

    def gauge(self, name: str, help_text: str,
              labelnames: Tuple[str, ...] = ()) -> MetricFamily:
        return self._register(name, "gauge", help_text, labelnames, None)

    def histogram(
        self,
        name: str,
        help_text: str,
        labelnames: Tuple[str, ...] = (),
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> MetricFamily:
        return self._register(name, "histogram", help_text, labelnames, buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def families(self) -> Dict[str, MetricFamily]:
        with self._lock:
            return dict(self._metrics)

    def expose(self) -> str:
        """Prometheus text format v0.0.4, families in registration order."""
        with self._lock:
            fams = list(self._metrics.values())
        lines: list[str] = []
        for fam in fams:
            lines.extend(fam.expose_lines())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every value IN PLACE (families and children survive, so
        module-level handles taken at import stay valid)."""
        with self._lock:
            fams = list(self._metrics.values())
        for fam in fams:
            fam.reset()


CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"
