"""Metrics registry: counters/gauges/histograms with labels.

One registry instance holds a set of named metric families; each family
holds one numeric child per label-value combination. The design is the
Prometheus client model cut down to what the serving stack needs:

  * hot paths never touch the registry — engines keep plain Python int
    counters and publish them in bulk through ``export_counters`` at
    snapshot time (pull-based, zero per-token cost),
  * ``snapshot()`` returns a flat plain dict (the programmatic surface the
    benches and tests consume),
  * ``prometheus_text()`` renders the text exposition format, and
    ``parse_prometheus`` round-trips it (the CI step validates a serve
    run's exposition parses back to the same values).

``export_counters`` derives the metric names mechanically from the
``Engine.counters()`` key set with a ``repro_`` prefix, the reference
package's names, so one dashboard reads either package. The module is the
reference's (``repro.obs.metrics``), numpy-free host Python; the port keeps
its own copy, and its exposition text is byte for byte the reference's for
the same counters.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

# counters() keys that are point-in-time levels, not monotonic totals —
# exported as prometheus gauges; everything else is a counter.
GAUGE_KEYS = frozenset({
    "requests_active", "requests_pending", "requests_prefilling",
    "occupancy", "occupancy_hwm", "committed_occupancy",
    "pages_used", "pages_free", "pages_shared", "pages_pinned",
    "frag_tokens", "peak_active", "peak_pages",
    "pages_quant", "pages_quant_used", "quant_occupancy",
    "replicas", "replicas_alive",
    # reliability layer: current overload level and the
    # aggregate conformal virtual-queue price are levels, not totals
    "degrade_level", "slo_pressure",
})

DEFAULT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, float("inf"))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _label_key(label_names: Sequence[str], labels: dict) -> tuple:
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(label_names)}")
    return tuple(str(labels[k]) for k in label_names)


def _render_labels(label_names: Sequence[str], values: tuple) -> str:
    if not label_names:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in zip(label_names, values,
                                                  strict=True))
    return "{" + inner + "}"


class Metric:
    """One counter/gauge family: a name plus per-label-value children."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(self.label_names, labels)
        self._children[key] = self._children.get(key, 0.0) + n

    def set(self, value: float, **labels) -> None:
        self._children[_label_key(self.label_names, labels)] = float(value)

    def get(self, **labels) -> float:
        return self._children.get(_label_key(self.label_names, labels), 0.0)

    def samples(self) -> list:
        """[(name, label_values, value)] — the exposition's raw rows."""
        return [(self.name, key, v)
                for key, v in sorted(self._children.items())]


class Gauge(Metric):
    kind = "gauge"


class Histogram(Metric):
    """Cumulative-bucket histogram (prometheus semantics: le = upper bound,
    buckets are cumulative, +Inf bucket == _count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        b = sorted(float(x) for x in buckets)
        if not b or b[-1] != float("inf"):
            b.append(float("inf"))
        self.buckets = tuple(b)
        # child: [counts per bucket, sum, count]
        self._children: dict[tuple, list] = {}

    def observe(self, x: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = [[0] * len(self.buckets), 0.0, 0]
        counts, _, _ = child
        for i, ub in enumerate(self.buckets):
            if x <= ub:
                counts[i] += 1
        child[1] += float(x)
        child[2] += 1

    def get(self, **labels):
        key = _label_key(self.label_names, labels)
        child = self._children.get(key)
        if child is None:
            return {"count": 0, "sum": 0.0}
        return {"count": child[2], "sum": child[1]}

    def samples(self) -> list:
        out = []
        for key, (counts, total, count) in sorted(self._children.items()):
            for ub, c in zip(self.buckets, counts, strict=True):
                le = "+Inf" if ub == float("inf") else format(ub, "g")
                out.append((f"{self.name}_bucket", key + (("le", le),), c))
            out.append((f"{self.name}_sum", key, total))
            out.append((f"{self.name}_count", key, count))
        return out


class MetricsRegistry:
    """Named metric families; one instance per serving process (or test)."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get_or_make(self, cls, name, help, labels, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, labels, **kw)
        elif type(m) is not cls:
            raise ValueError(f"metric {name!r} already registered as {m.kind}")
        elif tuple(labels) != m.label_names:
            raise ValueError(f"metric {name!r} re-registered with different "
                             f"labels {tuple(labels)} != {m.label_names}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Metric:
        return self._get_or_make(Metric, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    # ---------------------------------------------------------- exports
    def snapshot(self) -> dict:
        """Flat {'name{k="v"}': value} dict over every sample."""
        out = {}
        for m in self._metrics.values():
            for name, key, value in m.samples():
                if key and isinstance(key[-1], tuple):  # histogram le pair
                    *vals, (lk, lv) = key
                    labels = _render_labels(
                        tuple(m.label_names) + (lk,), tuple(vals) + (lv,))
                else:
                    labels = _render_labels(m.label_names, key)
                out[name + labels] = value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            lines.append(f"# HELP {m.name} {m.help or m.name}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for sample, key, value in m.samples():
                if key and isinstance(key[-1], tuple):
                    *vals, (lk, lv) = key
                    labels = _render_labels(
                        tuple(m.label_names) + (lk,), tuple(vals) + (lv,))
                else:
                    labels = _render_labels(m.label_names, key)
                lines.append(f"{sample}{labels} {format(float(value), 'g')}")
        return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Parse a text exposition back into {'name{labels}': float}.

    Strict enough to be the CI validator: every non-comment line must be a
    well-formed sample with a finite-or-Inf float value; malformed lines
    raise ValueError. Round-trips ``MetricsRegistry.prometheus_text``.
    """
    out = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels = m.group("labels") or ""
        if labels:
            body = labels[1:-1]
            stripped = _LABEL_RE.sub("", body).replace(",", "").strip()
            if stripped:
                raise ValueError(f"line {lineno}: malformed labels {labels!r}")
        try:
            value = float(m.group("value"))
        except ValueError as e:
            raise ValueError(f"line {lineno}: bad value "
                             f"{m.group('value')!r}") from e
        out[m.group("name") + labels] = value
    return out


def export_counters(registry: MetricsRegistry, counters: dict,
                    labels: Optional[dict] = None,
                    prefix: str = "repro_") -> MetricsRegistry:
    """Publish an ``Engine.counters()``-shaped dict into a registry.

    Monotonic keys become counters (set to the running total), level keys
    (``GAUGE_KEYS``) become gauges; ``labels`` (e.g. {"replica": "0"})
    label every sample. The helper is how 'migrate every ad-hoc counter
    onto the registry' stays one line per snapshot site.
    """
    labels = dict(labels or {})
    names = tuple(sorted(labels))
    for key in sorted(counters):
        value = counters[key]
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        name = prefix + key
        if key in GAUGE_KEYS:
            registry.gauge(name, f"engine gauge {key}", names).set(
                float(value), **labels)
        else:
            registry.counter(name, f"engine counter {key}", names).set(
                float(value), **labels)
    return registry
