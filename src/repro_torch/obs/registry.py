"""Lightweight in-process metrics registry (counterpart of
``repro.obs.registry``; DESIGN.md §8).

Three instrument types over one namespace:

* :class:`Counter` — monotone totals (``inc(amount, **labels)``);
* :class:`Gauge` — last-write-wins level (``set(value, **labels)``);
* :class:`Histogram` — bucketed distribution (``observe(value, **labels)``)
  with fixed upper bounds plus a ``+Inf`` overflow bucket, carrying
  count and sum like a Prometheus histogram.

Labels are keyword arguments; each distinct label set is an independent
series under the instrument's name.  Instrument creation is idempotent —
asking for an existing name returns the same instrument (a type mismatch
raises) — so collectors can declare their instruments unconditionally.

Zero-cost when disabled: ``MetricsRegistry(enabled=False)`` hands every
request the shared no-op instrument of the right type, so instrumented
code paths pay one attribute call and nothing else.  ``snapshot()``
returns a :class:`MetricsSnapshot` — an immutable deep copy safe to hold
across further updates (it is what ``Solver.metrics()`` /
``SolverService.metrics()`` and ``ProgressEvent.metrics`` expose).

Everything here is plain host-side Python, nothing on the device path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsSnapshot",
]

#: Default histogram bucket upper bounds (powers of two suit depths/sizes).
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotone counter; one value per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0)


class Gauge:
    """Last-write-wins level; one value per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = value

    def value(self, **labels) -> Optional[float]:
        return self._values.get(_label_key(labels))


class Histogram:
    """Bucketed distribution with count/sum, per label set.

    ``buckets`` are inclusive upper bounds; observations above the last
    bound land in the implicit ``+Inf`` bucket.  Bucket counts are
    NON-cumulative (each observation increments exactly one bucket).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(
                f"histogram {name} needs ascending buckets, got {buckets}")
        self.name, self.help = name, help
        self.buckets = tuple(buckets)
        # key -> [bucket counts..., +Inf count, total count, total sum]
        self._series: Dict[LabelKey, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        row = self._series.get(key)
        if row is None:
            row = self._series[key] = [0] * (len(self.buckets) + 1) + [0, 0.0]
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                row[i] += 1
                break
        else:
            row[len(self.buckets)] += 1
        row[-2] += 1
        row[-1] += value

    def value(self, **labels) -> Optional[dict]:
        row = self._series.get(_label_key(labels))
        if row is None:
            return None
        return {
            "count": row[-2],
            "sum": row[-1],
            "buckets": dict(zip([*map(str, self.buckets), "+Inf"],
                                row[:len(self.buckets) + 1])),
        }


class _NullInstrument:
    """Shared do-nothing instrument handed out by a disabled registry."""

    name, help, kind = "<disabled>", "", "null"

    def inc(self, amount: float = 1, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value: float, **labels) -> None:
        pass

    def value(self, **labels) -> None:
        return None


_NULL = _NullInstrument()


class MetricsSnapshot:
    """Immutable point-in-time copy of a registry's series.

    ``value(name, **labels)`` returns the series value (0 for a counter
    that never incremented, None for an unknown gauge/histogram series);
    ``to_dict()`` renders everything as plain JSON-able data.
    """

    def __init__(self, data: Dict[str, dict]):
        self._data = data

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._data))

    def value(self, name: str, **labels):
        entry = self._data.get(name)
        if entry is None:
            return 0
        got = entry["series"].get(_label_key(labels))
        if got is None:
            return 0 if entry["kind"] == "counter" else None
        return got

    def to_dict(self) -> dict:
        out = {}
        for name, entry in sorted(self._data.items()):
            out[name] = {
                "kind": entry["kind"],
                "series": [
                    {"labels": dict(key), "value": val}
                    for key, val in sorted(entry["series"].items())
                ],
            }
        return out


class MetricsRegistry:
    """One namespace of instruments; disabled registries are no-ops."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._instruments: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        if not self.enabled:
            return _NULL
        inst = self._instruments.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}")
            return inst
        inst = cls(name, help, **kw)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> MetricsSnapshot:
        data: Dict[str, dict] = {}
        for name, inst in self._instruments.items():
            if isinstance(inst, Histogram):
                series = {key: inst.value(**dict(key))
                          for key in inst._series}
            else:
                series = dict(inst._values)
            data[name] = {"kind": inst.kind, "series": series}
        return MetricsSnapshot(data)
