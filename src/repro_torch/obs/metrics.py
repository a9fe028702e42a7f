"""One registry for every counter in the stack (``repro.obs.metrics``).

:class:`MetricsRegistry` is the single store behind every stats surface:
layers receive a *scoped view* (``registry.scope("r0").scope("cache")``) and
create counters, gauges and histograms under their prefix, so one
``snapshot()`` on the root reports RPC counts, wire bytes, batch widths,
hedge and migration counts and cache hit rates together.

The stats classes (``InferenceStats``, ``CacheStats``, ``BatcherStats``,
``AdmissionStats``, ``HedgeStats``, ``FleetStats``, ``ReplannerStats``) are
:class:`RegistryBackedStats` subclasses: attribute reads and ``+=`` bumps
route into registry counters, so every call site (``stats.rpcs += 1``,
``fleet.stats.migrations``) keeps its attribute syntax while the numbers
live in the registry.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union


class Counter:
    """A scalar that is bumped (or assigned directly)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: Union[int, float] = 0):
        self.name = name
        self.value = value


class Gauge:
    """A last-write-wins scalar (queue depth, busy fraction, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0.0):
        self.name = name
        self.value = value

    def set(self, value: float) -> None:
        self.value = value


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile of ``values`` (0 <= q <= 100)."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


class Histogram:
    """A value series with p50/p95/p99 summaries.

    ``values`` is a plain list: ``stats.latencies`` and ``batch_sizes`` alias
    it, so their ``.append`` and slicing call sites keep working."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, value: float) -> None:
        self.values.append(value)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return float(sum(self.values))

    @property
    def mean(self) -> float:
        return self.sum / len(self.values) if self.values else 0.0

    @property
    def p50(self) -> float:
        return percentile(self.values, 50)

    @property
    def p95(self) -> float:
        return percentile(self.values, 95)

    @property
    def p99(self) -> float:
        return percentile(self.values, 99)

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.p50,
            "p95": self.p95,
            "p99": self.p99,
        }


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Shared metric store; ``scope(name)`` returns a prefixed view.

    All scopes share one dict, so a counter created through
    ``fleet.scope("r0").scope("cache")`` shows in a root ``snapshot()`` under
    the key ``"r0.cache.<name>"``."""

    def __init__(self, _store: Optional[Dict[str, Metric]] = None, _prefix: str = ""):
        self._store: Dict[str, Metric] = _store if _store is not None else {}
        self._prefix = _prefix

    def scope(self, name: str) -> "MetricsRegistry":
        return MetricsRegistry(self._store, f"{self._prefix}{name}.")

    def _key(self, name: str) -> str:
        return self._prefix + name

    def counter(self, name: str, default: Union[int, float] = 0) -> Counter:
        key = self._key(name)
        m = self._store.get(key)
        if m is None:
            m = self._store[key] = Counter(key, default)
        return m  # type: ignore[return-value]

    def gauge(self, name: str) -> Gauge:
        key = self._key(name)
        m = self._store.get(key)
        if m is None:
            m = self._store[key] = Gauge(key)
        return m  # type: ignore[return-value]

    def histogram(self, name: str) -> Histogram:
        key = self._key(name)
        m = self._store.get(key)
        if m is None:
            m = self._store[key] = Histogram(key)
        return m  # type: ignore[return-value]

    def _items(self) -> Iterator[Tuple[str, Metric]]:
        n = len(self._prefix)
        for key, m in self._store.items():
            if key.startswith(self._prefix):
                yield key[n:], m

    def snapshot(self) -> Dict[str, Any]:
        """Flat ``{name: value}`` view of this scope's subtree; a histogram
        reports its count/mean/p50/p95/p99 summary dict."""
        out: Dict[str, Any] = {}
        for name, m in sorted(self._items()):
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out


class RegistryBackedStats:
    """Base of the stats classes: the declared ``_fields`` are registry
    counters while attribute syntax (``stats.rpcs += 1``, ``stats.hits``)
    works as on a plain object.

    Subclasses declare ``_fields`` as ``(name, default)`` pairs; any other
    attribute set on the instance is a plain attribute.  Each instance owns
    (or is handed) a :class:`MetricsRegistry` scope, so two stats objects
    never collide even when they share a root store.  The field counters are
    looked up once, at construction: a bump is a dict lookup, not a scan of
    ``_fields``."""

    _fields: Tuple[Tuple[str, Union[int, float]], ...] = ()

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        registry = registry if registry is not None else MetricsRegistry()
        object.__setattr__(self, "registry", registry)
        object.__setattr__(self, "_counters", {
            name: registry.counter(name, default) for name, default in self._fields
        })

    def __getattr__(self, name: str) -> Any:
        # only reached when normal lookup fails, i.e. for the field names
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            return counters[name].value
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            counters[name].value = value
            return
        object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, Any]:
        """The fields and their values, in declaration order."""
        return {name: c.value for name, c in self._counters.items()}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.as_dict().items())
        return f"{type(self).__name__}({body})"
