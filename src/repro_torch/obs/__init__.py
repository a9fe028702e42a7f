"""Observability on the simulated clock (``repro.obs``): tracing and one
metrics registry.

- :class:`Tracer`: nested spans, instants and counters on the simulated
  clock, off by default (every layer holds ``tracer = None`` and guards each
  emission), free when disabled;
- :class:`MetricsRegistry`: the one store behind every stats surface of the
  stack; ``snapshot()`` on a root registry reports a whole fleet at once;
- :func:`write_chrome_trace`: Perfetto-loadable Chrome trace-event JSON, one
  track per client, replica and resource.
"""
from repro_torch.obs.export import to_chrome_trace, write_chrome_trace
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RegistryBackedStats,
    percentile,
)
from repro_torch.obs.trace import CounterSample, Instant, Span, Tracer

__all__ = [
    "Counter",
    "CounterSample",
    "Gauge",
    "Histogram",
    "Instant",
    "MetricsRegistry",
    "RegistryBackedStats",
    "Span",
    "Tracer",
    "percentile",
    "to_chrome_trace",
    "write_chrome_trace",
]
