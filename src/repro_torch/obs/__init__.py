"""``repro_torch.obs`` — the unified telemetry layer: thread-safe
counters, nestable spans, and a Chrome-trace exporter, behind one
process-global registry.

Quick use (module-level API, bound to the global :data:`REGISTRY`)::

    from repro_torch import obs

    obs.counter("plan.cache.hits").add()
    with obs.span("plan.compile", cat="compile", graph=g.name):
        ...                      # timed region -> one trace event

Counters are always live — they are the system's bookkeeping.  Spans are
gated on ``TINA_TELEMETRY=off|on`` (default off; :func:`enable` /
:func:`disable` override at runtime): disabled, :func:`span` returns a
shared no-op context manager — no allocation, no clock read, no torch
call.  Enabled, a span also opens a ``torch.profiler`` host range of its
name, so a profiled run holds the program's spans on the profiler's
clock.  Export the collected spans with :func:`export_chrome_trace` and
open the file in ``chrome://tracing`` or https://ui.perfetto.dev
(``dsp_serve --trace out.json`` does this end to end).
"""
from repro_torch.obs.telemetry import (ENV_VAR, NULL_SPAN, REGISTRY, Counter,
                                       Histogram, Registry, Span)
from repro_torch.obs.trace import (chrome_trace, export_chrome_trace,
                                   validate_nesting)
# faults rides in obs because fault injection IS an observability
# concern: armed points meter through the same registry.  Imported after
# telemetry (faults imports repro_torch.obs.telemetry directly, not this
# package, to stay cycle-free).
from repro_torch.obs import faults
from repro_torch.obs.faults import InjectedFault

counter = REGISTRY.counter
span = REGISTRY.span
instant = REGISTRY.instant
complete = REGISTRY.complete
events = REGISTRY.events
enable = REGISTRY.enable
disable = REGISTRY.disable

__all__ = ["Counter", "Histogram", "Span", "Registry", "REGISTRY",
           "NULL_SPAN", "ENV_VAR", "counter", "span", "instant", "complete",
           "events", "enable", "disable", "chrome_trace",
           "export_chrome_trace", "validate_nesting", "faults",
           "InjectedFault"]
