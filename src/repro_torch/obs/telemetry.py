"""Telemetry core: thread-safe counters, histograms, and nestable spans
behind one process-global registry.

Cheap by construction:

  * **Counters are always live.**  They are the system's bookkeeping —
    the plan cache's hit/miss counts, the autotuner's measured/cached
    tallies — so they cannot be the thing an env var turns off.  Each is
    one lock acquisition per update.  A :class:`Histogram` (a service's
    latency books) is the same: one lock and one ring-buffer slot.
  * **Spans are gated.**  ``TINA_TELEMETRY=off`` (the default) makes
    :meth:`Registry.span` return one shared no-op context manager —
    no object allocated, no clock read, no torch call — so production
    pays only the boolean check.  ``TINA_TELEMETRY=on`` (or
    :func:`enable`) records every span as a Chrome trace event
    (wall-relative microsecond timestamps, per-thread track) exportable
    via :mod:`repro_torch.obs.trace`, and opens a ``torch.profiler``
    host range of the same name for the span's extent
    (``RecordFunction``).  Under a running profiler the span therefore
    sits in the profiler's own trace, on its clock, around the ops and
    launches it issued, with no clock conversion; with no profiler
    running the range costs well under a microsecond.  On the card the
    profiler also draws such a range on the device timeline as a
    ``gpu_user_annotation``: a range, not device work.

Spans nest naturally: within one thread, a span entered inside another
span's ``with`` block is fully contained in it on the trace timeline
(``perf_counter_ns`` is monotonic per thread), which is exactly the
nesting Perfetto renders — no explicit parent bookkeeping needed.  The
profiler ranges nest the same way: each opens before its span's clock
starts and closes after it stops.

The event buffer is bounded (:attr:`Registry.max_events`); once full,
further spans are counted in ``dropped_events`` instead of growing
memory without bound under a long soak.
"""
from __future__ import annotations

import os
import threading
import time

from torch._C._profiler import _RecordFunctionFast

ENV_VAR = "TINA_TELEMETRY"


def _env_enabled() -> bool:
    v = os.environ.get(ENV_VAR, "off").strip().lower()
    if v not in ("off", "on"):
        raise ValueError(f"{ENV_VAR}={v!r}: expected off or on")
    return v == "on"


# ---------------------------------------------------------------------------
# meters
# ---------------------------------------------------------------------------
class Counter:
    """Monotonic (reset-able) integer counter; ``add`` is atomic."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Histogram:
    """Streaming histogram: exact count/sum/min/max plus a bounded
    ring-buffer sample for quantile export (p50/p95/p99).

    The ring buffer keeps the most recent ``sample_size`` observations —
    under steady-state serving that is a sliding window, which is what a
    latency percentile should describe anyway.  O(1) per record; the
    sort cost is paid at :meth:`summary` time, not on the hot path.
    """

    __slots__ = ("name", "unit", "sample_size", "_lock", "_count", "_sum",
                 "_min", "_max", "_sample", "_idx")

    def __init__(self, name: str, unit: str = "", sample_size: int = 4096):
        self.name = name
        self.unit = unit
        self.sample_size = int(sample_size)
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._sample: list[float] = []
        self._idx = 0

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._sample) < self.sample_size:
                self._sample.append(v)
            else:                      # overwrite oldest: sliding window
                self._sample[self._idx] = v
                self._idx = (self._idx + 1) % self.sample_size

    def summary(self) -> dict:
        """count/mean/min/max + p50/p95/p99 (None when empty)."""
        with self._lock:
            n, s = self._count, self._sum
            lo = self._min if n else None
            hi = self._max if n else None
            sample = list(self._sample)
        out = {"count": n, "mean": (s / n if n else None),
               "min": lo, "max": hi}
        if sample:
            sample.sort()
            last = len(sample) - 1
            for q, k in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                out[k] = sample[min(last, max(0, round(q * last)))]
        else:
            out.update(p50=None, p95=None, p99=None)
        if self.unit:
            out["unit"] = self.unit
        return out


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class _NullSpan:
    """The disabled-mode span: one shared instance, no state, no clock
    reads.  ``set`` swallows attribute updates so instrumented code
    never branches on the telemetry mode."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """A timed region: records one Chrome ``"X"`` (complete) event on
    exit — also on exception, so a failed batch still shows up on the
    trace (the exception propagates; ``__exit__`` returns False) — and
    holds a ``torch.profiler`` host range of the same name open around
    its clock (module docstring)."""

    __slots__ = ("name", "cat", "args", "_reg", "_t0", "_range")

    def __init__(self, registry: "Registry", name: str, cat: str,
                 args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self._reg = registry
        self._t0 = 0
        self._range = None

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._range.__exit__(None, None, None)
        self._reg._push(("X", self.name, self.cat, self._t0, t1,
                         threading.get_ident(), *_flat(self.args)))
        return False


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
class Registry:
    """Named counters + the span/event buffer.  One process-global
    instance (:data:`REGISTRY`) backs the module-level API; tests build
    private ones."""

    def __init__(self, enabled: bool | None = None,
                 max_events: int = 500_000):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        # (ph, name, cat, t0 ns, t1 ns | None, tid, key, value, ...) per
        # event, made Chrome trace dicts only when read.  A span adds one
        # object, a tuple the collector stops tracking at its first pass
        # (it holds only strings and numbers), so a long traced window
        # neither lengthens full collections nor runs many more
        self._events: list[tuple] = []
        self._dropped = 0
        self.max_events = int(max_events)
        self._t0_ns = time.perf_counter_ns()
        self._on = _env_enabled() if enabled is None else bool(enabled)

    # -- counters (get-or-create) -------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    # -- spans / events -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._on

    def enable(self) -> None:
        self._on = True

    def disable(self) -> None:
        self._on = False

    def span(self, name: str, cat: str = "span", **args):
        """A context manager timing the enclosed region.  Disabled mode
        returns the shared :data:`NULL_SPAN` — nothing is allocated, and
        no profiler range is opened."""
        if not self._on:
            return NULL_SPAN
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "span", **args) -> None:
        """A zero-duration marker (Chrome ``"i"`` event) — autotune
        winner records, downgrade notices, ..."""
        if not self._on:
            return
        self._push(("i", name, cat, time.perf_counter_ns(), None,
                    threading.get_ident(), *_flat(args)))

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 cat: str = "span", tid: int | str | None = None,
                 **args) -> None:
        """Record a complete ("X") span from explicit ``perf_counter_ns``
        endpoints — for regions whose start and end are observed on
        different threads or reconstructed after the fact (e.g. the
        overlapped scheduler's device occupancy, which is dispatched on
        the batcher thread but retired when the array is ready).  An
        explicit ``tid`` places the span on a synthetic track (Chrome
        accepts string tids) so it nests independently of any host
        thread's spans.  Buffer only: no profiler range is opened, since
        a range opens and closes on one thread."""
        if not self._on:
            return
        self._push(("X", name, cat, t0_ns, max(t0_ns, t1_ns),
                    threading.get_ident() if tid is None else tid,
                    *_flat(args)))

    def _push(self, event: tuple) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(event)

    def events(self) -> list[dict]:
        """The buffered trace events as Chrome trace dicts (new dicts on
        every call): microseconds since the registry was made, this
        process's pid, the recording thread's track."""
        with self._lock:
            recs = list(self._events)
        pid = os.getpid()
        out = []
        for ph, name, cat, t0, t1, tid, *kv in recs:
            e = {"name": name, "cat": cat, "ph": ph,
                 "ts": (t0 - self._t0_ns) / 1e3}
            if t1 is None:
                e["s"] = "t"
            else:
                e["dur"] = (t1 - t0) / 1e3
            e.update(pid=pid, tid=tid, args=dict(zip(kv[::2], kv[1::2])))
            out.append(e)
        return out

    @property
    def dropped_events(self) -> int:
        with self._lock:
            return self._dropped


def _flat(args: dict):
    """``args``' keys and JSON-ready values, alternating: read when the
    event is recorded, and only strings and numbers kept."""
    for k, v in args.items():
        yield k
        yield _jsonable(v)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


REGISTRY = Registry()

__all__ = ["Counter", "Histogram", "Span", "Registry",
           "REGISTRY", "NULL_SPAN", "ENV_VAR"]
