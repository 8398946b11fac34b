"""Batched pipeline serving: queue requests, pack them into fixed-shape
batches, run one cached plan per batch -- on the card unless the caller
asks for the CPU.

Fixed shapes are the whole point: every batch is padded to a
pre-compiled shape, so after warm-up every execution is a plan-cache hit
(no compile while serving).  Two batching policies:

``batching="fixed"`` (the default) -- every batch pads to exactly
``(batch_size, signal_len)`` through ONE plan.  The batcher waits up to
``max_wait_ms`` per request to fill a batch before dispatching a partial
(padded) one.

``batching="continuous"`` -- the scheduler forms the **largest
admissible batch the moment the executor goes idle** (bounded by the
tenant's ``batch_size``; an idle device never waits for a full batch),
and executes it against a ladder of pre-compiled bucket plans
(1/2/4/.../batch_size, each a cached ``graph.compile``), padding only up
to the next bucket.  Futures complete per request.

**Overlapped (double-buffered) scheduling** -- ``overlap=True`` (the
default under ``batching="continuous"``): while batch N runs on the
card, the batcher thread forms and packs batch N+1 on the host and
enqueues it before it waits on batch N.  The reference gets this from
JAX's async dispatch; here it is explicit.  Each service has one CUDA
stream per card, and every dispatch (the batcher's and ``flush()``'s)
runs under it: a batch is packed into one of two reused page-locked
staging buffers of its bucket (refilled only once a CUDA event shows its
last copy to the card finished), copied in ``non_blocking``, run through
the plan (every kernel wrapper launches on the current stream), and
copied back ``non_blocking`` into a reused page-locked output buffer of
its bucket; an event recorded after that copy is what
``_Inflight.ready()`` queries and ``_complete`` waits on.  At delivery
each request's row is copied out of that buffer into host memory of its
own, and only then does the buffer go back to its bucket: a result owns
its memory, as the reference's ``np.asarray(out)`` does, and a result a
client keeps pins nothing.  The plans are the plan cache's own entries,
the ones an offline ``graph.compile`` with the same options returns.
Device occupancy is traced on a synthetic ``"device"``
track from host timestamps, as in the reference (start clamped to the
previous batch's completion); each batch also records CUDA events, so
``stats()["card_ms"]`` holds the card's own copy-in, plan and copy-out
ms, beside the host's ms per part in ``stats()["host_ms"]``.  Failures
fall back to the synchronous recovery path (retry -> degrade -> bisect).

**Multi-tenant serving** -- the constructor's graph becomes the
``"default"`` tenant; :meth:`PipelineService.add_tenant` compiles more
pipelines (each with its own signal length, bucket ladder and
:class:`~repro_torch.graph.plan.CompileOptions`; identical graphs and
shapes share plans through the plan cache).  ``submit`` routes by
``tenant=`` name, and every request carries a **priority class**:
``"rt"`` jumps the queue ahead of ``"batch"`` (strict priority over
queue order, never preemption of a running batch).  A batch is always
single-tenant.  Replay verification is bit for bit per tenant
(:func:`replay_batches`).

Three drive modes: synchronous (``submit()`` then ``flush()``),
background (``start()`` spawns the batcher thread) and asyncio
(``await svc.submit_async(x)``; ``async with PipelineService(...)``).

``submit`` returns a ``concurrent.futures.Future`` resolving to that
request's output row (a numpy array) **or a typed exception**
(:mod:`repro_torch.graph.errors`).

Fault tolerance (every behavior testable via
:mod:`repro_torch.obs.faults`):

  * **Admission** -- ``queue_limit=`` bounds the queue; ``on_full`` is
    ``"block"``, ``"shed"`` (the future fails with :class:`Overloaded`)
    or ``"raise"``.
  * **Deadlines** -- requests still queued past ``deadline_ms`` fail
    with :class:`DeadlineExceeded` before consuming a device slot.
  * **Validation** -- ``validate="strict"`` rejects non-finite payloads
    at submit with :class:`InvalidRequest`.
  * **Retry / poison isolation** -- a failed batch retries with capped
    exponential backoff; persistent injected faults skip the retries.
    A batch that still fails is **bisected** down to its poisoned rows;
    healthy rows get their results.
  * **Degradation** -- a bucket whose plan keeps failing
    (``degrade_after`` consecutive post-retry failures) is recompiled
    once, recorded on the tenant's ``downgrades``, warned and counted: on
    the CPU with ``lowering="reference"`` (``native``) at f32; on the
    card at f32 with its own lowering, so a ``kernel`` bucket still runs
    the hand-written kernels.  A card bucket that asks for f32 already
    never degrades: the plain version does not stand in for a kernel
    that fails, and the batch's futures get the kernel's error.
  * **A lost CUDA context** (an illegal address, a launch failure) is
    not retried, bisected or degraded: no later call on the card can
    succeed.  Every future of that batch and of every later one fails
    with the original exception.

Telemetry: ``service.stats()`` returns one consistent locked snapshot:
request/batch/padding counters, per-priority and per-tenant counts, the
fault-tolerance counters (``shed`` / ``expired`` / ``retries`` /
``quarantined`` / ``degraded`` / ``invalid``), queue depth, fill ratio,
the request-latency histograms (``total``/``queued``/``pad``/
``device``) and the per-part host and card ms above.  With
``TINA_TELEMETRY=on`` every batch emits ``service.dispatch`` /
``service.pack`` / ``service.device_run`` spans, and the recovery
machinery ``service.retry`` / ``service.bisect`` spans and
``service.quarantine`` / ``service.degrade`` instants.

Lifecycle: ``start`` -> ``submit``/... -> ``close``.  ``flush()`` on a
started service raises (two consumers would split a batch).  ``close()``
stops the thread (the in-flight batch is completed first), wakes any
submitter blocked at admission, and marks the service closed.

Sharded mode: ``mesh=`` (a BatchMesh or a device count) shards every
batch's leading axis across the mesh.  The tenant normalizes the mesh
once, and the continuous ladder starts at the shard count
(``bucket_ladder(batch_size, shards)``), so every bucket splits evenly.
The service keeps one CUDA stream per device of the mesh; a batch is
packed into one staging buffer, shard i's rows are copied from it to
device i, the plan's ``run_shards`` runs each shard on a stream of its
own (ordered after the service's stream of that device), and each
shard's output is copied back into its rows of the bucket's page-locked
output buffer.  A batch is done when every device's copy out is; its
card ms for a part is the slowest device's (on one card the service's
stream spans every shard, so its plan part is the slowest shard's).
"""
from __future__ import annotations

import asyncio
import bisect
import contextlib
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch import obs
from repro_torch.graph import plan as plan_lib
from repro_torch.graph.errors import (DeadlineExceeded, InvalidRequest,
                                      Overloaded)
from repro_torch.graph.graph import Graph
from repro_torch.launch.mesh import Shards
from repro_torch.obs import faults

#: Priority classes, highest first: ``"rt"`` requests preempt queue
#: order over ``"batch"`` requests (never a running batch).
PRIORITIES = ("rt", "batch")

# _get() outcomes that aren't requests: nothing arrived within the
# timeout / the service is stopping and the queue is fully drained
_EMPTY = object()
_STOPPED = object()

# the host's and the card's parts of one batch (stats()["host_ms"] and
# stats()["card_ms"]); the host's copy_out is the copy's enqueue, the
# card's the transfer itself; deliver copies each row out of the
# page-locked output buffer into memory of its own
HOST_PARTS = ("pack", "copy_in", "plan", "copy_out", "deliver")
CARD_PARTS = ("copy_in", "plan", "copy_out", "batch")


def bucket_ladder(max_batch: int, shards: int = 1) -> tuple[int, ...]:
    """The pre-compiled batch sizes of a continuous batcher: shard-count,
    doubling up to ``max_batch`` (which is always the top rung).  With
    ``shards=1`` this is the classic 1/2/4/.../max ladder; a sharded
    service would start at ``shards`` so every bucket splits evenly."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if shards < 1 or shards > max_batch:
        raise ValueError(
            f"shard count {shards} not in [1, max_batch={max_batch}]")
    sizes = []
    b = shards
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


class _Stage:
    """A reused page-locked staging buffer and the events recorded after
    its last copies to the cards (one per device)."""

    __slots__ = ("host", "copied")

    def __init__(self, shape, dtype):
        self.host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.copied: list[torch.cuda.Event] = []


class Tenant:
    """One hosted pipeline: its graph, signal length, bucket ladder,
    compiled plans, packing dtype, staging and output buffers, replay
    log, and runtime-degradation books."""

    def __init__(self, name: str, graph: Graph, signal_len: int, *,
                 batch_size: int, batching: str,
                 options: plan_lib.CompileOptions,
                 record_batches: bool):
        if len(graph.inputs) != 1:
            raise ValueError("serving supports single-input graphs")
        if len(graph.outputs) != 1:
            # a tuple-returning plan would make out[i] index outputs,
            # not batch rows — reject instead of corrupting responses
            raise ValueError("serving supports single-output graphs")
        plan_lib._check_ported(options)
        self.name = name
        self.graph = graph
        self.signal_len = int(signal_len)
        self.batch_size = int(batch_size)
        self.dtype = np.dtype(options.dtype)
        # the mesh is made once: every bucket plan shares it, and the
        # ladder needs its shard count before any plan compiles
        self.options, self.mesh, self.device = plan_lib.normalize_mesh(
            options)
        # every device a batch runs on, each once
        self.devices = ((self.device,) if self.mesh is None
                        else self.mesh.distinct)
        shards = 1 if self.mesh is None else self.mesh.size
        if batching == "continuous":
            self.buckets = bucket_ladder(self.batch_size, shards)
        else:
            self.buckets = (self.batch_size,)
        # compile every bucket's serving plan up front: requests never
        # pay compile cost, and with lowering="auto" (or
        # block_configs="auto") each bucket runs its own shape's winners;
        # compile checks that the shard count divides each bucket
        self.plans = {
            b: plan_lib.compile(
                graph, {graph.inputs[0]: (b, self.signal_len)},
                options=self.options)
            for b in self.buckets}
        self.plan = self.plans[self.batch_size]
        # two page-locked staging buffers per bucket (the batch in flight
        # and the one being packed), made at the bucket's first batch
        self._stages: dict[int, list[_Stage]] = {}
        self._turn: dict[int, int] = {}
        # page-locked output buffers per bucket that no batch holds: a
        # batch takes one at launch and gives it back once its rows are
        # copied out (two in use at most, the batch in flight and the one
        # being delivered, unless recovery runs a batch between them)
        self._free_outs: dict[int, list[torch.Tensor]] = {}
        # optional packing trace: every batch that DELIVERED results
        # appends (bucket, [(request, future)]) so a replay can verify
        # delivered responses bit for bit against the exact packing
        self.batch_log: list[tuple[int, list[tuple[np.ndarray, Future]]]] \
            | None = [] if record_batches else None
        # runtime degradation books (consumer-thread-only mutation):
        # consecutive post-retry failures per bucket, the recorded
        # runtime downgrades (bucket -> requested lowering), and the
        # fault-point tag each bucket's device_run checks carry (its
        # current lowering request; "reference" once degraded)
        self._bucket_fails: dict[int, int] = {}
        self.downgrades: dict[int, str] = {}
        tag = (options.lowering if isinstance(options.lowering, str)
               else "per-node")
        self._tags: dict[int, str] = {b: tag for b in self.buckets}
        # per-tenant counters, mutated under the service's stats lock
        # and surfaced as stats()["tenants"][name]
        self.counts: dict = {"requests": 0, "batches": 0,
                             "padded_slots": 0}
        if batching == "continuous":
            self.counts["bucket_batches"] = {b: 0 for b in self.buckets}

    def bucket_for(self, n: int) -> int:
        """Smallest pre-compiled bucket admitting ``n`` requests."""
        return self.buckets[bisect.bisect_left(self.buckets, n)]

    def stage(self, bucket: int) -> _Stage:
        """The bucket's next staging buffer, once its last copy to the
        card has finished (a CUDA event, not a device-wide sync)."""
        ring = self._stages.get(bucket)
        if ring is None:
            shape = (bucket, self.signal_len)
            dt = getattr(torch, self.dtype.name)
            ring = self._stages[bucket] = [_Stage(shape, dt),
                                           _Stage(shape, dt)]
        i = self._turn.get(bucket, 0)
        self._turn[bucket] = i ^ 1
        st = ring[i]
        for ev in st.copied:
            ev.synchronize()
        return st

    def take_out(self, bucket: int) -> torch.Tensor:
        """A page-locked host buffer for one batch's output: a free one
        of the bucket's, else a new one (its shape evaluated once)."""
        free = self._free_outs.setdefault(bucket, [])
        if free:
            return free.pop()
        av = plan_lib.infer(self.graph, {self.graph.inputs[0]: (
            (bucket, self.signal_len), getattr(torch, self.dtype.name))})
        out = av[self.graph.outputs[0]]
        return torch.empty(tuple(out.shape), dtype=out.dtype,
                           pin_memory=True)

    def give_back(self, bucket: int, host: torch.Tensor) -> None:
        """Return an output buffer whose rows were all copied out."""
        self._free_outs[bucket].append(host)


class _Inflight:
    """One dispatched-but-not-retired batch: the card is (or will be)
    computing it while the batcher forms the next one;
    :meth:`PipelineService._complete` waits on it and delivers."""

    __slots__ = ("tenant", "bucket", "items", "stage", "batch", "out",
                 "host", "done", "marks", "host_ms", "t_dispatch",
                 "t_packed", "enq_ns")

    def __init__(self, tenant, bucket, items, t_dispatch):
        self.tenant = tenant
        self.bucket = bucket
        self.items = items
        self.stage = None        # the staging buffer (CUDA tenants)
        self.batch = None        # the packed batch on the host
        self.out = None          # the plan's output array (CPU tenants)
        self.host = None         # the page-locked output buffer (CUDA)
        self.done = ()           # CUDA events after the copies to the host
        self.marks = ()          # per device: start, in, plan, out events
        self.host_ms: dict[str, float] = {}
        self.t_dispatch = t_dispatch
        self.t_packed = t_dispatch
        self.enq_ns = 0

    def ready(self) -> bool:
        try:
            return all(ev.query() for ev in self.done)
        except Exception:   # noqa: BLE001 — _complete surfaces it
            return True

    def wait(self) -> None:
        """Wait for the batch's copies to the host, from every device
        (device errors surface here)."""
        for ev in self.done:
            ev.synchronize()

    def rows(self):
        """The requests' output rows, after :meth:`wait`.  On the card
        each is copied out of the output buffer into memory of its own
        (a torch copy, which runs on the host's threads), and the buffer
        goes back to its bucket; on the CPU the plan's output is already
        the batch's own."""
        if self.host is None:
            return self.out
        rows = [torch.empty(r.shape, dtype=r.dtype).copy_(r).numpy()
                for r in self.host[:len(self.items)]]
        self.tenant.give_back(self.bucket, self.host)
        self.host = None
        return rows

    def card_ms(self) -> dict[str, float]:
        """The card's ms per part: the slowest device's."""
        parts: dict[str, float] = {}
        for e0, e_in, e_plan, e_out in self.marks:
            for k, v in (("copy_in", e0.elapsed_time(e_in)),
                         ("plan", e_in.elapsed_time(e_plan)),
                         ("copy_out", e_plan.elapsed_time(e_out)),
                         ("batch", e0.elapsed_time(e_out))):
                parts[k] = max(parts.get(k, 0.0), v)
        return parts


@contextlib.contextmanager
def _timed(host_ms: dict, part: str):
    """Store the host ms spent in the ``with`` body as ``host_ms[part]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        host_ms[part] = (time.perf_counter() - t0) * 1e3


class PipelineService:
    def __init__(self, graph: Graph, signal_len: int, *,
                 batch_size: int = 8, batching: str = "fixed",
                 dtype=None, options: plan_lib.CompileOptions | None = None,
                 overlap: bool | None = None,
                 max_wait_ms: float = 2.0,
                 close_timeout: float = 30.0, record_batches: bool = False,
                 queue_limit: int | None = None, on_full: str = "block",
                 deadline_ms: float | None = None, validate: str = "off",
                 max_retries: int = 2, retry_backoff_ms: float = 1.0,
                 retry_backoff_max_ms: float = 100.0,
                 degrade_after: int = 3, **compile_kwargs):
        if batching not in ("fixed", "continuous"):
            raise ValueError(
                f"batching={batching!r}: expected 'fixed' or 'continuous'")
        if on_full not in ("block", "shed", "raise"):
            raise ValueError(
                f"on_full={on_full!r}: expected 'block', 'shed', or "
                "'raise'")
        if validate not in ("strict", "off"):
            raise ValueError(
                f"validate={validate!r}: expected 'strict' or 'off'")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(
                f"queue_limit={queue_limit}: expected None (unbounded) "
                "or a positive depth")
        if deadline_ms is not None and deadline_ms < 0:
            raise ValueError(f"deadline_ms={deadline_ms}: must be >= 0")
        if max_retries < 0:
            raise ValueError(f"max_retries={max_retries}: must be >= 0")
        faults.load()   # strict TINA_FAULTS validation: fail the launch,
        # not the Nth request, on a typo'd chaos spec
        self.batching = batching
        # overlap defaults on for the continuous batcher (where the
        # device-idle gap is the cost being removed); fixed mode keeps
        # the blocking loop unless asked
        self.overlap = (batching == "continuous") if overlap is None \
            else bool(overlap)
        self.max_wait_ms = max_wait_ms
        self.close_timeout = close_timeout
        self.queue_limit = queue_limit
        self.on_full = on_full
        self.deadline_ms = deadline_ms
        self.validate = validate
        self.max_retries = int(max_retries)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.retry_backoff_max_ms = float(retry_backoff_max_ms)
        self.degrade_after = int(degrade_after)
        self._record_batches = bool(record_batches)
        # the priority queue: one FIFO per class, popped highest-first
        self._pending: dict[str, deque] = {p: deque() for p in PRIORITIES}
        self._thread: threading.Thread | None = None
        self._closed = False
        self._stopping = False
        self._drain_lock = threading.Lock()  # the single-consumer claim
        # makes check-closed + enqueue atomic against close()
        self._lifecycle = threading.Lock()
        # admission waits ride _space, the batcher's wait-for-work rides
        # _avail; close() wakes both sides
        self._space = threading.Condition(self._lifecycle)
        self._avail = threading.Condition(self._lifecycle)
        self._depth = 0              # admitted-but-undequeued requests
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                       "failed_batches": 0, "shed": 0, "expired": 0,
                       "retries": 0, "quarantined": 0, "degraded": 0,
                       "invalid": 0,
                       "priorities": {p: 0 for p in PRIORITIES}}
        # request-latency attribution (milliseconds): total is submit ->
        # result, queued is submit -> dispatch (per request), pad is the
        # host's packing and device the batch on the device track (per
        # batch); service-private, so two services never mix them
        self._lat = {k: obs.Histogram(f"service.latency.{k}", unit="ms")
                     for k in ("total", "queued", "pad", "device")}
        # a batch's parts: on the host's clock, and on the card's events
        self._host = {k: obs.Histogram(f"service.host.{k}", unit="ms")
                      for k in HOST_PARTS}
        self._card = {k: obs.Histogram(f"service.card.{k}", unit="ms")
                      for k in CARD_PARTS}
        # the synthetic device track's watermark: end timestamp of the
        # last retired device_run
        self._device_ready_ns = 0
        # one CUDA stream per card this service runs on (every device of
        # a tenant's mesh)
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        # the error that lost a CUDA context: every later batch fails
        # with it (see _lost_by)
        self._lost: BaseException | None = None
        self.tenants: dict[str, Tenant] = {}
        self._default = self._add_tenant(
            "default", graph, signal_len, batch_size=int(batch_size),
            options=self._resolve_options(options, dtype, compile_kwargs),
            record_batches=self._record_batches)
        if batching == "continuous":
            self._stats["bucket_batches"] = {b: 0
                                             for b in self._default.buckets}

    # -- options / tenants --------------------------------------------------
    @staticmethod
    def _resolve_options(options, dtype, compile_kwargs
                         ) -> plan_lib.CompileOptions:
        """One CompileOptions from whichever spelling the caller used:
        ``options=``, or loose keyword arguments naming its fields
        (``lowering=``, ``precision=``, ``device=``, ... plus
        ``dtype=``) folded into one -- but not both, which would give
        the same knob two sources of truth."""
        if compile_kwargs:
            if options is not None:
                raise TypeError(
                    "PipelineService got both options= and compile "
                    f"keyword argument(s) {sorted(compile_kwargs)}: fold "
                    "everything into the CompileOptions")
            return plan_lib.CompileOptions(
                dtype=str(dtype) if dtype is not None else "float32",
                **compile_kwargs)
        if options is None:
            return plan_lib.CompileOptions(
                dtype=str(dtype) if dtype is not None else "float32")
        if dtype is not None and str(dtype) != options.dtype:
            raise TypeError(
                f"dtype={dtype!r} conflicts with options.dtype="
                f"{options.dtype!r}: set it on the CompileOptions")
        return options

    def add_tenant(self, name: str, graph: Graph, signal_len: int, *,
                   batch_size: int | None = None, dtype=None,
                   options: plan_lib.CompileOptions | None = None,
                   record_batches: bool | None = None,
                   **compile_kwargs) -> Tenant:
        """Host another pipeline on this service's scheduler.  The
        tenant gets its own signal length, bucket ladder, compiled
        plans, replay log and (optionally) its own
        :class:`~repro_torch.graph.plan.CompileOptions`; defaults
        inherit the service's, and loose keyword arguments that name no
        ``device`` inherit the service's device.  Returns the
        :class:`Tenant`; route requests to it with ``submit(x,
        tenant=name)``."""
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("service closed")
        if options is None and not compile_kwargs and dtype is None:
            options = self._default.options
        elif options is None:
            compile_kwargs.setdefault("device", self._default.options.device)
        return self._add_tenant(
            name, graph, signal_len,
            batch_size=(self._default.batch_size if batch_size is None
                        else int(batch_size)),
            options=self._resolve_options(options, dtype, compile_kwargs),
            record_batches=(self._record_batches if record_batches is None
                            else bool(record_batches)))

    def _add_tenant(self, name, graph, signal_len, *, batch_size,
                    options, record_batches) -> Tenant:
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already exists")
        t = Tenant(name, graph, signal_len, batch_size=batch_size,
                   batching=self.batching, options=options,
                   record_batches=record_batches)
        for d in t.devices:
            if d.type == "cuda" and d not in self._streams:
                self._streams[d] = torch.cuda.Stream(d)
        self.tenants[name] = t
        if "bucket_batches" in self._stats:
            with self._stats_lock:
                for b in t.buckets:
                    self._stats["bucket_batches"].setdefault(b, 0)
        return t

    def _tenant(self, tenant) -> Tenant:
        if tenant is None:
            return self._default
        if isinstance(tenant, Tenant):
            return tenant
        try:
            return self.tenants[tenant]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant!r}; have "
                           f"{sorted(self.tenants)}") from None

    def stream(self, tenant=None) -> torch.cuda.Stream | None:
        """The CUDA stream a tenant's batches run on (its mesh's first
        device's; None on the CPU)."""
        return self._streams.get(self._tenant(tenant).device)

    # -- default-tenant delegation (the single-pipeline API) ---------------
    @property
    def graph(self) -> Graph:
        return self._default.graph

    @property
    def signal_len(self) -> int:
        return self._default.signal_len

    @property
    def dtype(self) -> np.dtype:
        return self._default.dtype

    @property
    def batch_size(self) -> int:
        return self._default.batch_size

    @property
    def buckets(self) -> tuple[int, ...]:
        return self._default.buckets

    @property
    def plans(self) -> dict:
        return self._default.plans

    @plans.setter
    def plans(self, value: dict) -> None:
        self._default.plans = value

    @property
    def plan(self):
        return self._default.plan

    @plan.setter
    def plan(self, value) -> None:
        self._default.plan = value

    @property
    def batch_log(self):
        return self._default.batch_log

    @property
    def downgrades(self) -> dict:
        return self._default.downgrades

    # -- request side -------------------------------------------------------
    def submit(self, x, *, deadline_ms: float | None = None,
               priority: str = "batch", tenant=None) -> Future:
        """Enqueue one request; returns a Future resolving to its output
        row or to a typed exception (:mod:`repro_torch.graph.errors`).

        ``priority`` (``"rt"`` or ``"batch"``) picks the queue class;
        ``tenant=`` routes to a hosted pipeline by name (or
        :class:`Tenant`).  ``deadline_ms`` (default: the service-wide
        one) bounds how long the request may wait *before dispatch*.
        With ``validate="strict"`` a non-finite payload fails the future
        with :class:`InvalidRequest`.  A full bounded queue blocks, sheds
        or raises per ``on_full``."""
        if priority not in PRIORITIES:
            raise ValueError(f"priority={priority!r}: expected one of "
                             f"{PRIORITIES}")
        t = self._tenant(tenant)
        x = np.asarray(x, t.dtype)
        if x.shape != (t.signal_len,):
            raise ValueError(
                f"request shape {x.shape} != ({t.signal_len},) — "
                "fixed-shape serving; open one service (or tenant) per "
                "signal length")
        fut: Future = Future()
        fut._tina_submit_t = time.perf_counter()   # queued-phase stamp
        if self.validate == "strict" and not np.isfinite(x).all():
            with self._stats_lock:
                self._stats["invalid"] += 1
            fut.set_exception(InvalidRequest(
                "payload contains non-finite sample(s) "
                "(validate='strict'): rejected at submit, never batched"))
            return fut
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        fut._tina_deadline = (fut._tina_submit_t + dl / 1e3
                              if dl is not None else None)
        with self._space:   # the lifecycle lock, as a Condition
            if self._closed:
                raise RuntimeError("service closed")
            if self.queue_limit is not None \
                    and self._depth >= self.queue_limit:
                if self.on_full == "block":
                    while not self._closed \
                            and self._depth >= self.queue_limit:
                        wait = 0.05
                        if fut._tina_deadline is not None:
                            left = fut._tina_deadline - time.perf_counter()
                            if left <= 0:
                                self._expire(fut)
                                return fut
                            wait = min(wait, left)
                        self._space.wait(wait)
                    if self._closed:
                        raise RuntimeError("service closed")
                else:
                    with self._stats_lock:
                        self._stats["shed"] += 1
                    err = Overloaded(
                        f"queue full ({self.queue_limit} deep, "
                        f"on_full={self.on_full!r}): request shed")
                    if self.on_full == "raise":
                        raise err
                    fut.set_exception(err)       # on_full="shed"
                    return fut
            with self._stats_lock:
                self._stats["requests"] += 1
                self._stats["priorities"][priority] += 1
                t.counts["requests"] += 1
            self._depth += 1
            self._pending[priority].append((x, fut, t))
            self._avail.notify()
        return fut

    async def submit_async(self, x, *, deadline_ms: float | None = None,
                           priority: str = "batch", tenant=None):
        """``await`` one request's result on the running event loop: the
        same queue and future as :meth:`submit`, bridged with
        ``asyncio.wrap_future``.  When admission can block the enqueue
        runs in the default executor, so a full queue never stalls the
        loop."""
        if self.queue_limit is not None and self.on_full == "block":
            fut = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.submit(x, deadline_ms=deadline_ms,
                                          priority=priority, tenant=tenant))
        else:
            fut = self.submit(x, deadline_ms=deadline_ms,
                              priority=priority, tenant=tenant)
        return await asyncio.wrap_future(fut)

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        """One consistent snapshot of every stat (copied under the stats
        lock) plus queue depth, fill ratio, per-tenant breakdowns, the
        latency summaries and each batch part's host and card ms."""
        with self._stats_lock:
            d = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in self._stats.items()}
            d["tenants"] = {
                name: {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in t.counts.items()}
                for name, t in self.tenants.items()}
        d["queue_depth"] = self._depth
        d["fill_ratio"] = d["requests"] / max(
            1, d["requests"] + d["padded_slots"])
        d["latency_ms"] = {k: h.summary() for k, h in self._lat.items()}
        d["host_ms"] = {k: h.summary() for k, h in self._host.items()}
        d["card_ms"] = {k: h.summary() for k, h in self._card.items()}
        return d

    # -- deadlines ----------------------------------------------------------
    def _expire(self, fut: Future) -> None:
        with self._stats_lock:
            self._stats["expired"] += 1
        fut.set_exception(DeadlineExceeded(
            "deadline expired before a device dispatch picked the "
            "request up"))

    def _sweep_expired(self, items: list) -> list:
        """Fail every expired request and return the live remainder --
        called at dispatch time, before packing."""
        now = time.perf_counter()
        live = []
        for it in items:
            dl = getattr(it[1], "_tina_deadline", None)
            if dl is not None and now > dl:
                self._expire(it[1])
            else:
                live.append(it)
        return live

    # -- queue --------------------------------------------------------------
    def _pop_locked(self, tenant: Tenant | None = None):
        """Pop the highest-priority pending request (optionally only
        ``tenant``'s), or None.  Caller holds the lifecycle lock."""
        req = None
        for p in PRIORITIES:
            dq = self._pending[p]
            if tenant is None:
                if dq:
                    req = dq.popleft()
                    break
            else:
                # index-based removal: tuple == would compare the numpy
                # payloads elementwise
                for i, r in enumerate(dq):
                    if r[2] is tenant:
                        del dq[i]
                        req = r
                        break
                if req is not None:
                    break
        if req is None:
            return None
        self._depth -= 1
        if self.queue_limit is not None:
            self._space.notify()
        return req

    def _get(self, timeout: float | None, tenant: Tenant | None = None):
        """Dequeue one request, blocking up to ``timeout`` seconds (None
        = forever): the request, ``_EMPTY`` on timeout, or ``_STOPPED``
        once the service is stopping and nothing is pending."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._avail:
            while True:
                req = self._pop_locked(tenant)
                if req is not None:
                    return req
                if self._stopping:
                    return _STOPPED
                if deadline is None:
                    self._avail.wait()
                else:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        return _EMPTY
                    self._avail.wait(left)

    def _gather(self, first, fill_wait: float | None) -> tuple[Tenant, list]:
        """Form one single-tenant batch seeded by ``first``: same-tenant
        requests (highest priority first) fill the bucket.  ``fill_wait``
        is fixed mode's per-request linger; continuous mode takes
        exactly what has queued."""
        tenant = first[2]
        items = [first]
        while len(items) < tenant.batch_size:
            nxt = self._get(fill_wait if fill_wait is not None else 0,
                            tenant)
            if nxt is _EMPTY or nxt is _STOPPED:
                break
            items.append(nxt)
        return tenant, items

    # -- batch execution ----------------------------------------------------
    def _plan_for(self, tenant: Tenant, n: int):
        """(bucket, plan) serving an ``n``-request batch under the
        current policy (fixed mode always pads to the one batch shape;
        ``tenant.plan`` stays replaceable there)."""
        if self.batching == "continuous":
            b = tenant.bucket_for(n)
            return b, tenant.plans[b]
        return tenant.batch_size, tenant.plan

    def _pack(self, tenant: Tenant, bucket: int, items: list,
              out: np.ndarray | None = None) -> np.ndarray:
        """The one definition of batch packing: requests fill the first
        rows, zero padding fills the rest -- into ``out`` (a staging
        buffer) or a fresh array.  ``replay_batches`` packs through this
        too, so the replay checks the packing actually served."""
        if out is None:
            out = np.zeros((bucket, tenant.signal_len), tenant.dtype)
        else:
            out[len(items):] = 0
        for i, it in enumerate(items):
            out[i] = it[0]
        return out

    def _packed(self, tenant: Tenant, bucket: int, items: list,
                t_dispatch: float) -> _Inflight:
        """Pack one batch: into the bucket's next staging buffer on a
        CUDA tenant, into a fresh array on the CPU."""
        inf = _Inflight(tenant, bucket, items, t_dispatch)
        with obs.span("service.pack", cat="serve", bucket=bucket), \
                _timed(inf.host_ms, "pack"):
            if tenant.device.type == "cuda":
                inf.stage = tenant.stage(bucket)
            inf.batch = self._pack(
                tenant, bucket, items,
                None if inf.stage is None else inf.stage.host.numpy())
        inf.t_packed = time.perf_counter()
        return inf

    def _start(self, inf: _Inflight, plan) -> None:
        """Check the batch's fault point and start it: on a CUDA tenant
        the copies in, the plan and the copies out are enqueued on the
        service's streams (one per device; under a mesh shard i's rows go
        to the mesh's device i and come back into the same rows) and not
        waited for; on the CPU the plan runs here."""
        t = inf.tenant
        faults.check("device_run", payload=inf.batch,
                     tag=t._tags.get(inf.bucket))
        host_ms = inf.host_ms
        if inf.stage is None:
            with _timed(host_ms, "plan"):
                inf.out = plan(torch.from_numpy(inf.batch)).numpy()
            return
        with _timed(host_ms, "copy_out"):
            # taken before the batch's first event, so the card's parts
            # time only its work
            inf.host = host = t.take_out(inf.bucket)
        streams = [self._streams[d] for d in t.devices]
        marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                 for _ in streams]

        def mark(j: int) -> None:
            for m, s in zip(marks, streams):
                m[j].record(s)

        with contextlib.ExitStack() as ctx:
            for s in streams:
                ctx.enter_context(torch.cuda.stream(s))
            mark(0)
            with _timed(host_ms, "copy_in"):
                src = inf.stage.host
                if t.mesh is None:
                    rows, devs = [slice(None)], [t.device]
                else:
                    k = inf.bucket // t.mesh.size
                    rows = [slice(i * k, (i + 1) * k)
                            for i in range(t.mesh.size)]
                    devs = t.mesh.devices
                xs = []
                for r, d in zip(rows, devs):
                    x = torch.empty(src[r].shape, dtype=src.dtype, device=d)
                    xs.append(x.copy_(src[r], non_blocking=True))
                mark(1)
                inf.stage.copied = [m[1] for m in marks]
            with _timed(host_ms, "plan"):
                outs = ([plan(xs[0])] if t.mesh is None
                        else plan.run_shards(Shards(xs)))
                mark(2)
            t0 = time.perf_counter()
            for r, o in zip(rows, outs):
                host[r].copy_(o, non_blocking=True)
            mark(3)
            host_ms["copy_out"] += (time.perf_counter() - t0) * 1e3
        inf.done = tuple(m[3] for m in marks)
        inf.marks = tuple(tuple(m) for m in marks)

    def _retire(self, inf: _Inflight, t_deliver: float) -> None:
        """Record a delivered batch's host and card ms per part."""
        inf.host_ms["deliver"] = (time.perf_counter() - t_deliver) * 1e3
        for k, v in inf.host_ms.items():
            self._host[k].record(v)
        for k, v in inf.card_ms().items():
            self._card[k].record(v)

    def _deliver(self, tenant: Tenant, bucket: int, items: list,
                 out, t_dispatch: float) -> None:
        """Post-device bookkeeping of one successful batch: log the
        packing, bump the books, record request latencies, resolve
        futures."""
        n = len(items)
        if tenant.batch_log is not None:
            tenant.batch_log.append((bucket,
                                     [(it[0], it[1]) for it in items]))
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["padded_slots"] += bucket - n
            tenant.counts["batches"] += 1
            tenant.counts["padded_slots"] += bucket - n
            if "bucket_batches" in self._stats:
                self._stats["bucket_batches"][bucket] = \
                    self._stats["bucket_batches"].get(bucket, 0) + 1
            if "bucket_batches" in tenant.counts:
                tenant.counts["bucket_batches"][bucket] += 1
        for i, it in enumerate(items):
            fut = it[1]
            t_sub = getattr(fut, "_tina_submit_t", None)
            if t_sub is not None:
                self._lat["queued"].record((t_dispatch - t_sub) * 1e3)
                self._lat["total"].record(
                    (time.perf_counter() - t_sub) * 1e3)
            fut.set_result(out[i])

    def _execute_once(self, tenant: Tenant, bucket: int, plan,
                      items: list) -> None:
        """One synchronous dispatch attempt: pack, run, wait, deliver.
        Raises on failure (``_dispatch`` decides what happens next).
        Used by flush/fixed/retry/bisection paths; the overlapped loop
        splits this into :meth:`_launch` + :meth:`_complete`."""
        if self._lost is not None:
            raise self._lost
        n = len(items)
        t_dispatch = time.perf_counter()
        with obs.span("service.dispatch", cat="serve", bucket=bucket,
                      n=n, tenant=tenant.name):
            inf = self._packed(tenant, bucket, items, t_dispatch)
            with obs.span("service.device_run", cat="serve",
                          bucket=bucket):
                self._start(inf, plan)
                inf.wait()
            t_device = time.perf_counter()
        self._device_ready_ns = max(self._device_ready_ns,
                                    time.perf_counter_ns())
        self._lat["pad"].record((inf.t_packed - t_dispatch) * 1e3)
        self._lat["device"].record((t_device - inf.t_packed) * 1e3)
        self._deliver(tenant, bucket, items, inf.rows(), t_dispatch)
        self._retire(inf, t_device)

    def _launch(self, tenant: Tenant, items: list) -> _Inflight:
        """The overlapped scheduler's front half: pack and enqueue one
        batch on the service's stream without waiting for it, so the
        host moves on to the next batch while the card computes this
        one."""
        if self._lost is not None:
            raise self._lost
        bucket, plan = self._plan_for(tenant, len(items))
        t_dispatch = time.perf_counter()
        with obs.span("service.dispatch", cat="serve", bucket=bucket,
                      n=len(items), tenant=tenant.name, overlap=True):
            inf = self._packed(tenant, bucket, items, t_dispatch)
            self._start(inf, plan)
        inf.enq_ns = time.perf_counter_ns()
        return inf

    def _complete(self, inf: _Inflight) -> None:
        """The overlapped scheduler's back half: wait for the batch's
        copy to the host, emit its device span on the synthetic
        ``"device"`` track (start clamped to the previous batch's end --
        the card executes the stream in order), and deliver."""
        inf.wait()                   # device errors surface here
        t1_ns = time.perf_counter_ns()
        # clamp past the watermark with a 1 us guard: abutting integer-ns
        # endpoints can round to an overlap in float microseconds
        t0_ns = max(inf.enq_ns, min(self._device_ready_ns + 1_000, t1_ns))
        obs.complete("service.device_run", t0_ns, t1_ns,
                     cat="serve", tid="device", bucket=inf.bucket,
                     tenant=inf.tenant.name)
        self._device_ready_ns = t1_ns
        self._lat["pad"].record((inf.t_packed - inf.t_dispatch) * 1e3)
        self._lat["device"].record((t1_ns - t0_ns) / 1e6)
        t_deliver = time.perf_counter()
        self._deliver(inf.tenant, inf.bucket, inf.items, inf.rows(),
                      inf.t_dispatch)
        self._retire(inf, t_deliver)

    def _finish(self, inf: _Inflight) -> None:
        """Retire one inflight batch; failures route into the same
        recovery machinery as blocking mode (the overlapped dispatch is
        attempt zero)."""
        try:
            self._complete(inf)
            inf.tenant._bucket_fails[inf.bucket] = 0
        except Exception as e:   # noqa: BLE001 — recovery boundary
            self._dispatch(inf.tenant, inf.items, first_err=e)
        return None

    def _run_batch(self, tenant: Tenant, items: list) -> bool:
        """Sweep deadlines, then dispatch with full failure recovery;
        returns whether anything was actually dispatched."""
        items = self._sweep_expired(items)
        if not items:
            return False
        self._dispatch(tenant, items)
        return True

    def _lost_by(self, tenant: Tenant, err: BaseException) -> bool:
        """Whether ``err`` left the tenant's CUDA context unusable (an
        illegal address, a launch failure: every later call fails the
        same way).  Then the service keeps ``err`` and fails every later
        batch with it; retry, bisection and degradation could only hide
        it."""
        if self._lost is None and tenant.device.type == "cuda":
            try:
                for d in tenant.devices:
                    torch.cuda.synchronize(d)
            except Exception:   # noqa: BLE001 — the context is gone
                self._lost = err
        return self._lost is not None

    def _fail_all(self, items: list, err: BaseException) -> None:
        with self._stats_lock:
            self._stats["failed_batches"] += 1
        for it in items:
            if not it[1].done():
                it[1].set_exception(err)

    def _dispatch(self, tenant: Tenant, items: list, *,
                  first_err: BaseException | None = None) -> None:
        """Dispatch with recovery: retry transient failures with capped
        exponential backoff; on persistent failure optionally degrade
        the bucket's lowering, then bisect to isolate poison rows so
        healthy requests still resolve.  The batcher thread survives
        every path.  ``first_err`` feeds an already-failed overlapped
        attempt into the same retry accounting."""
        bucket, plan = self._plan_for(tenant, len(items))
        attempt = 0
        err = first_err
        while True:
            if err is None:
                try:
                    self._execute_once(tenant, bucket, plan, items)
                    tenant._bucket_fails[bucket] = 0
                    return
                except Exception as e:   # noqa: BLE001
                    err = e
            if self._lost_by(tenant, err):
                self._fail_all(items, self._lost)
                return
            # persistent faults (poison payloads) can't be retried away
            if getattr(err, "persistent", False) \
                    or attempt >= self.max_retries:
                break
            attempt += 1
            with self._stats_lock:
                self._stats["retries"] += 1
            delay = min(
                self.retry_backoff_ms * (2 ** (attempt - 1)),
                self.retry_backoff_max_ms) / 1e3
            with obs.span("service.retry", cat="serve", bucket=bucket,
                          attempt=attempt, error=type(err).__name__):
                if delay > 0:
                    time.sleep(delay)
            err = None
        # post-retry failure: the batch (not the thread) is the casualty
        with self._stats_lock:
            self._stats["failed_batches"] += 1
        fails = tenant._bucket_fails.get(bucket, 0) + 1
        tenant._bucket_fails[bucket] = fails
        if fails >= self.degrade_after \
                and bucket not in tenant.downgrades:
            degraded = self._degrade(tenant, bucket, err)
            if degraded is not None:
                try:
                    self._execute_once(tenant, bucket, degraded, items)
                    tenant._bucket_fails[bucket] = 0
                    return
                except Exception as e:   # noqa: BLE001
                    err = e              # degraded plan failed too
                    if self._lost_by(tenant, err):
                        self._fail_all(items, self._lost)
                        return
        if len(items) == 1:
            self._quarantine(items[0][1], err)
            return
        with obs.span("service.bisect", cat="serve", bucket=bucket,
                      n=len(items), error=type(err).__name__):
            mid = len(items) // 2
            self._isolate(tenant, items[:mid])
            self._isolate(tenant, items[mid:])

    def _isolate(self, tenant: Tenant, items: list) -> None:
        """Bisection step: run ``items`` once through their own bucket
        plan; on failure split again, down to the single poisoned row --
        healthy sub-batches deliver results (and are logged for replay),
        poison rows get the error."""
        bucket, plan = self._plan_for(tenant, len(items))
        try:
            self._execute_once(tenant, bucket, plan, items)
        except Exception as e:   # noqa: BLE001
            if self._lost_by(tenant, e):
                self._fail_all(items, self._lost)
                return
            if len(items) == 1:
                self._quarantine(items[0][1], e)
                return
            mid = len(items) // 2
            self._isolate(tenant, items[:mid])
            self._isolate(tenant, items[mid:])

    def _quarantine(self, fut: Future, err: BaseException) -> None:
        """Deliver the isolating error to exactly one future."""
        with self._stats_lock:
            self._stats["quarantined"] += 1
        obs.instant("service.quarantine", cat="serve",
                    error=type(err).__name__)
        fut.set_exception(err)

    def _degrade(self, tenant: Tenant, bucket: int, err: BaseException):
        """Recompile a persistently failing bucket once, at f32: on the
        CPU with the reference lowering (``native``), on the card with
        the tenant's own lowering -- a ``kernel`` bucket never gives way
        to the plain version there.  Returns the degraded plan, or None
        when there is nothing to shed (the bucket already runs f32, and
        native or on the card) or the recompile itself fails (the
        batcher must survive that too)."""
        requested = tenant.options.lowering
        prec = tenant.options.precision
        on_card = tenant.device.type == "cuda"
        lowering_trivial = (isinstance(requested, str)
                            and requested in ("native", "reference"))
        precision_trivial = prec in (None, "f32")
        if (lowering_trivial or on_card) and precision_trivial:
            return None
        options = (tenant.options.replace(precision="f32") if on_card
                   else plan_lib.CompileOptions(
                       dtype=str(tenant.dtype), lowering="reference",
                       device=tenant.options.device,
                       backend=tenant.options.backend,
                       mesh=tenant.options.mesh))
        try:
            plan = plan_lib.compile(
                tenant.graph,
                {tenant.graph.inputs[0]: (bucket, tenant.signal_len)},
                options=options)
        except Exception:   # noqa: BLE001 — degradation must never kill
            return None     # the batcher; bisection still runs
        tenant.plans[bucket] = plan
        if bucket == tenant.batch_size:
            tenant.plan = plan
        # record what the bucket gave up: the lowering request when it
        # was shed, else the dimension-tagged precision request
        if not (lowering_trivial or on_card):
            tenant.downgrades[bucket] = (requested
                                         if isinstance(requested, str)
                                         else "per-node")
        else:
            tenant.downgrades[bucket] = "precision:" + (
                prec if isinstance(prec, str) else "per-node")
        if not on_card:
            tenant._tags[bucket] = "reference"
        with self._stats_lock:
            self._stats["degraded"] += 1
        obs.instant("service.degrade", cat="serve", bucket=bucket,
                    tenant=tenant.name, requested=str(requested),
                    error=type(err).__name__)
        how = (f"f32 at its own lowering {requested!r} (was precision "
               f"{prec!r})" if on_card else
               f"the reference lowering (was {requested!r})")
        warnings.warn(
            f"service bucket {bucket} (tenant {tenant.name!r}): plan "
            f"failed {self.degrade_after} consecutive dispatch(es) "
            f"(last: {type(err).__name__}); recompiled with {how} — see "
            "the tenant's downgrades",
            stacklevel=2)
        return plan

    def flush(self) -> int:
        """Drain the queue synchronously; returns batches executed.
        Only legal while no other consumer exists (a background batcher
        or a second concurrent ``flush()``)."""
        with self._lifecycle:    # claim + thread check atomic vs start()
            t = self._thread
            if t is not None and t.is_alive():
                raise RuntimeError(
                    "flush() while the background batcher is running "
                    "would split batches across two consumers; close() "
                    "the service to drain it")
            if not self._drain_lock.acquire(blocking=False):
                raise RuntimeError(
                    "flush() while another flush() is draining would "
                    "split batches across two consumers")
        try:
            return self._drain_queue()
        finally:
            self._drain_lock.release()

    def _drain_queue(self) -> int:
        ran = 0
        while True:
            with self._avail:
                first = self._pop_locked()
            if first is None:
                return ran
            tenant, items = self._gather(first, None)
            if self._run_batch(tenant, items):
                ran += 1

    # -- background batcher -------------------------------------------------
    def start(self) -> "PipelineService":
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("service closed")
            if self._drain_lock.locked():
                raise RuntimeError(
                    "start() while flush() is draining would spawn a "
                    "second consumer mid-batch")
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()
        return self

    def _loop(self) -> None:
        """The batcher.  Blocking mode: block for the first request,
        gather up to the tenant's batch size, dispatch and wait, repeat.
        Overlapped mode: at most ONE batch is in flight on the card; the
        loop launches batch N+1 *before* waiting on batch N, so the
        card's queue is never empty while requests are waiting.  An idle
        queue with a batch in flight polls briefly."""
        fill_wait = (self.max_wait_ms / 1e3
                     if self.batching == "fixed" else None)
        inflight: _Inflight | None = None
        while True:
            if inflight is None:
                first = self._get(None)   # idle: block for a request
                if first is _STOPPED:
                    return
            else:
                first = self._get(0.001)  # overlap: poll between checks
                if first is _EMPTY or first is _STOPPED:
                    if first is _STOPPED or inflight.ready():
                        inflight = self._finish(inflight)
                    continue
            tenant, items = self._gather(first, fill_wait)
            items = self._sweep_expired(items)
            if not items:
                continue
            if not self.overlap:
                self._dispatch(tenant, items)
                continue
            try:
                launched = self._launch(tenant, items)
            except Exception as e:   # noqa: BLE001 — recovery boundary
                if inflight is not None:
                    inflight = self._finish(inflight)
                self._dispatch(tenant, items, first_err=e)
                continue
            if inflight is not None:
                self._finish(inflight)
            inflight = launched

    def close(self) -> None:
        """Stop the batcher (if started), drain the queue, and reject all
        later ``submit``/``start`` calls.  Submitters blocked at a full
        queue are woken and raise.  An in-flight batch is completed,
        never abandoned.  If the batcher doesn't stop within
        ``close_timeout`` it raises but stays retryable."""
        with self._space:
            self._closed = True      # new submits now raise, not enqueue
            self._stopping = True    # the batcher drains, then exits
            self._space.notify_all()  # wake admission-blocked submitters
            self._avail.notify_all()  # wake the batcher's work wait
            t = self._thread
        if t is not None:
            t.join(timeout=self.close_timeout)
            if t.is_alive():
                raise RuntimeError(
                    f"batcher thread did not stop within "
                    f"{self.close_timeout}s (slow batch in flight?); "
                    "call close() again to retry the shutdown")
            with self._lifecycle:
                self._thread = None
        self._drain_lock.acquire()   # waits out a legal in-flight flush
        try:
            self._drain_queue()
        finally:
            self._drain_lock.release()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        # the with-form has no retry path: wait out slow (not hung)
        # batches, bounded at 20 x close_timeout
        for _ in range(20):
            try:
                self.close()
                return
            except RuntimeError:
                if self._thread is None:
                    raise            # not a batcher timeout: genuine error
                time.sleep(0.01)     # slow batch in flight: keep waiting
        self.close()                 # final attempt: let the timeout raise

    async def __aenter__(self):
        return self.start()

    async def __aexit__(self, *exc):
        # close() joins the batcher thread and may drain batches: off
        # the event loop, so in-flight awaits can still resolve
        await asyncio.get_running_loop().run_in_executor(
            None, self.__exit__)


def replay_batches(svc: PipelineService, tenant=None) -> int:
    """Verify a ``record_batches=True`` service bit for bit: re-run every
    logged (bucket, requests) packing through the same bucket plan and
    compare each delivered response with its replayed row
    (``assert_array_equal``).  Returns the number of requests checked.
    Only packings that delivered results are logged, so a fault-injected
    run replays exactly its healthy dispatches.

    The replay runs on the caller's current streams, ordered after the
    service's stream on every device of the tenant.  ``tenant=`` (a name
    or :class:`Tenant`) restricts the check to one tenant; the default
    verifies every recording tenant."""
    tenants = ([svc._tenant(tenant)] if tenant is not None
               else list(svc.tenants.values()))
    if all(t.batch_log is None for t in tenants):
        raise ValueError("service was not built with record_batches=True")
    checked = 0
    for t in tenants:
        if t.batch_log is None:
            continue
        for d in t.devices:
            stream = svc._streams.get(d)
            if stream is not None:
                torch.cuda.current_stream(d).wait_stream(stream)
        for bucket, items in t.batch_log:
            if any(f.exception(timeout=0) is not None for _, f in items):
                # a failed batch delivered exceptions, not rows
                continue
            batch = svc._pack(t, bucket, items)
            plan = t.plans.get(bucket, t.plan)
            want = plan(torch.from_numpy(batch)).cpu().numpy()
            for i, (_, fut) in enumerate(items):
                np.testing.assert_array_equal(
                    np.asarray(fut.result(timeout=0)), want[i],
                    err_msg=f"tenant {t.name!r} bucket {bucket} row {i} "
                            "!= replayed plan row")
                checked += 1
    return checked


__all__ = ["PipelineService", "Tenant", "PRIORITIES", "bucket_ladder",
           "replay_batches", "HOST_PARTS", "CARD_PARTS"]
