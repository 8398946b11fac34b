"""Planner: shape-specialize a pipeline graph, fuse adjacent elementwise
nodes, pick each node's lowering, and memoize the compiled plan.

``compile(graph, shapes, lowering=..., precision=..., device=...)``
returns a :class:`Plan`; the cache key is ``(graph.signature, input
shapes and dtypes, device, lowering, precision, quantize engine, block
configs, fuse, tuner state)``, so a second identical call is a dict
lookup that returns the same Plan.

Op catalog: every node's implementation, lowerings, attr schema and
fusion trait come from :mod:`repro_torch.core.opdefs` (:data:`OPS` *is*
``opdefs.OPDEFS``); a graph naming an op missing there fails to compile.

Lowerings: ``native`` and ``conv`` are plain torch; ``kernel`` (the
reference's ``pallas``) runs the hand-written CUDA kernels, and on a CPU
plan their plain torch versions.  ``lowering=`` is one name for every
node or a per-node dict; ``"reference"`` is an alias for ``native``.  A
node that does not support the requested lowering runs ``native``, and
the substitution is recorded on ``Plan.downgrades`` and warned once per
graph.

Precision: ``precision=`` is ``"f32"`` (default), ``"bf16"`` (inputs
and output of every node rounded through bfloat16 around its f32 impl,
any lowering), ``"int8"`` (the quantized impls of the matmul-shaped ops:
const weights quantized once at compile onto the plan's device,
``Plan.qconsts``; activations per call; ``kernel`` runs the int8 CUDA
kernels where the op's ``q_lowerings`` has it, any other lowering the
torch integer path), or a per-node dict.  A node that does not support
the tier runs f32, recorded dimension-tagged on ``Plan.downgrades``
(``"precision:int8"``, comma-joined with a ``"lowering:..."`` tag) and
warned once per graph.

Fusion: maximal runs of adjacent single-consumer elementwise nodes
(at least two) collapse into one ``fused_ew`` node -- one launch of the
chain kernel under ``kernel``.  A dict precision is a fusion boundary:
a run whose members ask for different tiers stays unfused.

Autotuning (:mod:`repro_torch.graph.autotune`): ``lowering="auto"``
picks each node's lowering and block config by measurement on the plan's
device; ``block_configs="auto"`` tunes the block configs of the lowering
each node ends up with; ``precision="auto"`` (also as one node's entry
of a dict) searches the tier jointly with the lowering, gated by the
op's accuracy Budget; ``fuse="auto"`` measures each elementwise chain
fused against unfused.  ``fuse=None`` is ``"auto"`` for a
``lowering="auto"`` plan and ``True`` otherwise.  ``autotune_kwargs``
pass to the tuner (``repeats``, ``path``, ``lowerings``).  A tuned plan's
cache key holds the tuner's mode, cache path, the cache file's mtime and
those kwargs, so a mode switch or a new cache write never returns a
stale plan; the plan it replaces (same shapes and options, older mtime)
leaves the cache.  ``"auto"`` is a plan-wide lowering only: a per-node
lowering dict that holds it raises.  Unmeasured (``TINA_AUTOTUNE=off``
or a cached miss), a tuned node runs its kernel at the default tile.

Outputs: as the reference's jit outputs, each is dense and owns its
memory: a view is made contiguous and an output sharing storage with a
plan input or const is copied (``_owned``).

Streams: a plan made or first called on one CUDA stream may be called on
another.  Its consts and int8 weight packs, and the packs made at its
first kernel launch, are kept with the event recorded after they were
made (:class:`repro_torch.Made`), and every call orders its stream after
that event on the card.

Device: plans run on ``"cuda"`` unless ``device=`` (or ``backend=``,
the device type: ``"cpu"``, ``"cuda"`` or ``"gpu"``) says otherwise;
asking for CUDA without a card raises RuntimeError.  Graph consts become
device tensors once, here, not per call.  Shape inference runs the
native lowering on ``"meta"`` tensors.

Mesh sharding: ``compile(..., mesh=...)`` (or ``shard="batch"``) splits
the batch axis -- the leading dim of every graph input -- across a
:class:`~repro_torch.launch.mesh.BatchMesh`.  A sharded plan holds one
per-shard plan per distinct device of the mesh, each this module's
single-device plan compiled at the per-shard shape for that device, so
its consts and kernel packs live there; shape inference, fusion and the
autotuner see per-shard shapes.  Logical shards of one device share its
per-shard plan.  Each shard runs under ``torch.cuda.device(d)`` on a
CUDA stream of its own, after the caller's stream; the output is the
shards' outputs concatenated on the mesh's first device, bit for bit
the per-shard plan run on each slice (every row is computed apart).
:meth:`Plan.run_shards` leaves each shard's output on its device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import Made, obs, resolve_device
from repro_torch.core import quantize
from repro_torch.core.opdefs import OPDEFS, bf16_round
from repro_torch.graph.graph import Graph, Node
from repro_torch.launch.mesh import (BatchMesh, BatchSharding, Shards,
                                     make_batch_mesh)

OPS = OPDEFS
LOWERINGS = ("native", "conv", "kernel")
TIERS = ("f32", "bf16", "int8", "auto")


def apply_node(node: Node, args: Sequence[torch.Tensor], lowering: str,
               block: dict | None = None, precision: str = "f32",
               qpack=None, kpack=None) -> torch.Tensor:
    """Execute one graph node through its OpDef.

    An unsupported lowering runs native and an unsupported precision f32
    (the planner records such substitutions ahead of time).  ``"int8"``
    runs the op's quantized impl (``qpack``: the plan-built weight pack,
    or None to quantize per call), its lowering limited to the op's
    ``q_lowerings``; ``"bf16"`` rounds inputs and output through
    bfloat16 around the f32 impl.  An op declaring a tier but no qimpl
    is precision-transparent: its f32 impl is its behavior there.
    ``kpack``: an f32 node's plan-built kernel pack (the OpDef's
    ``kprep``), handed to its impl."""
    d = OPS[node.op]
    at = d.bind(node.attr)
    if lowering not in d.lowerings:
        lowering = "native"
    if precision not in (None, "f32") \
            and not d.supports_precision(precision, at):
        precision = "f32"
    if precision == "int8" and d.qimpl is not None:
        if lowering not in d.q_lowerings:
            lowering = "native"
        return d.qimpl(list(args), at, qpack, lowering, block)
    if precision == "bf16":
        args = [bf16_round(a) for a in args]
        return bf16_round(d.impl(list(args), at, lowering, block))
    if kpack is not None:
        return d.impl(list(args), at, lowering, block, kpack=kpack)
    return d.impl(list(args), at, lowering, block)


def _const_tensor(value: np.ndarray, device) -> torch.Tensor:
    """A graph const on ``device``, in the precision the reference runs
    it at (JAX without 64-bit mode: float64 -> float32)."""
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.complex128:
        arr = arr.astype(np.complex64)
    return torch.as_tensor(arr, device=device)


# ---------------------------------------------------------------------------
# Execution + shape inference
# ---------------------------------------------------------------------------
def _execute(graph: Graph, env: dict[str, torch.Tensor],
             lowerings: dict[str, str],
             configs: dict[str, dict] | None = None,
             precisions: dict[str, str] | None = None,
             qconsts: dict[str, tuple] | None = None,
             kconsts: dict[str, list] | None = None):
    """Run ``graph`` from ``env`` (inputs and consts by name), each node
    under a ``node.<op>`` span: the host time of its OpDef impl and
    kernel wrapper (checks, allocations, copies, the launch)."""
    configs = configs or {}
    precisions = precisions or {}
    qconsts = qconsts or {}
    kconsts = kconsts or {}
    env = dict(env)
    for node in graph.topo():
        if node.op in ("input", "const"):
            continue
        with obs.span(f"node.{node.op}", cat="plan", node=node.name):
            env[node.name] = apply_node(
                node, [env[i] for i in node.inputs],
                lowerings.get(node.name, "native"), configs.get(node.name),
                precisions.get(node.name, "f32"), qconsts.get(node.name),
                kconsts.get(node.name))
    outs = tuple(env[o] for o in graph.outputs)
    return outs[0] if len(outs) == 1 else outs


def infer(graph: Graph, input_specs: dict[str, tuple]
          ) -> dict[str, torch.Tensor]:
    """Shape-evaluate every node (native lowering) on ``meta`` tensors:
    name -> meta tensor carrying the node's shape and dtype."""
    env = {n: torch.empty(shape, dtype=dtype, device="meta")
           for n, (shape, dtype) in input_specs.items()}
    for node in graph.topo():
        if node.op == "const":
            env[node.name] = _const_tensor(graph.consts[node.name], "meta")
        elif node.op != "input":
            env[node.name] = apply_node(
                node, [env[i] for i in node.inputs], "native")
    return env


# ---------------------------------------------------------------------------
# Elementwise fusion pass
# ---------------------------------------------------------------------------
def _step_of(node: Node) -> tuple | None:
    """The node's fused-chain step, from its OpDef's ``fuse_step``."""
    d = OPS.get(node.op)
    if d is None or not d.elementwise or d.fuse_step is None:
        return None
    return d.fuse_step(d.bind(node.attr))


def run_to_steps(run: Sequence[Node]) -> tuple[tuple, tuple[str, ...]]:
    """A run of elementwise nodes -> (fused steps, operand node names);
    ``"mul"``/``"add"`` consume the node's second input as an operand."""
    steps: list[tuple] = []
    operands: list[str] = []
    for n in run:
        step = _step_of(n)
        if step is None:
            raise ValueError(f"unfusable op {n.op!r} in run")
        steps.append(step)
        if step[0] in ("mul", "add"):
            operands.append(n.inputs[1])
    return tuple(steps), tuple(operands)


def fuse_elementwise(graph: Graph, avals: dict[str, torch.Tensor],
                     keep: Callable[[list[Node]], bool] | None = None
                     ) -> Graph:
    """Collapse maximal runs of adjacent single-consumer elementwise
    nodes into ``fused_ew`` nodes.  A complex-input elementwise node only
    joins as an ``abs2`` run head (the chain kernel is real).  ``keep``
    filters the candidate runs."""
    consumers = graph.consumers()

    def _is_abs2(node: Node) -> bool:
        step = _step_of(node)
        return step is not None and step[0] == "abs2"

    def fusable(node: Node) -> bool:
        if _step_of(node) is None:
            return False
        return _is_abs2(node) or not any(
            avals[i].dtype.is_complex
            for i in node.inputs if graph.nodes[i].op != "const")

    runs: list[list[Node]] = []
    run_of: dict[str, int] = {}
    for node in graph.topo():
        if not fusable(node):
            continue
        prev = node.inputs[0] if node.inputs else None
        if (prev in run_of and not _is_abs2(node)
                and len(consumers[prev]) == 1
                and prev not in graph.outputs):
            idx = run_of[prev]
            runs[idx].append(node)
            run_of[node.name] = idx
        else:
            run_of[node.name] = len(runs)
            runs.append([node])
    runs = [r for r in runs if len(r) >= 2]
    if keep is not None:
        runs = [r for r in runs if keep(r)]
    if not runs:
        return graph

    # each fused node sits at its run TAIL's topo position: by then every
    # input of every member exists in the rebuilt graph
    tail_of = {r[-1].name: r for r in runs}
    merged = {n.name for r in runs for n in r}
    out = Graph(graph.name + "+fused")
    out.consts = dict(graph.consts)
    renamed: dict[str, str] = {}

    def resolve(name: str) -> str:
        return renamed.get(name, name)

    for node in graph.topo():
        if node.name in merged and node.name not in tail_of:
            continue
        if node.name in tail_of:
            run = tail_of[node.name]
            steps, operand_refs = run_to_steps(run)
            fname = f"fused_{run[0].name}"
            out._add(Node(fname, "fused_ew",
                          (resolve(run[0].inputs[0]),
                           *(resolve(o) for o in operand_refs)),
                          (("members", tuple(n.name for n in run)),
                           ("steps", steps))))
            renamed[node.name] = fname
        elif node.op == "input":
            out.inputs.append(node.name)
            out._add(node)
        else:
            out._add(Node(node.name, node.op,
                          tuple(resolve(i) for i in node.inputs),
                          node.attrs))
    out.outputs = [resolve(o) for o in graph.outputs]
    return out


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Plan:
    graph: Graph                  # post-fusion graph the plan executes
    input_names: tuple[str, ...]
    lowerings: dict[str, str]     # node name -> effective lowering
    key: tuple
    device: torch.device
    input_specs: dict[str, tuple] = dataclasses.field(default_factory=dict)
    # input name -> (shape, dtype) the plan was specialized for
    configs: dict[str, dict] = dataclasses.field(default_factory=dict)
    # node name -> block config ({} = kernel defaults)
    downgrades: dict[str, str] = dataclasses.field(default_factory=dict)
    # node name -> dimension-tagged request(s) the node could not honor:
    # "lowering:kernel", "precision:int8", or both comma-joined
    consts: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # graph consts, on the plan's device since compile
    precisions: dict[str, str] = dataclasses.field(default_factory=dict)
    # node name -> effective execution precision
    qconsts: dict[str, tuple] = dataclasses.field(default_factory=dict)
    # node name -> int8 (q, scale) weight pack, quantized once at compile
    # on the plan's device by the OpDef's qprep
    kconsts: dict[str, list] = dataclasses.field(default_factory=dict)
    # node name -> an f32 kernel node's pack from the OpDef's kprep (the
    # GEMM's TF32 planes of its const y), filled at its first launch
    made: Made | None = None
    # consts and qconsts with the event recorded after compile made them
    mesh: BatchMesh | None = None   # the device mesh of a sharded plan
    batch_axis: str | None = None   # the mesh axis carrying the batch dim
    input_shardings: tuple = ()     # a BatchSharding per input (sharded)
    shard_plans: dict = dataclasses.field(default_factory=dict)
    # device -> the per-shard single-device plan run there (sharded)

    @property
    def node_lowerings(self) -> dict[str, str]:
        """Effective per-node lowerings (requests a node doesn't support
        appear as ``native`` here and in :attr:`downgrades`)."""
        return self.lowerings

    @property
    def node_precisions(self) -> dict[str, str]:
        """Effective per-node precisions (requested tiers a node doesn't
        support appear as ``f32`` here and in :attr:`downgrades`)."""
        return self.precisions

    def _arrays(self, args, kwargs) -> list:
        arrays = list(args)
        for name in self.input_names[len(arrays):]:
            arrays.append(kwargs[name])
        return arrays

    def shard_inputs(self, *arrays):
        """Split each input's batch and put slice i on the mesh's device
        i ahead of the call (a :class:`~repro_torch.launch.mesh.Shards`
        per input; one input gives one); unsharded, the inputs as they
        are."""
        if not self.input_shardings:
            return arrays if len(arrays) > 1 else arrays[0]
        out = tuple(self._place(name, a, s) for name, a, s in zip(
            self.input_names, arrays, self.input_shardings))
        return out if len(out) > 1 else out[0]

    def _place(self, name: str, a, sharding: BatchSharding) -> Shards:
        if isinstance(a, Shards):
            return a
        shape, dtype = self.input_specs[name]
        if tuple(a.shape) != shape:
            raise ValueError(
                f"plan for {self.graph.name!r} was compiled for {name} "
                f"{dtype}{shape}, got {tuple(a.shape)}")
        return sharding.place(a)

    def run_shards(self, *args, **kwargs) -> list:
        """Run a sharded plan and leave each shard's output (a tensor, or
        a tuple of them) on its own device, in mesh order.  Inputs are
        whole batches or :meth:`shard_inputs`' result.  On the card shard
        i runs under ``torch.cuda.device(d)`` on a stream of its own,
        ordered after the current stream of ``d`` at the call; on return
        the current stream of every mesh device is ordered after its
        shards, so the outputs are ready there.  The shard streams belong
        to that current stream (one set per caller stream), so memory a
        shard frees is reused only by work ordered after the caller's:
        no ``record_stream``, whose deferred frees would make every call
        allocate anew while the card is behind.  On the CPU the shards
        run one after another."""
        if self.mesh is None:
            raise ValueError(f"plan for {self.graph.name!r} is not sharded")
        parts = [self._place(name, a, s) for name, a, s in zip(
            self.input_names, self._arrays(args, kwargs),
            self.input_shardings)]
        devices = self.mesh.devices
        for p in parts:
            if len(p) != len(devices):
                raise ValueError(f"{len(p)} shards for a mesh of "
                                 f"{len(devices)}")
        if self.mesh.device_type != "cuda":
            return [self.shard_plans[d](*(p[i] for p in parts))
                    for i, d in enumerate(devices)]
        callers = {d: torch.cuda.current_stream(d) for d in self.mesh.distinct}
        streams = _shard_streams(callers, devices)
        outs = []
        for i, d in enumerate(devices):
            s = streams[i]
            s.wait_stream(callers[d])
            with torch.cuda.device(d), torch.cuda.stream(s):
                outs.append(self.shard_plans[d](*(p[i] for p in parts)))
        for i, d in enumerate(devices):
            callers[d].wait_stream(streams[i])
        return outs

    def gather(self, outs: list):
        """The shards' outputs (:meth:`run_shards`) as one batch on the
        mesh's first device: a tensor of its own, never a view of a
        shard's output (one shard's output is that tensor already)."""
        if len(outs) == 1:
            return outs[0]
        d0 = self.mesh.devices[0]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j].to(d0) for o in outs])
                         for j in range(len(outs[0])))
        return torch.cat([o.to(d0) for o in outs])

    def __call__(self, *args, **kwargs):
        # plan.run: the consts' readiness, the input checks, the nodes
        # (node.* spans; a sharded plan's per-shard plan.run spans) and
        # the outputs made the caller's own
        with obs.span("plan.run", cat="plan", graph=self.graph.name):
            if self.mesh is not None:
                return self.gather(self.run_shards(*args, **kwargs))
            if self.made is not None:
                self.made.get()
            arrays = self._arrays(args, kwargs)
            env = dict(self.consts)
            for name, a in zip(self.input_names, arrays):
                t = torch.as_tensor(a, device=self.device)
                shape, dtype = self.input_specs[name]
                if tuple(t.shape) != shape or t.dtype != dtype:
                    raise ValueError(
                        f"plan for {self.graph.name!r} was compiled for "
                        f"{name} {dtype}{shape}, got "
                        f"{t.dtype}{tuple(t.shape)}")
                env[name] = t
            outs = _execute(self.graph, env, self.lowerings, self.configs,
                            self.precisions, self.qconsts, self.kconsts)
            held = [*(env[n] for n in self.input_names),
                    *self.consts.values()]
            if isinstance(outs, tuple):
                fresh = []
                for o in outs:
                    fresh.append(_owned(o, held + fresh))
                return tuple(fresh)
            return _owned(outs, held)


def _storage_span(t: torch.Tensor) -> tuple:
    s = t.untyped_storage()
    return t.device, s.data_ptr(), s.data_ptr() + s.nbytes()


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the storages under ``a`` and ``b`` share any byte."""
    da, a0, a1 = _storage_span(a)
    db, b0, b1 = _storage_span(b)
    return da == db and a0 < b1 and b0 < a1


def _owned(out: torch.Tensor, held: list[torch.Tensor]) -> torch.Tensor:
    """A plan output as the reference returns one: dense, and in memory
    of its own.  A view (``downsample``, ``frame_decimate``, ``real``,
    ``unfold`` at ``native``, the stride-2 tail of ``fir_decimate``)
    becomes a contiguous copy; a dense output that shares storage with a
    plan input, a plan const or an earlier output is copied, so a caller
    who edits its input, or the plan's next call, cannot change it."""
    if not out.is_contiguous():
        return out.contiguous()
    if any(_overlaps(out, t) for t in held):
        return out.clone()
    return out


_STREAMS: dict[tuple, torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()


def _shard_streams(callers: dict, devices: tuple) -> list:
    """The CUDA stream of each shard on ``devices`` for the caller's
    streams ``callers`` (device -> its current stream): one per (caller
    stream, shard index), made once and shared by every plan.  Each is
    drawn from torch's high-priority pool, apart from the default-priority
    streams callers make (a service's), and no two keys share one while
    the pool's 32 streams a device last: memory one caller's shard frees
    must not be handed to another caller's work."""
    want = [(d, callers[d].cuda_stream, i) for i, d in enumerate(devices)]
    if any(k not in _STREAMS for k in want):
        with _STREAMS_LOCK:
            for k in want:
                if k in _STREAMS:
                    continue
                taken = {s.cuda_stream for s in _STREAMS.values()}
                for _ in range(32):
                    s = torch.cuda.Stream(k[0], priority=-1)
                    if s.cuda_stream not in taken:
                        break
                _STREAMS[k] = s
    return [_STREAMS[k] for k in want]


_CACHE: dict[tuple, Plan] = {}
_WARNED_DOWNGRADES: set[tuple] = set()

# cache_stats() reads these same counters compile()/clear_cache() bump
_HITS = obs.counter("plan.cache.hits")
_MISSES = obs.counter("plan.cache.misses")
_EVICTIONS = obs.counter("plan.cache.evictions")


def cache_stats() -> dict:
    """Plan-cache telemetry: size + hit/miss/eviction counts."""
    return {"size": len(_CACHE), "hits": _HITS.value,
            "misses": _MISSES.value, "evictions": _EVICTIONS.value}


def clear_cache() -> None:
    _EVICTIONS.add(len(_CACHE))
    _CACHE.clear()
    _HITS.reset()
    _MISSES.reset()


def _warn_downgrades(graph: Graph, downgrades: dict[str, str]) -> None:
    """Warn once per (graph, downgrade set) that nodes fell back, saying
    which dimension did: a requested-kernel-got-native or requested-int8-
    got-f32 plan must be visible."""
    key = (graph.name, tuple(sorted(downgrades.items())))
    if key in _WARNED_DOWNGRADES:
        return
    _WARNED_DOWNGRADES.add(key)
    by_dim: dict[str, dict[str, str]] = {"lowering": {}, "precision": {}}
    for name, tags in downgrades.items():
        for tag in tags.split(","):
            dim, _, req = tag.partition(":")
            by_dim.setdefault(dim, {})[name] = req
    parts = []
    for dim, fallback, supports in (("lowering", "native", "lowerings"),
                                    ("precision", "f32", "precisions")):
        if by_dim[dim]:
            detail = ", ".join(
                f"{name} ({graph.nodes[name].op}: requested {req!r}, "
                f"supports "
                f"{'/'.join(getattr(OPS[graph.nodes[name].op], supports))})"
                for name, req in sorted(by_dim[dim].items()))
            parts.append(f"{len(by_dim[dim])} node(s) fell back to "
                         f"{dim}={fallback!r}: {detail}")
    warnings.warn(
        f"plan for {graph.name!r}: " + "; ".join(parts)
        + "; see Plan.downgrades / Plan.node_lowerings", stacklevel=3)


def _dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    return getattr(torch, np.dtype(d).name)


def _norm_specs(graph: Graph, shapes, dtype) -> dict[str, tuple]:
    """shapes: a shape (one input), a sequence of shapes, or {input:
    shape | (shape, dtype)} -> {input: (shape, torch dtype)}."""
    if not isinstance(shapes, dict):
        shapes = ({graph.inputs[0]: shapes} if len(graph.inputs) == 1
                  else dict(zip(graph.inputs, shapes)))
    specs = {}
    for name in graph.inputs:
        s = shapes[name]
        if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], tuple):
            specs[name] = (tuple(int(d) for d in s[0]), _dtype(s[1]))
        else:
            specs[name] = (tuple(int(d) for d in s), _dtype(dtype))
    return specs


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Every compile-time knob in one value object; derive variants with
    :meth:`replace`.  ``device=None`` means ``backend``'s device type,
    and with no backend ``"cuda"``; a mesh's plans run on its devices."""

    dtype: str = "float32"
    device: str | None = None
    backend: str | None = None        # device type: "cpu", "cuda" or "gpu"
    lowering: object = "native"       # str | "auto" | {node: str}
    block_configs: object = None      # None | "auto" | {node: {param: int}}
    fuse: object = None               # None | bool | "auto"
    precision: object = "f32"          # str | "auto" | {node: str}
    mesh: object = None               # BatchMesh | int shard count | None
    shard: str | None = None          # "batch": shard over every device
    autotune_kwargs: dict | None = None

    def replace(self, **changes) -> "CompileOptions":
        """A copy with the given fields changed (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)


BACKENDS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def _device_request(o: CompileOptions):
    """``device=``, checked against ``backend=``; else the backend's
    device type (None: the card)."""
    if o.backend is None:
        return o.device
    kind = BACKENDS.get(o.backend)
    if kind is None:
        raise ValueError(f"backend={o.backend!r}: expected one of "
                         f"{sorted(BACKENDS)}")
    if o.device is not None and torch.device(o.device).type != kind:
        raise ValueError(f"backend={o.backend!r} contradicts "
                         f"device={str(o.device)!r}")
    return kind if o.device is None else o.device


def _norm_mesh(mesh, shard, device=None
               ) -> tuple[BatchMesh | None, str | None]:
    """Normalize ``(mesh=, shard=)`` into (BatchMesh, batch-axis name).

    ``mesh`` may be a BatchMesh, a device count (a mesh of that many
    devices of ``device``'s type, by
    :func:`repro_torch.launch.mesh.make_batch_mesh`), or None;
    ``shard="batch"`` alone shards over every visible card (one logical
    shard on the CPU).  A ``device`` that names another device than the
    mesh's first raises."""
    if mesh is None and shard is None:
        return None, None
    if shard not in (None, "batch"):
        raise ValueError(
            f"shard={shard!r}: only 'batch' (data-parallel over the "
            "leading input dim) is supported")
    if mesh is None:
        mesh = make_batch_mesh(device=device)
    elif isinstance(mesh, int) and not isinstance(mesh, bool):
        mesh = make_batch_mesh(mesh, device=device)
    elif not isinstance(mesh, BatchMesh):
        raise TypeError(f"mesh= expects a BatchMesh, an int device count, "
                        f"or None; got {type(mesh).__name__}")
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device_type or (
                want.index is not None and want != mesh.devices[0]):
            raise ValueError(
                f"device={str(device)!r} contradicts the mesh's devices "
                f"{[str(d) for d in mesh.devices]}")
    return mesh, mesh.axis


def normalize_mesh(o: CompileOptions
                   ) -> tuple[CompileOptions, BatchMesh | None, torch.device]:
    """``o`` with its ``mesh=``/``shard=`` made one BatchMesh (so every
    later compile of a runner or a service keys on that mesh, and
    ``mesh=1`` is not rebuilt per push), the mesh (None: unsharded), and
    the device its plans run on: the mesh's first device, else
    ``device=``/``backend=`` (default: the card)."""
    req = _device_request(o)
    mesh, _ = _norm_mesh(o.mesh, o.shard, req)
    if mesh is None:
        return o, None, resolve_device(req)
    return o.replace(mesh=mesh, shard=None), mesh, mesh.devices[0]


def _check_ported(o: CompileOptions) -> None:
    prec = o.precision if o.precision is not None else "f32"
    tiers = set(prec.values()) if isinstance(prec, dict) else {prec}
    bad = tiers - set(TIERS)
    if bad:
        raise ValueError(f"precision: unknown tier(s) {sorted(bad)}; "
                         f"expected one of {TIERS} or a per-node dict")
    if not (o.block_configs in (None, "auto")
            or isinstance(o.block_configs, dict)):
        raise ValueError(f"block_configs={o.block_configs!r}: expected None, "
                         "'auto' or a {node: {param: int}} dict")
    if o.fuse not in (None, True, False, "auto"):
        raise ValueError(f"fuse={o.fuse!r}: expected None, True, False or "
                         "'auto'")
    if isinstance(o.lowering, dict) and "auto" in o.lowering.values():
        raise ValueError("lowering: 'auto' tunes the whole plan "
                         "(lowering='auto'); a per-node dict names fixed "
                         f"lowerings, one of {LOWERINGS}")
    requested = (set(o.lowering.values()) if isinstance(o.lowering, dict)
                 else {o.lowering})
    bad = requested - set(LOWERINGS) - {"reference", "auto"}
    if bad:
        raise ValueError(f"unknown lowering(s) {sorted(bad)}; expected one "
                         f"of {LOWERINGS}, 'auto' or 'reference' (the "
                         "reference's 'pallas' is 'kernel' here)")


def compile(graph: Graph, shapes, *, options: CompileOptions | None = None,
            **changes) -> Plan:
    """Compile ``graph`` for the given input shapes; memoized.

    Knobs ride a :class:`CompileOptions` (``options=``), or keyword
    arguments naming its fields, applied over ``options``::

        compile(g, {"x": (16, 4096)}, lowering="kernel")            # cuda
        compile(g, {"x": (4096,)}, lowering="kernel", device="cpu")
        compile(g, {"x": (16, 4096)}, lowering="auto")    # measured

    ``lowering``: one name for every node, a {node: lowering} dict
    (post- or pre-fusion names; a fused node honors its members' request
    when they agree), or ``"auto"`` (the autotuner picks per node).
    ``precision``: ``"f32"``, ``"bf16"``, ``"int8"``, ``"auto"`` or a
    {node: tier} dict (module docstring).  ``block_configs``: None
    (kernel defaults; with ``lowering="auto"`` tuned with the lowering),
    ``"auto"`` (tuned for each node's lowering) or {node: {param: int}}
    kernel block sizes, validated at the kernel boundary (explicit
    entries win over tuned ones).  ``fuse``: collapse elementwise chains
    (True), never (False), or as measured (``"auto"``); None is
    ``"auto"`` for ``lowering="auto"`` and True otherwise.
    ``mesh`` / ``shard``: a BatchMesh or a device count shards the batch
    axis (every input's leading dim, which the shard count must divide)
    across the mesh; ``shard="batch"`` alone shards over every card.  The
    cache key holds the mesh's axis, shard count and devices, so
    ``mesh=1`` and ``make_batch_mesh(1)`` share an entry (module
    docstring).
    """
    # plan.lookup: the options and shapes made into the cache key, and
    # the cache's answer; a miss compiles after it, under plan.compile
    with obs.span("plan.lookup", cat="compile", graph=graph.name) as lookup:
        o = options or CompileOptions()
        if changes:
            o = o.replace(**changes)
        _check_ported(o)
        req = _device_request(o)
        mesh, batch_axis = _norm_mesh(o.mesh, o.shard, req)
        device = mesh.devices[0] if mesh is not None else resolve_device(req)
        lowering = o.lowering
        if lowering == "reference":
            lowering = "native"
        elif isinstance(lowering, dict):
            lowering = {n: ("native" if lw == "reference" else lw)
                        for n, lw in lowering.items()}
        precision = o.precision if o.precision is not None else "f32"
        fuse = o.fuse
        if fuse is None:
            fuse = "auto" if lowering == "auto" else True
        block_configs = o.block_configs
        tune_kw = dict(o.autotune_kwargs or {})
        prec_auto = (precision == "auto"
                     or (isinstance(precision, dict)
                         and "auto" in precision.values()))
        specs = _norm_specs(graph, shapes, o.dtype)
        if mesh is not None:
            for name in graph.inputs:
                shape = specs[name][0]
                if len(shape) < 2:
                    raise ValueError(
                        f"sharded plans need a batch axis: input {name!r} "
                        f"has shape {shape}; provide (batch, ...) inputs")
                if shape[0] % mesh.size:
                    raise ValueError(
                        f"batch divisibility: input {name!r} batch dim "
                        f"{shape[0]} is not divisible by the mesh's "
                        f"{batch_axis!r} axis ({mesh.size} shards)")
        spec_key = tuple((n, specs[n][0], str(specs[n][1]))
                         for n in graph.inputs)
        low_key = (tuple(sorted(lowering.items()))
                   if isinstance(lowering, dict) else lowering)
        prec_key = (tuple(sorted(precision.items()))
                    if isinstance(precision, dict) else precision)
        cfg_key = (tuple(sorted((n, tuple(sorted(c.items())))
                                for n, c in block_configs.items()))
                   if isinstance(block_configs, dict) else block_configs)
        tune_key = None
        if (lowering == "auto" or block_configs == "auto" or fuse == "auto"
                or prec_auto):
            # tuned selections depend on the autotune mode, the cache
            # file (path AND content: another process's entries must reach
            # plans compiled after its write, hence the mtime) and the
            # tuner kwargs; none of these may return a stale memoized plan
            from repro_torch.graph import autotune
            path = tune_kw.get("path") or autotune.cache_path()
            tune_key = (autotune.mode(), path, autotune._mtime(path),
                        repr(sorted(tune_kw.items())))
        # the quantize engine is part of the key: an engine_override("ref")
        # compile must not collide with the default "int" plans
        key = (graph.signature, spec_key, str(device), low_key, prec_key,
               quantize.engine(), cfg_key, fuse,
               None if mesh is None else mesh.key, tune_key)
        plan = _CACHE.get(key)
        lookup.set(hit=plan is not None)
    if plan is not None:
        _HITS.add()
        return plan
    _MISSES.add()
    if mesh is not None:
        return _store(key, _compile_sharded(graph, specs, o, mesh), tune_key)
    with obs.span("plan.compile", cat="compile", graph=graph.name,
                  device=str(device), lowering=str(low_key),
                  precision=str(prec_key),
                  shapes=",".join(f"{n}:{specs[n][0]}"
                                  for n in graph.inputs)):
        for node in graph.topo():
            if node.op in ("input", "const"):
                continue
            if node.op not in OPS:
                raise ValueError(f"{node.name}: unknown op {node.op!r}; "
                                 f"known ops: {sorted(OPS)}")
            try:
                OPS[node.op].bind(node.attr)
            except ValueError as e:
                raise ValueError(f"{node.name}: {e}") from None
        avals = infer(graph, specs)

        def req_prec(name: str) -> str:
            """The precision requested for a (pre-fusion) node name."""
            if not isinstance(precision, dict):
                return precision
            return precision.get(name, "f32")

        with obs.span("plan.fuse", cat="compile", graph=graph.name,
                      mode=str(fuse)):
            keeps: list[Callable] = []
            if isinstance(precision, dict):
                # precision boundaries are fusion boundaries: a fused node
                # runs at ONE tier, so a run whose members ask for
                # different tiers stays unfused
                keeps.append(lambda run: len(
                    {req_prec(n.name) for n in run}) == 1)
            if fuse == "auto":
                from repro_torch.graph import autotune
                # a fixed plan-wide lowering is what the verdict is about;
                # for auto or per-node requests measure where it matters:
                # the chain kernel (one launch) against per-member kernels
                probe_lw = (lowering if isinstance(lowering, str)
                            and lowering in LOWERINGS else "kernel")
                keeps.append(lambda run: autotune.pick_fusion(
                    graph, run, avals, device=device, lowering=probe_lw,
                    **tune_kw))
            if fuse:
                keep = (None if not keeps else
                        lambda run: all(k(run) for k in keeps))
                g = fuse_elementwise(graph, avals, keep=keep)
            else:
                g = graph
        if g is not graph:
            avals = infer(g, specs)

        lowerings: dict[str, str] = {}
        configs: dict[str, dict] = {}
        downgrades: dict[str, str] = {}
        precisions: dict[str, str] = {}

        def tag_downgrade(name: str, dim: str, req: str) -> None:
            tag = f"{dim}:{req}"
            downgrades[name] = (f"{downgrades[name]},{tag}"
                                if name in downgrades else tag)

        def members_agree(node: Node, requests: dict):
            """A fused node honors its members' request when they agree."""
            req = {requests[m] for m in node.attr.get("members", ())
                   if m in requests}
            return req.pop() if len(req) == 1 else None

        def req_prec_node(node: Node) -> str:
            if not isinstance(precision, dict):
                return precision
            if node.name in precision:
                return precision[node.name]
            if node.op == "fused_ew":
                return members_agree(node, precision) or "f32"
            return "f32"

        def resolve_prec(node: Node, rp: str) -> None:
            """int8 with a quantized impl keeps the lowering when the qimpl
            has it (q_lowerings: the int8 CUDA kernels); else it quietly
            runs native, the torch integer path -- not a downgrade, the
            integer path IS the tier.  An unsupported tier runs f32,
            recorded, unless the op is pure data movement."""
            d = OPS[node.op]
            if rp == "f32":
                precisions[node.name] = "f32"
            elif d.supports_precision(rp, d.bind(node.attr)):
                precisions[node.name] = rp
                if rp == "int8" and d.qimpl is not None \
                        and lowerings[node.name] not in d.q_lowerings:
                    lowerings[node.name] = "native"
                    configs.pop(node.name, None)
            else:
                precisions[node.name] = "f32"
                if not d.lowering_agnostic:
                    tag_downgrade(node.name, "precision", rp)

        compute = [n for n in g.topo() if n.op not in ("input", "const")]
        with obs.span("plan.autotune", cat="autotune", graph=g.name,
                      mode=(lowering if isinstance(lowering, str)
                            else "per-node")):
            def tuned(node: Node, prec: str = "f32", **kw):
                """One node's (lowering, config) from the tuner."""
                from repro_torch.graph import autotune
                with obs.span("plan.lower", cat="autotune",
                              node=node.name, op=node.op):
                    return autotune.pick(g, node, avals, device=device,
                                         precision=prec, **{**tune_kw, **kw})

            def tune_prec(node: Node, only=None) -> None:
                """precision="auto" for one node: the joint (precision x
                lowering x block) search, budget-gated (``only``
                restricts the lowerings when the caller fixed one)."""
                from repro_torch.graph import autotune
                kw = dict(tune_kw)
                if only is not None:
                    kw["lowerings"] = only
                with obs.span("plan.lower", cat="autotune",
                              node=node.name, op=node.op):
                    lw, cfg, prec = autotune.pick_joint(
                        g, node, avals, device=device, **kw)
                lowerings[node.name] = lw
                configs[node.name] = cfg
                precisions[node.name] = prec

            if lowering == "auto":
                for node in compute:
                    rp = req_prec_node(node)
                    d = OPS[node.op]
                    if rp == "auto":
                        tune_prec(node)
                    elif (rp == "int8" and d.qimpl is not None
                          and d.supports_precision(rp, d.bind(node.attr))):
                        # the integer path has its own lowering x block
                        # search (q_lowerings / qtune_space)
                        lowerings[node.name], configs[node.name] = tuned(
                            node, "int8")
                        precisions[node.name] = "int8"
                    else:
                        lowerings[node.name], configs[node.name] = tuned(
                            node)
                        resolve_prec(node, rp)
            else:
                for node in compute:
                    if isinstance(lowering, dict):
                        req = lowering.get(node.name)
                        if req is None and node.op == "fused_ew":
                            req = members_agree(node, lowering)
                    else:
                        req = lowering
                    d = OPS[node.op]
                    if req is not None and req in d.lowerings:
                        lowerings[node.name] = req
                    else:
                        lowerings[node.name] = "native"
                        if req not in (None, "native") \
                                and not d.lowering_agnostic:
                            tag_downgrade(node.name, "lowering", req)
                for node in compute:
                    rp = req_prec_node(node)
                    if rp == "auto":
                        tune_prec(node, only=(lowerings[node.name],))
                    else:
                        resolve_prec(node, rp)
            if downgrades:
                _warn_downgrades(g, downgrades)

            if block_configs == "auto" and lowering != "auto":
                # tune block configs for the lowerings chosen above
                for node in compute:
                    _, configs[node.name] = tuned(
                        node, precisions[node.name],
                        lowerings=(lowerings[node.name],))
            elif isinstance(block_configs, dict):
                configs.update({n: dict(c)
                                for n, c in block_configs.items()})

        consts = {n.name: _const_tensor(g.consts[n.name], device)
                  for n in g.topo() if n.op == "const"}
        # quantize const weights ONCE, here, on the plan's device: the
        # (q, scale) packs ride the Plan, calls quantize activations only
        qconsts: dict[str, tuple] = {}
        for node in compute:
            d = OPS[node.op]
            if precisions[node.name] != "int8" or d.qprep is None:
                continue
            qp = d.qprep(d.bind(node.attr),
                         {i: consts[ref] for i, ref in enumerate(node.inputs)
                          if ref in consts})
            if qp is not None:
                qconsts[node.name] = qp
        # kernel packs of f32 kernel nodes: slots filled at first launch
        kconsts: dict[str, list] = {}
        for node in compute:
            d = OPS[node.op]
            if (d.kprep is None or precisions[node.name] != "f32"
                    or lowerings[node.name] != "kernel"):
                continue
            kp = d.kprep(d.bind(node.attr),
                         {i: consts[ref] for i, ref in enumerate(node.inputs)
                          if ref in consts})
            if kp is not None:
                kconsts[node.name] = kp

        plan = Plan(graph=g, input_names=tuple(g.inputs),
                    lowerings=lowerings, key=key, device=device,
                    input_specs=specs, configs=configs,
                    downgrades=downgrades, consts=consts,
                    precisions=precisions, qconsts=qconsts,
                    kconsts=kconsts)
        # consts and weight packs were made on the current stream: every
        # call, on whichever stream, waits for them on the card
        plan.made = Made([*consts.values(),
                          *(t for qp in qconsts.values() for t in qp
                            if isinstance(t, torch.Tensor))])
    return _store(key, plan, tune_key)


def _store(key: tuple, plan: Plan, tune_key) -> Plan:
    """Cache ``plan`` under ``key``.  A tuned plan goes under the key of
    the tuner cache's mtime now: tuning may have written the file, and the
    next identical compile must be the cache hit a stream push relies on.
    That write orphans the plans keyed on the older mtime: the one for
    these shapes and options leaves the cache, so a stream's windows keep
    one plan (and one set of consts) each."""
    if tune_key is not None:
        from repro_torch.graph import autotune
        path = tune_key[1]
        key = key[:-1] + ((tune_key[0], path, autotune._mtime(path),
                           tune_key[3]),)
        for k in [k for k in _CACHE if k[:-1] == key[:-1]
                  and k[-1] is not None and k[-1][:2] == key[-1][:2]
                  and k[-1][3] == key[-1][3]]:
            del _CACHE[k]
            _EVICTIONS.add()
    plan.key = key
    _CACHE[key] = plan
    return plan


def _compile_sharded(graph: Graph, specs: dict, o: CompileOptions,
                     mesh: BatchMesh) -> Plan:
    """A sharded plan: the single-device plan at the per-shard shape,
    compiled (and cached) once per distinct device of ``mesh``, under
    that device.  The first device compiles first, so a tuned plan
    measures there and the others read its winners from the tuner's
    cache (their cards have its name)."""
    n = mesh.size
    shard_specs = {name: ((shape[0] // n, *shape[1:]), dt)
                   for name, (shape, dt) in specs.items()}
    per = o.replace(mesh=None, shard=None, backend=None)
    plans = {}
    for d in mesh.distinct:
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            plans[d] = compile(graph, shard_specs,
                               options=per.replace(device=str(d)))
    first = plans[mesh.devices[0]]
    return dataclasses.replace(
        first, device=mesh.devices[0], input_specs=dict(specs), made=None,
        mesh=mesh, batch_axis=mesh.axis,
        input_shardings=tuple(BatchSharding(mesh)
                              for _ in first.input_names),
        shard_plans=plans)


__all__ = ["OPS", "LOWERINGS", "TIERS", "BACKENDS", "Plan", "CompileOptions",
           "apply_node", "compile", "infer", "fuse_elementwise",
           "run_to_steps", "normalize_mesh", "cache_stats", "clear_cache"]
