"""Planner: shape-specialize a pipeline graph, fuse adjacent elementwise
nodes, pick each node's lowering, and memoize the compiled plan.

``compile(graph, shapes, lowering=..., precision=..., device=...)``
returns a :class:`Plan`; the cache key is ``(graph.signature, input
shapes and dtypes, device, lowering, precision, quantize engine, block
configs, fuse)``, so a second identical call is a dict lookup that
returns the same Plan.

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

Device: plans run on ``"cuda"`` unless ``device=`` says otherwise;
asking for CUDA without a card raises RuntimeError.  Graph consts become
device tensors once, here, not per call.  Shape inference runs the
native lowering on ``"meta"`` tensors.

Not yet ported (each raises ValueError): ``precision="auto"``,
``lowering="auto"``, ``block_configs="auto"``, ``fuse="auto"`` and
``mesh``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import quantize
from repro_torch.core.opdefs import OPDEFS, bf16_round
from repro_torch.graph.graph import Graph, Node

OPS = OPDEFS
LOWERINGS = ("native", "conv", "kernel")
TIERS = ("f32", "bf16", "int8", "auto")


def apply_node(node: Node, args: Sequence[torch.Tensor], lowering: str,
               block: dict | None = None, precision: str = "f32",
               qpack=None) -> torch.Tensor:
    """Execute one graph node through its OpDef.

    An unsupported lowering runs native and an unsupported precision f32
    (the planner records such substitutions ahead of time).  ``"int8"``
    runs the op's quantized impl (``qpack``: the plan-built weight pack,
    or None to quantize per call), its lowering limited to the op's
    ``q_lowerings``; ``"bf16"`` rounds inputs and output through
    bfloat16 around the f32 impl.  An op declaring a tier but no qimpl
    is precision-transparent: its f32 impl is its behavior there."""
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
             qconsts: dict[str, tuple] | None = None):
    """Run ``graph`` from ``env`` (inputs and consts by name)."""
    configs = configs or {}
    precisions = precisions or {}
    qconsts = qconsts or {}
    env = dict(env)
    for node in graph.topo():
        if node.op in ("input", "const"):
            continue
        env[node.name] = apply_node(node, [env[i] for i in node.inputs],
                                    lowerings.get(node.name, "native"),
                                    configs.get(node.name),
                                    precisions.get(node.name, "f32"),
                                    qconsts.get(node.name))
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

    def __call__(self, *args, **kwargs):
        arrays = list(args)
        for name in self.input_names[len(arrays):]:
            arrays.append(kwargs[name])
        env = dict(self.consts)
        for name, a in zip(self.input_names, arrays):
            t = torch.as_tensor(a, device=self.device)
            shape, dtype = self.input_specs[name]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(
                    f"plan for {self.graph.name!r} was compiled for {name} "
                    f"{dtype}{shape}, got {t.dtype}{tuple(t.shape)}")
            env[name] = t
        return _execute(self.graph, env, self.lowerings, self.configs,
                        self.precisions, self.qconsts)


_CACHE: dict[tuple, Plan] = {}
_WARNED_DOWNGRADES: set[tuple] = set()

# cache_stats() reads these same counters compile()/clear_cache() bump
_HITS = obs.counter("plan.cache.hits")
_MISSES = obs.counter("plan.cache.misses")
_EVICTIONS = obs.counter("plan.cache.evictions")
_DOWNGRADES = obs.counter("plan.downgrades")


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
    :meth:`replace`.  ``device=None`` means ``"cuda"``."""

    dtype: str = "float32"
    device: str | None = None
    lowering: object = "native"       # str | {node: str}
    block_configs: dict | None = None  # None | {node: {param: int}}
    fuse: bool = True
    precision: object = "f32"          # str | {node: str}
    mesh: object = None

    def replace(self, **changes) -> "CompileOptions":
        """A copy with the given fields changed (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)


def _check_ported(o: CompileOptions) -> None:
    prec = o.precision if o.precision is not None else "f32"
    tiers = set(prec.values()) if isinstance(prec, dict) else {prec}
    bad = tiers - set(TIERS)
    if bad:
        raise ValueError(f"precision: unknown tier(s) {sorted(bad)}; "
                         f"expected one of {TIERS} or a per-node dict")
    if "auto" in tiers:
        raise ValueError("precision='auto' (the budget-gated autotuner) is "
                         "not yet ported; see ROADMAP.md")
    if o.lowering == "auto" or (isinstance(o.lowering, dict)
                                and "auto" in o.lowering.values()):
        raise ValueError("lowering='auto' (the autotuner) is not yet ported; "
                         "see ROADMAP.md")
    if o.block_configs is not None and not isinstance(o.block_configs, dict):
        raise ValueError(f"block_configs={o.block_configs!r} is not yet "
                         "ported (None or a {node: {param: int}} dict); "
                         "see ROADMAP.md")
    if not isinstance(o.fuse, bool):
        raise ValueError(f"fuse={o.fuse!r} is not yet ported (True or "
                         "False); see ROADMAP.md")
    if o.mesh is not None:
        raise ValueError("mesh= (multi-device plans) is not yet ported; "
                         "see ROADMAP.md")
    requested = (set(o.lowering.values()) if isinstance(o.lowering, dict)
                 else {o.lowering})
    bad = requested - set(LOWERINGS) - {"reference"}
    if bad:
        raise ValueError(f"unknown lowering(s) {sorted(bad)}; expected one "
                         f"of {LOWERINGS} (the reference's 'pallas' is "
                         "'kernel' here)")


def compile(graph: Graph, shapes, *, options: CompileOptions | None = None,
            **changes) -> Plan:
    """Compile ``graph`` for the given input shapes; memoized.

    Knobs ride a :class:`CompileOptions` (``options=``), or keyword
    arguments naming its fields, applied over ``options``::

        compile(g, {"x": (16, 4096)}, lowering="kernel")            # cuda
        compile(g, {"x": (4096,)}, lowering="kernel", device="cpu")

    ``lowering``: one name for every node or a {node: lowering} dict
    (post- or pre-fusion names; a fused node honors its members' request
    when they agree).  ``precision``: ``"f32"``, ``"bf16"``, ``"int8"``
    or a {node: tier} dict (module docstring).  ``block_configs``:
    {node: {param: int}} kernel block sizes, validated at the kernel
    boundary.  ``fuse``: collapse elementwise chains (default True).
    """
    o = options or CompileOptions()
    if changes:
        o = o.replace(**changes)
    _check_ported(o)
    device = resolve_device(o.device)
    lowering = o.lowering
    if lowering == "reference":
        lowering = "native"
    elif isinstance(lowering, dict):
        lowering = {n: ("native" if lw == "reference" else lw)
                    for n, lw in lowering.items()}
    precision = o.precision if o.precision is not None else "f32"
    specs = _norm_specs(graph, shapes, o.dtype)
    spec_key = tuple((n, specs[n][0], str(specs[n][1])) for n in graph.inputs)
    low_key = (tuple(sorted(lowering.items()))
               if isinstance(lowering, dict) else lowering)
    prec_key = (tuple(sorted(precision.items()))
                if isinstance(precision, dict) else precision)
    cfg_key = (tuple(sorted((n, tuple(sorted(c.items())))
                            for n, c in o.block_configs.items()))
               if o.block_configs else None)
    # the quantize engine is part of the key: an engine_override("ref")
    # compile must not collide with the default "int" plans
    key = (graph.signature, spec_key, str(device), low_key, prec_key,
           quantize.engine(), cfg_key, o.fuse)
    plan = _CACHE.get(key)
    if plan is not None:
        _HITS.add()
        return plan
    _MISSES.add()
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
                      mode=str(o.fuse)):
            # precision boundaries are fusion boundaries: a fused node
            # runs at ONE tier, so a run whose members ask for different
            # tiers stays unfused
            keep = (None if not isinstance(precision, dict) else
                    lambda run: len({req_prec(n.name) for n in run}) == 1)
            g = fuse_elementwise(graph, avals, keep=keep) if o.fuse else graph

        lowerings: dict[str, str] = {}
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

        compute = [n for n in g.topo() if n.op not in ("input", "const")]
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
                if req not in (None, "native") and not d.lowering_agnostic:
                    tag_downgrade(node.name, "lowering", req)
        for node in compute:
            # int8 with a quantized impl keeps the lowering when the qimpl
            # has it (q_lowerings: the int8 CUDA kernels); else it quietly
            # runs native, the torch integer path -- not a downgrade, the
            # integer path IS the tier.  An unsupported tier runs f32,
            # recorded, unless the op is pure data movement.
            rp = req_prec_node(node)
            d = OPS[node.op]
            if rp == "f32":
                precisions[node.name] = "f32"
            elif d.supports_precision(rp, d.bind(node.attr)):
                precisions[node.name] = rp
                if rp == "int8" and d.qimpl is not None \
                        and lowerings[node.name] not in d.q_lowerings:
                    lowerings[node.name] = "native"
            else:
                precisions[node.name] = "f32"
                if not d.lowering_agnostic:
                    tag_downgrade(node.name, "precision", rp)
        if downgrades:
            _DOWNGRADES.add(len(downgrades))
            _warn_downgrades(g, downgrades)

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

        plan = Plan(graph=g, input_names=tuple(g.inputs),
                    lowerings=lowerings, key=key, device=device,
                    input_specs=specs,
                    configs={n: dict(c)
                             for n, c in (o.block_configs or {}).items()},
                    downgrades=downgrades, consts=consts,
                    precisions=precisions, qconsts=qconsts)
        _CACHE[key] = plan
    return plan


__all__ = ["OPS", "LOWERINGS", "TIERS", "Plan", "CompileOptions", "apply_node",
           "compile", "infer", "fuse_elementwise", "run_to_steps",
           "cache_stats", "clear_cache"]
