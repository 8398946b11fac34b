"""Collectives over the axes of a :class:`repro_torch.launch.mesh.Mesh`,
driven from one process: a sharded value is a list with one tensor a mesh
position, on that position's device.

Each collective works group by group: the positions that share every
index off the named axes (``mesh.groups(axes)``), in rank order over
them.  A group takes one of two routes, fixed by its devices:

* ``"sum"`` -- every member on one device (logical shards of the CPU or
  of one card): the sum written out in rank order, ``x0 + x1 + ...``, in
  the tensors' dtype; a gather is a ``cat``;
* ``"nccl"`` -- every member on a card of its own: NCCL's single-process
  multi-device collectives (``torch.cuda.nccl``), on each card's current
  stream, one host call at a time (a lock: autograd's per-device threads
  run backward collectives too, and a communicator takes its calls in
  one order).

A group that mixes the two (some card twice, another once) raises, and a
failing NCCL call raises: no collective changes route.

The differentiable ones are ``torch.autograd.Function``s whose backward
is the forward's adjoint: an all-reduce's is an all-reduce, an
all-gather's a reduce-scatter (in ``grad_dtype`` where given: the bf16
gradient wire), a reduce-scatter's an all-gather.  A step that takes its
loss from one copy of a replicated value therefore gets, on each copy
of a replicated parameter, a part of its gradient; the parts sum, over
the axes the parameter is replicated on, to the gradient
(:func:`repro_torch.distributed.step`).
"""
from __future__ import annotations

import threading

import torch

_LOCK = threading.Lock()
_NCCL_OPS = {"sum": 0, "max": 2}     # torch.cuda.nccl.SUM, .MAX


def route(devices) -> str:
    """A group's route: ``"sum"`` for one device, ``"nccl"`` for distinct
    cards; ValueError for anything else."""
    devs = [torch.device(d) for d in devices]
    distinct = set(devs)
    if len(distinct) == 1:
        return "sum"
    if len(distinct) == len(devs) and all(d.type == "cuda" for d in devs):
        return "nccl"
    raise ValueError(f"collectives: a group over {[str(d) for d in devs]} "
                     "mixes repeated and distinct devices; a mesh is "
                     "logical shards of one device or one card a position")


def mesh_routes(mesh, axes) -> set:
    """The routes of ``axes``' groups on ``mesh`` (a size-1 axis has
    none)."""
    return {route([mesh.devices[i] for i in g])
            for g in mesh.groups(axes) if len(g) > 1}


def _nccl(fn: str, inputs: list, outputs=None, op: str = "sum") -> None:
    from torch.cuda import nccl
    if not nccl.is_available(inputs):
        raise RuntimeError(f"collectives: NCCL cannot take tensors on "
                           f"{[str(t.device) for t in inputs]}")
    with _LOCK:
        if fn == "all_reduce":
            nccl.all_reduce(inputs, op=_NCCL_OPS[op])
        elif fn == "all_gather":
            nccl.all_gather(inputs, outputs)
        else:
            nccl.reduce_scatter(inputs, outputs, op=_NCCL_OPS[op])


def _reduce(xs: list, rt: str, op: str = "sum") -> list:
    """All-reduce of one group: a fresh tensor a member."""
    if rt == "sum":
        s = xs[0]
        for x in xs[1:]:
            s = s + x if op == "sum" else torch.maximum(s, x)
        return [s] + [s.clone() for _ in xs[1:]]
    bufs = [x.contiguous().clone() for x in xs]
    _nccl("all_reduce", bufs, op=op)
    return bufs


def _gather(xs: list, rt: str, dim: int) -> list:
    """All-gather of one group along ``dim``."""
    if rt == "sum":
        g = torch.cat(xs, dim)
        return [g] + [g.clone() for _ in xs[1:]]
    ins = [x.movedim(dim, 0).contiguous() for x in xs]
    outs = [torch.empty((len(xs) * t.shape[0],) + tuple(t.shape[1:]),
                        dtype=t.dtype, device=t.device) for t in ins]
    _nccl("all_gather", ins, outs)
    return [o.movedim(0, dim).contiguous() for o in outs]


def _scatter(xs: list, rt: str, dim: int) -> list:
    """Reduce-scatter of one group along ``dim``: member r keeps the r-th
    of n equal slices of the sum."""
    n = len(xs)
    if xs[0].shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(xs[0].shape)}"
                         f" does not split {n} ways")
    if rt == "sum":
        s = xs[0]
        for x in xs[1:]:
            s = s + x
        return [c.contiguous() for c in s.chunk(n, dim)]
    ins = [x.movedim(dim, 0).contiguous() for x in xs]
    outs = [torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                        dtype=t.dtype, device=t.device) for t in ins]
    _nccl("reduce_scatter", ins, outs)
    return [o.movedim(0, dim).contiguous() for o in outs]


def _filled(gs, metas) -> list:
    """Backward inputs with zeros where autograd passes None."""
    return [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
            for g, (shape, dt, dev) in zip(gs, metas)]


def _metas(ts) -> list:
    return [(t.shape, t.dtype, t.device) for t in ts]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, *xs):
        ctx.rt = rt
        outs = _reduce(list(xs), rt)
        ctx.metas = _metas(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_reduce(_filled(gs, ctx.metas), ctx.rt))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, dim, grad_dtype, *xs):
        ctx.rt, ctx.dim, ctx.grad_dtype = rt, dim, grad_dtype
        ctx.in_dtype = xs[0].dtype
        outs = _gather(list(xs), rt, dim)
        ctx.metas = _metas(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        gs = _filled(gs, ctx.metas)
        if ctx.grad_dtype is not None:
            gs = [g.to(ctx.grad_dtype) for g in gs]
        out = _scatter(gs, ctx.rt, ctx.dim)
        return (None, None, None, *[g.to(ctx.in_dtype) for g in out])


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, dim, *xs):
        ctx.rt, ctx.dim = rt, dim
        outs = _scatter(list(xs), rt, dim)
        ctx.metas = _metas(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_gather(_filled(gs, ctx.metas), ctx.rt,
                                     ctx.dim))


def _per_group(xs: list, mesh, axes, fn) -> list:
    """``fn(members' tensors, route)`` over each group of ``axes``, the
    results put back at their positions; a group of one is left as it
    is."""
    if len(xs) != mesh.size:
        raise ValueError(f"collectives: {len(xs)} shards on a mesh of "
                         f"{mesh.size}")
    out = list(xs)
    for g in mesh.groups(axes):
        if len(g) == 1:
            continue
        rt = route([mesh.devices[i] for i in g])
        for i, t in zip(g, fn([xs[i] for i in g], rt)):
            out[i] = t
    return out


def all_reduce(xs: list, mesh, axes) -> list:
    """The sum over ``axes``, on every member (differentiable)."""
    return _per_group(xs, mesh, axes, lambda ts, rt: _AllReduce.apply(rt, *ts))


def all_reduce_max(xs: list, mesh, axes) -> list:
    """The elementwise max over ``axes``, on every member; no gradient
    (a softmax's shift)."""
    return _per_group([x.detach() for x in xs], mesh, axes,
                      lambda ts, rt: _reduce(ts, rt, "max"))


def all_gather(xs: list, mesh, axes, dim: int, *, grad_dtype=None) -> list:
    """The members' tensors concatenated along ``dim`` in rank order, on
    every member (differentiable: the backward reduce-scatters, in
    ``grad_dtype`` where given)."""
    return _per_group(xs, mesh, axes,
                      lambda ts, rt: _AllGather.apply(rt, dim, grad_dtype,
                                                      *ts))


def reduce_scatter(xs: list, mesh, axes, dim: int) -> list:
    """Member r's slice r (of n along ``dim``) of the sum over ``axes``
    (differentiable: the backward all-gathers)."""
    return _per_group(xs, mesh, axes,
                      lambda ts, rt: _ReduceScatter.apply(rt, dim, *ts))


class _ExpertCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, *xs):
        ctx.rt, ctx.dtype = rt, xs[0].dtype
        outs = _reduce([x.to(torch.bfloat16) for x in xs], rt)
        ctx.metas = _metas(outs)
        return tuple(o.to(ctx.dtype) for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        gs = _reduce(_filled(gs, [(s, ctx.dtype, d)
                                  for s, _, d in ctx.metas]), ctx.rt)
        return (None, *[g.to(torch.bfloat16).to(ctx.dtype) for g in gs])


def expert_combine(xs: list, mesh, axes) -> list:
    """The expert-parallel combine: each member's partial output rounded
    to bf16 and summed over ``axes`` in bf16, cast back (the reference's
    ``psum(y.astype(bfloat16), "model")``).  Its backward rounds the
    summed cotangent to bf16 once, as the reference's transpose of that
    psum does to the replicated cotangent: the parts a step's loss gives
    each copy are summed in their own dtype first."""
    if mesh.count(axes) == 1:
        return [x.to(torch.bfloat16).to(x.dtype) for x in xs]
    return _per_group(xs, mesh, axes,
                      lambda ts, rt: _ExpertCombine.apply(rt, *ts))


__all__ = ["route", "mesh_routes", "all_reduce", "all_reduce_max",
           "all_gather", "reduce_scatter", "expert_combine"]
