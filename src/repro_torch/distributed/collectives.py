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

Each group's members, route and :class:`~repro_torch.launch.mesh.Group`
(``mesh.group``) are made once a mesh and axes.  A mesh that runs a part
of its positions (:class:`repro_torch.launch.mesh.RowMesh`, meta tensors
only) says in its groups which run member each member it does not run
mirrors.

Under :func:`recording`, every collective that a group of more than one
runs, forward and backward, is handed to the recorder after it ran
(:class:`Group`, its members' tensors in and out; the bf16 expert
combine records as an all-reduce of its bf16 tensors), and the ops that
carry it out run under the recorder's ``quiet()``: the dry-run counts
them as wire bytes, never as a card's FLOPs or memory traffic.  With no
recorder (the default) nothing is recorded and nothing else changes.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

from ..launch.mesh import Group

_LOCK = threading.Lock()
_RECORDER = None          # the active recorder (:func:`recording`), or None
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


@contextlib.contextmanager
def recording(recorder):
    """Every collective run inside goes to ``recorder``: its ``quiet()``
    context wraps the ops that carry a collective out, then
    ``recorder.record(kind, group, ins, outs)`` gets the kind
    (``"all-reduce"``, ``"all-gather"``, ``"reduce-scatter"``), the
    :class:`Group` and its members' tensors (every member, in rank
    order)."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, recorder
    try:
        yield recorder
    finally:
        _RECORDER = prev


@contextlib.contextmanager
def glue():
    """Cross-position host glue (a step's global result gathered on its
    first device): under a recorder, inside its ``quiet()``, and
    recorded as nothing."""
    rec = _RECORDER
    if rec is None:
        yield
        return
    with rec.quiet():
        yield


def _exec(kind: str, grp: Group, fn, ts: list) -> list:
    """``fn`` over a group's members' tensors (every member), handed to
    the recorder where one is active."""
    rec = _RECORDER
    if rec is None:
        return fn(ts)
    with rec.quiet():
        outs = fn(ts)
    rec.record(kind, grp, ts, outs)
    return outs


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
        # on meta (the dry-run) each member's slice gets storage of its
        # own, as on a card of its own; one device shares the sum's
        return [c.clone(memory_format=torch.contiguous_format) if c.is_meta
                else c.contiguous() for c in s.chunk(n, dim)]
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


def _run(kind: str, grp: Group, fn, ts) -> list:
    """``fn`` over the group's members (the run members' tensors
    ``ts``, expanded), the run members' results kept."""
    return grp.keep(_exec(kind, grp, fn, grp.expand(list(ts))))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, grp, *xs):
        ctx.rt, ctx.grp = rt, grp
        outs = _run("all-reduce", grp, lambda ts: _reduce(ts, rt), xs)
        ctx.metas = _metas(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_run("all-reduce", ctx.grp,
                                  lambda ts: _reduce(ts, ctx.rt),
                                  _filled(gs, ctx.metas)))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, grp, dim, grad_dtype, *xs):
        ctx.rt, ctx.grp, ctx.dim, ctx.grad_dtype = rt, grp, dim, grad_dtype
        ctx.in_dtype = xs[0].dtype
        outs = _run("all-gather", grp, lambda ts: _gather(ts, rt, dim), xs)
        ctx.metas = _metas(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        gs = _filled(gs, ctx.metas)
        if ctx.grad_dtype is not None:
            gs = [g.to(ctx.grad_dtype) for g in gs]
        out = _run("reduce-scatter", ctx.grp,
                   lambda ts: _scatter(ts, ctx.rt, ctx.dim), gs)
        return (None, None, None, None, *[g.to(ctx.in_dtype) for g in out])


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, grp, dim, *xs):
        ctx.rt, ctx.grp, ctx.dim = rt, grp, dim
        outs = _run("reduce-scatter", grp, lambda ts: _scatter(ts, rt, dim),
                    xs)
        ctx.metas = _metas(outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_run(
            "all-gather", ctx.grp, lambda ts: _gather(ts, ctx.rt, ctx.dim),
            _filled(gs, ctx.metas)))


def _per_group(xs: list, mesh, axes, fn) -> list:
    """``fn(run members' tensors, route, group)`` over each group of
    ``axes``, the results put back at their positions; a group of one is
    left as it is."""
    if len(xs) != mesh.size:
        raise ValueError(f"collectives: {len(xs)} shards on a mesh of "
                         f"{mesh.size}")
    names = _names(axes)
    out = list(xs)
    if mesh.count(names) == 1:
        return out
    for g, rt, grp in _plan(mesh, names):
        for i, t in zip(g, fn([xs[i] for i in g], rt, grp)):
            out[i] = t
    return out


@functools.lru_cache(maxsize=64)
def _plan(mesh, names: tuple) -> tuple:
    """Each group of ``names`` on ``mesh``: its run members, route and
    :class:`Group` (``mesh.group``), made once a mesh and axes."""
    return tuple((g, route([mesh.devices[i] for i in g]),
                  mesh.group(tuple(g), names))
                 for g in mesh.groups(names))


def _names(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_reduce(xs: list, mesh, axes) -> list:
    """The sum over ``axes``, on every member (differentiable)."""
    return _per_group(xs, mesh, axes,
                      lambda ts, rt, grp: _AllReduce.apply(rt, grp, *ts))


def all_reduce_max(xs: list, mesh, axes) -> list:
    """The elementwise max over ``axes``, on every member; no gradient
    (a softmax's shift)."""
    return _per_group([x.detach() for x in xs], mesh, axes,
                      lambda ts, rt, grp: _run(
                          "all-reduce", grp,
                          lambda us: _reduce(us, rt, "max"), ts))


def all_gather(xs: list, mesh, axes, dim: int, *, grad_dtype=None) -> list:
    """The members' tensors concatenated along ``dim`` in rank order, on
    every member (differentiable: the backward reduce-scatters, in
    ``grad_dtype`` where given)."""
    return _per_group(xs, mesh, axes,
                      lambda ts, rt, grp: _AllGather.apply(
                          rt, grp, dim, grad_dtype, *ts))


def reduce_scatter(xs: list, mesh, axes, dim: int) -> list:
    """Member r's slice r (of n along ``dim``) of the sum over ``axes``
    (differentiable: the backward all-gathers)."""
    return _per_group(xs, mesh, axes,
                      lambda ts, rt, grp: _ReduceScatter.apply(rt, grp, dim,
                                                               *ts))


class _ExpertCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rt, grp, *xs):
        ctx.rt, ctx.grp, ctx.dtype = rt, grp, xs[0].dtype
        outs = _run("all-reduce", grp, lambda ts: _reduce(ts, rt),
                    [x.to(torch.bfloat16) for x in xs])
        ctx.metas = _metas(outs)
        return tuple(o.to(ctx.dtype) for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        gs = _run("all-reduce", ctx.grp, lambda ts: _reduce(ts, ctx.rt),
                  _filled(gs, [(s, ctx.dtype, d) for s, _, d in ctx.metas]))
        return (None, None, *[g.to(torch.bfloat16).to(ctx.dtype)
                              for g in gs])


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
                      lambda ts, rt, grp: _ExpertCombine.apply(rt, grp, *ts))


__all__ = ["route", "mesh_routes", "all_reduce", "all_reduce_max",
           "all_gather", "reduce_scatter", "expert_combine", "recording",
           "glue", "Group"]
