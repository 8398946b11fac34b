"""Dry-run on one card, the port of the reference's
``repro.launch.dryrun``: every (architecture x input shape) cell's step
built at the cell's global batch and length and run once on the
``meta`` device (shapes and dtypes, no data, nothing allocated), its
FLOPs, bytes and memory counted, and the roofline terms
(:mod:`repro_torch.analysis.roofline`, the H100's) taken from them.

Per cell:
    step, operands = build_step(cfg, cell)        # meta tensors
    with FlopCounterMode(), op byte counter, MemTracker:
        step(*operands)                           # nothing allocated
    -> flops, bytes, memory -> roofline row

What each of the reference's XLA-derived fields holds here:

* ``hlo_gflops_per_chip``: ``torch.utils.flop_counter``'s count (the
  matmuls, batched matmuls and convolutions, in the forward, the
  backward and remat's recompute: torch's checkpoint stops each
  recompute at the last tensor the backward needs, so a superblock's
  final down projection is not run again);
* ``hlo_gbytes_per_chip``: the bytes of every operand and result of
  every op the step dispatches, views excepted: what eager torch reads
  and writes, unfused (XLA's CPU-backend 'bytes accessed' counts the
  same way);
* ``memory``: ``argument_size_in_bytes`` the operands' bytes,
  ``unread_argument_size_in_bytes`` those of the operands no op of the
  step reads (serving's f32 masters beside ``prepare``'s copies: held,
  not moved, so the roofline's memory term leaves them out),
  ``output_size_in_bytes`` the results that share no storage with an
  operand, ``alias_size_in_bytes`` those that do (the train step
  updates parameters and optimizer state in place; serving writes its
  caches in place), ``temp_size_in_bytes`` the peak that
  ``torch.distributed._tools.mem_tracker.MemTracker`` tracks on the meta
  tensors, less the operands and the fresh results.

Counts come from 1- and 2-superblock probes, as the reference's do: the
step at ``len(pattern) + len(tail)`` and ``2 * len(pattern) +
len(tail)`` layers, every count extrapolated as ``c1 + (reps - 1) *
(c2 - c1)``.  Eager torch needs no probe to see every layer, but the
probes hold the attention chunks to two superblocks' worth of
dispatched ops at 32k tokens.  rwkv6's WKV scan is one op
(``repro_torch::wkv6``, :mod:`repro_torch.kernels.wkv`), as the
reference's is one ``lax.scan``: one dispatch a layer, whatever the
length, at FLOPs registered with the flop counter (those the plain
loop's einsums count), its bytes its operands' and results'.  The
FLOPs, op bytes, operands and results are linear in the repeats, so the
probed counts equal the full step's (``tests/test_torch_dryrun.py``);
the peak is not (the phase that holds it moves with depth), so a probed
``temp_size_in_bytes`` is an estimate (a train step's lies below the
whole step's).
``run_cell(..., scan_correct=False)`` runs the whole step instead.

The step runs at the ``native`` lowering: a hand-written kernel cannot
run on a meta tensor.  Serving's operands are ``model.prepare``'s, as
the port serves (``launch/serve.py``): the native lowering then reads
each linear's compute-dtype K-major copy, as the bf16 kernel does, so
the FLOPs and the bytes read are the kernel lowering's.

Meshes: ``h100x1`` (the default) is one card, the one-device steps, no
collective.  ``--mesh single|multi|both`` are the reference's production
meshes, ``pod16x16`` (data 16, model 16) and ``pod2x16x16`` (pod 2, data
16, model 16); ``--dp/--tp`` reshape them as the reference does (a
(dp, tp) mesh, (2, dp, tp) for ``multi``, under the same names).  A pod
cell runs the port's sharded step (:mod:`repro_torch.distributed.step`,
``--layout tp|fsdp|sp``) on a ``meta`` mesh of the cell's shape, its
operands each position's blocks, and counts per card (:class:`_Cards`):
every op charged to the position whose work it is (the one
:func:`repro_torch.models.sharded.position` names, else the one whose
tensors it reads; an op that reads several positions' is cross-card
glue and no card's), every collective recorded as it runs
(:func:`repro_torch.distributed.collectives.recording`) and costed as
wire bytes by :func:`repro_torch.analysis.roofline.add_collective`, the
ops that carry it out counted as no card's FLOPs or memory traffic.  A
row reports the largest position's FLOPs, op bytes, memory and wire
bytes: uneven head ranges (qwen2's 28 heads on 16 ranks) make the
positions differ, and the slowest card bounds the step.  The cell runs
one data row of the mesh (:class:`repro_torch.launch.mesh.RowMesh`):
the positions off it hold blocks of the same shapes and do the same
work but for the first data row's part of the loss and the clip (the
row runs it), so their counts are the row's
(``tests/test_torch_dryrun_mesh.py`` holds the row against the whole
mesh).

Usage:
    python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen2_7b --shape decode_32k \
        --mesh both
    python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.analysis.summarize experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.analysis import roofline as roofline_lib
from repro_torch.configs import ARCHS, get
from repro_torch.data.pipeline import input_specs
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import step as step_lib
from repro_torch.launch import shapes as shapes_lib
from repro_torch.launch.mesh import RowMesh, make_mesh
from repro_torch.models import convert, sharded
from repro_torch.models import model as model_lib
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.partitioning import PartitionSpec
from repro_torch.tree import flatten_with_path, leaves, unflatten

# the one card, and the reference's production meshes: (shape, axes)
MESHES = {"h100x1": None,
          "pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MESH_FLAGS = {"h100x1": ["h100x1"], "single": ["pod16x16"],
              "multi": ["pod2x16x16"], "both": ["pod16x16", "pod2x16x16"]}
META = torch.device("meta")


def count_params(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from ``init_model``'s tree in the
    training layout, built on fake tensors (nothing allocated); a leaf is
    an expert's when its path names ``w_up``, ``w_gate`` or ``w_down``,
    as in the reference."""
    total = expert = 0
    for key, leaf in flatten_with_path(step_lib.param_specs(cfg)):
        n = leaf.numel()
        total += n
        if any(w in key for w in ("w_up", "w_gate", "w_down")):
            expert += n
    if cfg.moe and cfg.n_experts:
        active = total - expert + expert * cfg.n_experts_per_token / cfg.n_experts
    else:
        active = total
    return float(total), float(active)


def build_step(cfg, cell, *, microbatch=None):
    """(step, operands) for ``cell``'s kind, the counterpart of the
    reference's ``build_lowered``: the port's train, prefill or decode
    step at the cell's global batch and length, at the ``native``
    lowering, and its operands as ``meta`` tensors (the train step's in
    the training layout; serving's ``prepare``d, with caches of the
    cell's length)."""
    cfg = cfg.scaled(tina_lowering="native")
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        fn, specs = step_lib.make_train_step(
            cfg, batch_size=b, seq_len=s, microbatch=microbatch, device=META)
        return fn, (specs.params, specs.opt_state, specs.batch)
    params = model_lib.prepare(
        convert.unstack_views(step_lib.param_specs(cfg)), cfg)
    caches = model_lib.init_caches(cfg, b, s, device=META)
    if cell.kind == "prefill":
        fn = step_lib.make_prefill_step(cfg, batch_size=b, seq_len=s)
        return fn, (params, input_specs(cfg, b, s), caches)
    if cell.kind == "decode":
        fn = step_lib.make_decode_step(cfg, batch_size=b, cache_len=s)
        tokens = torch.empty((b,), dtype=torch.int32, device=META)
        return fn, (params, tokens, caches)
    raise ValueError(cell.kind)


class _OpBytes(TorchDispatchMode):
    """Sums the bytes of every operand and result of every op dispatched
    under it, views excepted (they move no data), and keeps the storages
    those ops take as operands (``read``)."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        _check_deadline()
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.read.update(t.untyped_storage()._cdata for t in ins)
            self.total += sum(t.nbytes for t in ins) + sum(
                t.nbytes for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))
        return out


def _storages(tree) -> dict:
    """Each tensor's storage once, by identity (a meta storage has no
    address): {id: bytes}."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in leaves(tree) if isinstance(t, torch.Tensor)}


def _cell_metrics(cfg, cell, *, microbatch=None) -> dict:
    """One run of the cell's step on meta tensors: ``flops``, ``bytes``
    (the op byte count), the ``memory`` fields and ``seconds``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.perf_counter()
    fn, operands = build_step(cfg, cell, microbatch=microbatch)
    args = _storages(operands)
    arg_bytes = sum(args.values())
    flops = FlopCounterMode(display=False)
    nbytes = _OpBytes()
    mem = MemTracker()
    mem.track_external(*[t for t in leaves(operands)
                         if isinstance(t, torch.Tensor)])
    grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
    with grad, mem, flops, nbytes:
        out = fn(*operands)
    peak = mem.get_tracker_snapshot("peak")[META]["Total"]
    outs = _storages(out)
    out_bytes = sum(n for k, n in outs.items() if k not in args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.total),
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "unread_argument_size_in_bytes": sum(
                           n for k, n in args.items()
                           if k not in nbytes.read),
                       "output_size_in_bytes": out_bytes,
                       "alias_size_in_bytes": sum(n for k, n in outs.items()
                                                  if k in args),
                       "temp_size_in_bytes": max(0, int(peak) - arg_bytes
                                                 - out_bytes)},
            "seconds": time.perf_counter() - t0}


def _extrapolate(m1: dict, m2: dict, k: int) -> dict:
    """``m1`` plus ``k`` times each count's growth from ``m1`` to ``m2``
    (one superblock's), floored at 0 as the reference floors it."""
    def ext(a, b):
        return a + k * max(0, b - a)
    return {"flops": ext(m1["flops"], m2["flops"]),
            "bytes": ext(m1["bytes"], m2["bytes"]),
            "memory": {key: ext(v, m2["memory"][key])
                       for key, v in m1["memory"].items()},
            "seconds": m1["seconds"] + m2["seconds"]}


def cell_counts(cfg, cell, *, microbatch=None,
                scan_correct: bool = True) -> dict:
    """The cell's counts at ``cfg``'s full depth: from the 1- and
    2-superblock probes (``scan_correct`` and more than one repeat), or
    from one run of the whole step."""
    pat, reps, tail = model_lib._pattern_layout(cfg)
    if not (scan_correct and reps > 1):
        return _cell_metrics(cfg, cell, microbatch=microbatch)
    probes = [_cell_metrics(cfg.scaled(n_layers=n * len(pat) + len(tail),
                                       remat_group=1), cell,
                            microbatch=microbatch) for n in (1, 2)]
    return _extrapolate(*probes, reps - 1)


# ---------------------------------------------------------------------------
# pod meshes: the sharded steps, counted per card
# ---------------------------------------------------------------------------
def _block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A fresh meta tensor of one position's block of ``t`` under
    ``spec`` (equal blocks: every position's is this shape)."""
    shape = list(t.shape)
    for d, e in enumerate(tuple(spec)):
        if e is not None:
            shape[d] //= mesh.count(e)
    return torch.empty(shape, dtype=t.dtype, device=META)


def _blocks(tree, specs, mesh) -> list:
    """One tree of fresh meta blocks a position."""
    flat = [sp for _, sp in flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]
    ts = leaves(tree)
    return [unflatten(tree, [_block(t, sp, mesh) for t, sp in zip(ts, flat)])
            for _ in range(mesh.size)]


def build_sharded_step(cfg, cell, mesh, *, layout: str = "tp",
                       microbatch=None):
    """(step, operands, per-position operand trees, data shards) for
    ``cell`` on ``mesh`` (a meta :class:`Mesh` or :class:`RowMesh`): the
    port's sharded train, prefill or decode step at the ``native``
    lowering, each position's operands fresh meta blocks (serving's
    ``prepare``d, its caches :func:`step.init_sharded_caches`'), the
    batch global."""
    cfg = cfg.scaled(tina_lowering="native")
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        fn, specs = step_lib.make_sharded_train_step(
            cfg, mesh, batch_size=b, seq_len=s, microbatch=microbatch,
            layout=layout)
        ps = _blocks(specs.params, specs.params_sh, mesh)
        opt = make_optimizer(cfg, warmup_cosine(3e-4, 2000, 100_000))
        st = [opt.init(p) for p in ps]
        return (fn, (ps, st, specs.batch), [list(x) for x in zip(ps, st)],
                mesh.count(specs.layout.dp))
    pre, dec = step_lib.make_sharded_serving_steps(
        cfg, mesh, batch_size=b, seq_len=s, layout=layout)
    specs = dec.specs
    ps = [model_lib.prepare(p, cfg)
          for p in _blocks(specs.params, specs.params_sh, mesh)]
    caches = step_lib.init_sharded_caches(specs, b, s)
    rows = mesh.count(specs.layout.dp)
    if cell.kind == "prefill":
        return (pre, (ps, input_specs(cfg, b, s), caches),
                [list(x) for x in zip(ps, caches)], rows)
    if cell.kind == "decode":
        tokens = torch.empty((b,), dtype=torch.int32, device=META)
        return dec, (ps, tokens, caches), [list(x) for x in zip(ps, caches)], \
            rows
    raise ValueError(cell.kind)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Cards(TorchDispatchMode):
    """Per-position counts of a sharded step run on meta tensors, and the
    recorder of its collectives (:func:`collectives.recording`).

    An op is the work of the position :func:`sharded.position` names, or
    else of the one position whose storages it reads (an op reading
    several positions' is cross-card glue, no card's); its results'
    fresh storages become that position's.  Per position: the op bytes
    (every operand and result, views excepted, as :class:`_OpBytes`),
    the live bytes of its fresh storages and their peak.  Inside
    ``quiet()`` (a collective's own ops, cross-card glue) nothing is
    counted; a collective's results become its members' as
    :meth:`record` hands them out, with each member's wire bytes."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        n = mesh.size
        self.flops, self.bytes = [0] * n, [0] * n
        self.live, self.peak = [0] * n, [0] * n
        self.coll = [roofline_lib.CollectiveStats() for _ in range(n)]
        self.owner: dict = {}
        self.read: set = set()
        self.depth = 0             # inside quiet()
        self.op_at = None          # the position of the op running

    @contextlib.contextmanager
    def quiet(self):
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def seed(self, i: int, tree) -> None:
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self.owner[_key(t)] = i

    def _free(self, key: int, i: int, n: int) -> None:
        self.live[i] -= n
        self.owner.pop(key, None)

    def _track(self, t: torch.Tensor, i) -> None:
        if i is None:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.owner:
            return
        self.owner[key] = i
        n = st.nbytes()
        self.live[i] += n
        self.peak[i] = max(self.peak[i], self.live[i])
        weakref.finalize(st, self._free, key, i, n)

    def _position(self, ins: list):
        i = sharded.position()
        if i is not None:
            return i
        owners = {self.owner.get(_key(t)) for t in ins} - {None}
        return owners.pop() if len(owners) == 1 else None

    def record(self, kind: str, grp, ins: list, outs: list) -> None:
        crosses = roofline_lib.crosses_node(grp.positions)
        for j, i in enumerate(grp.members):
            k = grp.kept[j]
            roofline_lib.add_collective(self.coll[i], kind, grp.size,
                                        ins[k].nbytes, outs[k].nbytes,
                                        crosses)
            self._track(outs[k], i)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        _check_deadline()
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if self.depth:
            out = func(*args, **kwargs)
            if not func.is_view:
                self.read.update(_key(t) for t in ins)
            return out
        i = self._position(ins)
        prev, self.op_at = self.op_at, i
        try:
            out = func(*args, **kwargs)
        finally:
            self.op_at = prev
        if func.is_view:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.read.update(_key(t) for t in ins)
        for t in outs:
            self._track(t, i)
        if i is not None:
            self.bytes[i] += sum(t.nbytes for t in ins) + sum(
                t.nbytes for t in outs)
        return out


class _Flops(TorchDispatchMode):
    """``FlopCounterMode``'s count, charged to :attr:`_Cards.op_at` (the
    same formulas and decompositions, entered outside a :class:`_Cards`
    so that it sees each op after it)."""

    def __init__(self, cards: _Cards):
        super().__init__()
        self.cards = cards

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        i = self.cards.op_at
        if i is not None and func._overloadpacket in flop_registry:
            self.cards.flops[i] += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        return out


def _mesh_metrics(cfg, cell, mesh, *, layout="tp", microbatch=None
                  ) -> dict:
    """One run of the cell's sharded step on ``mesh``: per run position
    ``flops``, ``bytes``, ``memory`` and ``coll`` (its
    :class:`CollectiveStats`), and ``seconds``."""
    t0 = time.perf_counter()
    fn, operands, own, rows = build_sharded_step(cfg, cell, mesh,
                                                 layout=layout,
                                                 microbatch=microbatch)
    cards = _Cards(mesh)
    args = []
    for i, tree in enumerate(own):
        cards.seed(i, tree)
        args.append(_storages(tree))
    shared = {k: n for k, n in _storages(operands).items()
              if not any(k in a for a in args)}
    batch = sum(shared.values()) // rows
    grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
    gc.collect()
    gc.disable()              # frees at their last reference only: a
    try:                      # collection's timing would move the peaks
        with grad, coll.recording(cards), _Flops(cards), cards:
            out = fn(*operands)
    finally:
        gc.enable()
    outs = _storages(out)
    per = []
    for i, a in enumerate(args):
        mine = {k: n for k, n in outs.items() if cards.owner.get(k) == i}
        fresh = sum(n for k, n in mine.items() if k not in a)
        per.append({
            "flops": float(cards.flops[i]), "bytes": float(cards.bytes[i]),
            "memory": {"argument_size_in_bytes": sum(a.values()) + batch,
                       "unread_argument_size_in_bytes": sum(
                           n for k, n in a.items() if k not in cards.read),
                       "output_size_in_bytes": fresh,
                       "alias_size_in_bytes": sum(n for k, n in mine.items()
                                                  if k in a),
                       "temp_size_in_bytes": max(0, cards.peak[i] - fresh)},
            "coll": cards.coll[i]})
    return {"positions": per, "seconds": time.perf_counter() - t0}


def _ext_coll(s1, s2, k: int) -> roofline_lib.CollectiveStats:
    def ext(a, b):
        return a + k * max(0.0, b - a)
    return roofline_lib.CollectiveStats(
        op_bytes={op: ext(s1.op_bytes.get(op, 0.0), s2.op_bytes.get(op, 0.0))
                  for op in set(s1.op_bytes) | set(s2.op_bytes)},
        wire_ici=ext(s1.wire_ici, s2.wire_ici),
        wire_dcn=ext(s1.wire_dcn, s2.wire_dcn),
        count=int(ext(s1.count, s2.count)))


def mesh_counts(cfg, cell, mesh, *, layout="tp", microbatch=None,
                scan_correct: bool = True) -> dict:
    """:func:`cell_counts` on a pod mesh: each run position's counts at
    ``cfg``'s full depth (its collectives' too), from the 1- and
    2-superblock probes or one run of the whole step."""
    pat, reps, tail = model_lib._pattern_layout(cfg)
    if not (scan_correct and reps > 1):
        return _mesh_metrics(cfg, cell, mesh, layout=layout,
                             microbatch=microbatch)
    m1, m2 = (_mesh_metrics(cfg.scaled(n_layers=n * len(pat) + len(tail),
                                       remat_group=1), cell, mesh,
                            layout=layout, microbatch=microbatch)
              for n in (1, 2))
    per = []
    for a, b in zip(m1["positions"], m2["positions"]):
        e = _extrapolate({**a, "seconds": 0.0}, {**b, "seconds": 0.0},
                         reps - 1)
        e["coll"] = _ext_coll(a["coll"], b["coll"], reps - 1)
        per.append(e)
    return {"positions": per, "seconds": m1["seconds"] + m2["seconds"]}


def largest(per: list) -> dict:
    """A card's counts from the positions': the largest FLOPs, op bytes,
    collective time, and the memory of the position that holds the
    most (the slowest, fullest card bounds the step)."""
    hw = roofline_lib.HW

    def t_coll(c):
        return c.wire_ici / hw.ici_bw + c.wire_dcn / hw.dcn_bw

    def held(m):
        return sum(m[k] for k in ("argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"))
    return {"flops": max(p["flops"] for p in per),
            "bytes": max(p["bytes"] for p in per),
            "memory": max((p["memory"] for p in per), key=held),
            "coll": max((p["coll"] for p in per), key=t_coll)}


def run_cell(arch: str, shape_name, *, mesh: str = "h100x1",
             mesh_shape=None, layout: str = "tp", moe_dispatch: str = None,
             scan_correct: bool = True, microbatch: int = None,
             cfg_overrides: dict = None) -> dict:
    """One cell's row, with the reference's keys: the roofline terms on
    an H100 (a card's share of a pod mesh's step), the parameter counts,
    ``memory`` and ``hbm_ok`` (the operands, the fresh results and the
    peak's temporaries within the card's 80 GB); ``t_compile_s`` is the
    seconds the counted runs took (the probes' own also as
    ``t_probe_s``).  ``shape_name`` names a cell of ``shapes.SHAPES`` or
    is a ``shapes.ShapeCell`` itself.  ``mesh``: ``h100x1`` or a pod
    mesh of :data:`MESHES`, ``mesh_shape`` in place of its shape (the
    reference's ``--dp/--tp``), ``layout`` its partitioning; a pod
    mesh's cell runs one data row of it (:class:`RowMesh`)."""
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: one of {sorted(MESHES)}")
    one = MESHES[mesh] is None
    if one and (layout != "tp" or mesh_shape):
        raise ValueError(f"mesh {mesh!r}: one card places nothing; a "
                         "layout or a (dp, tp) shape needs a pod mesh")
    cfg = get(arch)
    if moe_dispatch:
        cfg = cfg.scaled(moe_dispatch=moe_dispatch)
    if cfg_overrides:
        cfg = cfg.scaled(**cfg_overrides)
    cell = shape_name if isinstance(shape_name, shapes_lib.ShapeCell) \
        else shapes_lib.SHAPES[shape_name]
    skip = shapes_lib.skip_reason(cfg, cell)
    base = {"arch": arch, "shape": cell.name, "mesh": mesh,
            "kind": cell.kind, "status": "skip", "skip_reason": skip}
    if skip:
        return base
    if one:
        chips, stats = 1, roofline_lib.CollectiveStats()
        base["mesh_shape"] = {"card": 1}
        c = cell_counts(cfg, cell, microbatch=microbatch,
                        scan_correct=scan_correct)
    else:
        shape, axes = MESHES[mesh]
        if mesh_shape:
            shape = tuple(mesh_shape)
            axes = axes[-len(shape):]
        full = make_mesh(shape, axes, META)
        chips = full.size
        base["mesh_shape"] = dict(full.shape)
        m = mesh_counts(cfg, cell, RowMesh(full),
                        layout=layout, microbatch=microbatch,
                        scan_correct=scan_correct)
        c = {**largest(m["positions"]), "seconds": m["seconds"]}
        stats = c["coll"]
    probed = scan_correct and model_lib._pattern_layout(cfg)[1] > 1
    memory = c["memory"]
    n_params, n_active = count_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    rep = roofline_lib.RooflineReport(
        arch=arch, shape=cell.name, mesh=mesh, chips=chips,
        hlo_flops=c["flops"], hlo_bytes=c["bytes"], collectives=stats,
        model_flops=roofline_lib.model_flops(n_params, n_active, tokens,
                                             cell.kind),
        bytes_per_device={**memory, "argument_size_in_bytes":
                          memory["argument_size_in_bytes"]
                          - memory["unread_argument_size_in_bytes"]})
    row_ = rep.row()
    row_.update(base, status="ok", skip_reason=None,
                n_params=n_params, n_active=n_active, tokens=tokens,
                t_compile_s=round(c["seconds"], 1),
                t_probe_s=round(c["seconds"] if probed else 0.0, 1),
                memory=memory,
                hbm_ok=bool(sum(memory.get(k, 0) for k in
                                ("argument_size_in_bytes",
                                 "temp_size_in_bytes",
                                 "output_size_in_bytes"))
                            <= roofline_lib.HW.hbm_bytes))
    return row_


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="h100x1", choices=sorted(MESH_FLAGS),
                    help="h100x1: one card; single: pod16x16 (data 16, "
                         "model 16); multi: pod2x16x16; both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp", "sp"])
    ap.add_argument("--set-fsdp", action="store_true",
                    help="force cfg.fsdp=True (ZeRO over data)")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "gspmd", "shard_map"])
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--tag", default=None,
                    help="suffix for variant output files")
    ap.add_argument("--dp", type=int, default=None,
                    help="override the pod mesh: (dp, tp), (2, dp, tp) "
                         "for --mesh multi, under the same names")
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing")
    ap.add_argument("--remat-group", type=int, default=None,
                    help="sqrt-remat group size")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="seconds a cell may count for; a cell past it "
                         "writes an error row and the grid goes on")
    return ap


_DEADLINE = [None]       # time.monotonic() past which a count stops


@contextlib.contextmanager
def _deadline(seconds):
    """A count running inside raises TimeoutError at its first op after
    ``seconds`` (None: no limit)."""
    _DEADLINE[0] = time.monotonic() + seconds if seconds else None
    try:
        yield
    finally:
        _DEADLINE[0] = None


def _check_deadline() -> None:
    if _DEADLINE[0] is not None and time.monotonic() > _DEADLINE[0]:
        _DEADLINE[0] = None
        raise TimeoutError("the cell counted past its --cell-timeout")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    meshes = MESH_FLAGS[args.mesh]
    if meshes == ["h100x1"] and (args.dp or args.tp or args.layout != "tp"):
        raise SystemExit(
            f"--dp {args.dp}, --tp {args.tp}, --layout {args.layout}: one "
            "card places nothing; pass --mesh single|multi|both")
    mesh_shape = None
    if args.dp or args.tp:
        dp, tp = args.dp or 1, args.tp or 1
        mesh_shape = (2, dp, tp) if meshes == ["pod2x16x16"] else (dp, tp)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shape_names = list(shapes_lib.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    overrides = {**({"remat": False} if args.no_remat else {}),
                 **({"fsdp": True} if args.set_fsdp else {}),
                 **({"remat_group": args.remat_group}
                    if args.remat_group else {})} or None
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mesh in meshes:
        for arch in archs:
            for sname in shape_names:
                tag = f"__{args.tag}" if args.tag else ""
                fname = os.path.join(args.out,
                                     f"{arch}__{sname}__{mesh}{tag}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[cached] {fname}")
                    continue
                t0 = time.perf_counter()
                try:
                    with _deadline(args.cell_timeout):
                        row = run_cell(arch, sname, mesh=mesh,
                                       mesh_shape=mesh_shape,
                                       layout=args.layout,
                                       moe_dispatch=args.moe_dispatch,
                                       microbatch=args.microbatch,
                                       cfg_overrides=overrides)
                except Exception as e:   # recorded; the grid goes on
                    traceback.print_exc()
                    row = {"arch": arch, "shape": sname, "mesh": mesh,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "t_compile_s": round(time.perf_counter() - t0,
                                                1)}
                    failures += 1
                with open(fname, "w") as f:
                    json.dump(row, f, indent=1)
                msg = row["status"]
                if row["status"] == "ok":
                    msg = (f"ok  bottleneck={row['bottleneck']:10s} "
                           f"tc={row['t_compute_ms']:8.2f}ms "
                           f"tm={row['t_memory_ms']:8.2f}ms "
                           f"tmr={row['t_memory_refined_ms']:8.2f}ms "
                           f"tx={row['t_collective_ms']:8.2f}ms "
                           f"useful={row['useful_ratio']:.2f} "
                           f"roofline={row['roofline_fraction']:.3f} "
                           f"hbm_ok={row['hbm_ok']} "
                           f"counted={row['t_compile_s']:.0f}s")
                elif row["status"] == "skip":
                    msg = f"SKIP ({row['skip_reason']})"
                else:
                    msg = f"ERROR {row['error']}"
                print(f"{arch:18s} {sname:12s} {mesh:10s} {msg}",
                      flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
