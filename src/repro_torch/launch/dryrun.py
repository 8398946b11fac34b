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
probes hold rwkv6's WKV loop and the attention chunks to two
superblocks' worth of dispatched ops at 32k tokens.  The FLOPs, op
bytes, operands and results are linear in the repeats, so the probed
counts equal the full step's (``tests/test_torch_dryrun.py``); the
peak is not (the phase that holds it moves with depth), so a probed
``temp_size_in_bytes`` is an estimate (a train step's lies below the
whole step's).
``run_cell(..., scan_correct=False)`` runs the whole step instead.

The step runs at the ``native`` lowering: a hand-written kernel cannot
run on a meta tensor.  Serving's operands are ``model.prepare``'s, as
the port serves (``launch/serve.py``): the native lowering then reads
each linear's compute-dtype K-major copy, as the bf16 kernel does, so
the FLOPs and the bytes read are the kernel lowering's.  ``chips`` is
1; nothing crosses cards, so the collective terms are 0.  The
partitioning layouts place nothing on one card: ``--layout`` waits for
the sharded steps (ROADMAP item 20), as ``--dp``/``--tp`` do.

Usage:
    python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
    python -m repro_torch.analysis.summarize experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline as roofline_lib
from repro_torch.configs import ARCHS, get
from repro_torch.data.pipeline import input_specs
from repro_torch.distributed import step as step_lib
from repro_torch.launch import shapes as shapes_lib
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.tree import flatten_with_path, leaves

MESHES = {"h100x1": 1}          # the one card
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


def run_cell(arch: str, shape_name, *, mesh: str = "h100x1",
             scan_correct: bool = True, microbatch: int = None,
             cfg_overrides: dict = None) -> dict:
    """One cell's row, with the reference's keys: the roofline terms on
    one H100, the parameter counts, ``memory`` and ``hbm_ok`` (the
    operands, the fresh results and the peak's temporaries within the
    card's 80 GB); ``t_compile_s`` is the seconds the counted runs
    took (the probes' own also as ``t_probe_s``).  ``shape_name`` names
    a cell of ``shapes.SHAPES`` or is a ``shapes.ShapeCell`` itself."""
    if mesh not in MESHES:
        raise NotImplementedError(
            f"mesh {mesh!r}: the port's dry-run runs on one card "
            f"({sorted(MESHES)}); meshes across cards are ROADMAP item 20")
    cfg = get(arch)
    if cfg_overrides:
        cfg = cfg.scaled(**cfg_overrides)
    cell = shape_name if isinstance(shape_name, shapes_lib.ShapeCell) \
        else shapes_lib.SHAPES[shape_name]
    skip = shapes_lib.skip_reason(cfg, cell)
    base = {"arch": arch, "shape": cell.name, "mesh": mesh,
            "kind": cell.kind, "status": "skip", "skip_reason": skip}
    if skip:
        return base
    chips = MESHES[mesh]
    base["mesh_shape"] = {"card": chips}
    c = cell_counts(cfg, cell, microbatch=microbatch,
                    scan_correct=scan_correct)
    probed = scan_correct and model_lib._pattern_layout(cfg)[1] > 1
    memory = c["memory"]
    n_params, n_active = count_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    rep = roofline_lib.RooflineReport(
        arch=arch, shape=cell.name, mesh=mesh, chips=chips,
        hlo_flops=c["flops"], hlo_bytes=c["bytes"],
        collectives=roofline_lib.CollectiveStats(),
        model_flops=roofline_lib.model_flops(n_params, n_active, tokens,
                                             cell.kind),
        bytes_per_device={**memory, "argument_size_in_bytes":
                          memory["argument_size_in_bytes"]
                          - memory["unread_argument_size_in_bytes"]})
    row = rep.row()
    row.update(base, status="ok", skip_reason=None,
               n_params=n_params, n_active=n_active, tokens=tokens,
               t_compile_s=round(c["seconds"], 1),
               t_probe_s=round(c["seconds"] if probed else 0.0, 1),
               memory=memory,
               hbm_ok=bool(sum(memory.get(k, 0) for k in
                               ("argument_size_in_bytes",
                                "temp_size_in_bytes",
                                "output_size_in_bytes"))
                           <= roofline_lib.HW.hbm_bytes))
    return row


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="h100x1",
                    choices=sorted(MESHES) + ["single", "multi", "both"],
                    help="h100x1: one card; the reference's pod meshes "
                         "are not ported (ROADMAP item 20)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--layout", default=None,
                    help="not ported: one card places nothing (ROADMAP "
                         "item 20)")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--tag", default=None,
                    help="suffix for variant output files")
    ap.add_argument("--dp", type=int, default=None,
                    help="not ported: a (dp, tp) mesh (ROADMAP item 20)")
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing")
    ap.add_argument("--remat-group", type=int, default=None,
                    help="sqrt-remat group size")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh not in MESHES or args.dp or args.tp or args.layout:
        raise SystemExit(
            f"--mesh {args.mesh}, --dp {args.dp}, --tp {args.tp}, --layout "
            f"{args.layout}: meshes across cards and their layouts belong "
            "to the multi-device stack, not ported (ROADMAP item 20); the "
            "port's dry-run runs on --mesh h100x1")
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shape_names = list(shapes_lib.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    overrides = {**({"remat": False} if args.no_remat else {}),
                 **({"remat_group": args.remat_group}
                    if args.remat_group else {})} or None
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for sname in shape_names:
            tag = f"__{args.tag}" if args.tag else ""
            fname = os.path.join(args.out,
                                 f"{arch}__{sname}__{args.mesh}{tag}.json")
            if args.skip_existing and os.path.exists(fname):
                print(f"[cached] {fname}")
                continue
            try:
                row = run_cell(arch, sname, mesh=args.mesh,
                               microbatch=args.microbatch,
                               cfg_overrides=overrides)
            except Exception as e:   # a failed cell is recorded, the grid goes on
                traceback.print_exc()
                row = {"arch": arch, "shape": sname, "mesh": args.mesh,
                       "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            with open(fname, "w") as f:
                json.dump(row, f, indent=1)
            msg = row["status"]
            if row["status"] == "ok":
                msg = (f"ok  bottleneck={row['bottleneck']:10s} "
                       f"tc={row['t_compute_ms']:8.2f}ms "
                       f"tm={row['t_memory_ms']:8.2f}ms "
                       f"tmr={row['t_memory_refined_ms']:8.2f}ms "
                       f"useful={row['useful_ratio']:.2f} "
                       f"roofline={row['roofline_fraction']:.3f} "
                       f"hbm_ok={row['hbm_ok']} "
                       f"counted={row['t_compile_s']:.0f}s")
            elif row["status"] == "skip":
                msg = f"SKIP ({row['skip_reason']})"
            print(f"{arch:18s} {sname:12s} {args.mesh:10s} {msg}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
