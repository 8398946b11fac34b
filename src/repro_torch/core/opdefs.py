"""Unified op definitions: one :class:`OpDef` per op, the record the
planner, the fuser and the kernels' tune spaces all derive from.

  * graph view -- ``impl`` (``(args, attrs, lowering, block)`` -> Tensor),
    ``lowerings``, the ``attrs`` schema and the ``elementwise`` fuser
    trait with its ``fuse_step``.
  * eager / Table-1 view -- ``eager`` (the user-facing function),
    ``oracle`` (pure numpy), ``make_args`` (sweep inputs) and
    ``table_name`` generate :data:`repro_torch.core.registry.REGISTRY`.
  * tuning view -- ``tune_space`` names the kernel's
    :class:`repro_torch.kernels.tune.TuneSpace`; ``tune_ctx`` extracts the
    shape facts the space needs.

The port declares every op of the reference: the eleven Table-1 ops
(``ew_mul``, ``ew_add``, ``matmul``, ``summation``, ``dft``, ``idft``,
``fir``, ``unfold``, ``overlap_add``, ``pfb_frontend``, ``pfb``) and the
graph-only glue (``window``, ``abs2``, ``scale``, ``real``,
``downsample``, ``frame_decimate``, ``fused_ew``), in the reference's
order.  The reference's precision and streaming fields come with their
slices; a graph naming an op missing here fails to compile with the
reference's "unknown op" error.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import functions, pfb


def _kops():
    from repro_torch.kernels import ops
    return ops


REQUIRED = object()      # sentinel: attr has no default, caller must set it


@dataclasses.dataclass(frozen=True)
class Attr:
    """One entry of an op's attr schema."""
    name: str
    default: Any = REQUIRED


@dataclasses.dataclass(frozen=True)
class OpDef:
    name: str                                  # graph op name (canonical)
    impl: Callable                             # (args, attrs, lowering, block)
    lowerings: tuple[str, ...] = ("native",)
    elementwise: bool = False                  # fuser trait (needs fuse_step)
    fuse_step: Callable[[dict], tuple] | None = None
    # attrs -> the op's step in a fused chain: ("mul",) / ("add",) consume
    # the node's second input, ("abs2",) squares a complex head,
    # ("scale", c) multiplies by a constant
    lowering_agnostic: bool = False
    # True: every lowering is the same computation, so a request for
    # conv/kernel is satisfied by native and is not a downgrade
    attrs: tuple[Attr, ...] = ()               # attr schema
    section: str = ""                          # paper section
    building_block: str = ""                   # paper Table 1 column
    eager: Callable | None = None              # user-facing fn(*args, lowering=)
    oracle: Callable | None = None             # numpy ref over make_args
    make_args: Callable | None = None          # rng, n -> args tuple
    table_name: str | None = None              # name in the Table-1 view
    arg_attrs: tuple[str, ...] = ()            # attrs bound to trailing
                                               # non-array make_args entries
    tune_space: str | None = None              # kernels.tune space key
    tune_ctx: Callable | None = None           # (attrs, in_shapes) -> dict

    def bind(self, attrs: dict) -> dict:
        """Merge ``attrs`` over the schema defaults and validate."""
        schema = {a.name: a for a in self.attrs}
        unknown = set(attrs) - set(schema)
        if unknown:
            raise ValueError(
                f"{self.name}: unknown attr(s) {sorted(unknown)}; "
                f"schema: {sorted(schema)}")
        out = {}
        for a in self.attrs:
            if a.name in attrs:
                out[a.name] = attrs[a.name]
            elif a.default is REQUIRED:
                raise ValueError(
                    f"{self.name}: missing required attr {a.name!r}")
            else:
                out[a.name] = a.default
        return out


OPDEFS: dict[str, OpDef] = {}


def register(op: OpDef) -> OpDef:
    if op.name in OPDEFS:
        raise ValueError(f"duplicate OpDef {op.name!r}")
    OPDEFS[op.name] = op
    return op


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------
def _np_fir_valid(x, taps):
    return np.stack([np.convolve(row, taps, mode="valid")
                     for row in np.atleast_2d(x)]).reshape(
        x.shape[:-1] + (x.shape[-1] - taps.shape[0] + 1,))


def _np_pfb_frontend(x, taps):
    m, p = taps.shape
    frames = x.reshape(x.shape[:-1] + (-1, p))
    nfr = frames.shape[-2]
    idx = np.arange(nfr - m + 1)[:, None] + np.arange(m)[None, :]
    return np.einsum("...tmp,mp->...tp", frames[..., idx, :], taps[::-1, :])


def _np_pfb(x, taps):
    return np.fft.fft(_np_pfb_frontend(x, taps), axis=-1)


def _np_unfold(x, j):
    n = x.shape[-1]
    idx = np.arange(n - j + 1)[:, None] + np.arange(j)[None, :]
    return x[..., idx]


def _np_overlap_add(frames, hop):
    t, j = frames.shape[-2], frames.shape[-1]
    k = j // hop
    nt = t - k + 1
    fk = frames.reshape(frames.shape[:-2] + (t, k, hop))
    acc = sum(fk[..., m:m + nt, k - 1 - m, :] for m in range(k))
    return acc.reshape(frames.shape[:-2] + (nt * hop,))


# ---------------------------------------------------------------------------
# graph implementations
# ---------------------------------------------------------------------------
def _ew_binary(kind: str):
    """window / ew_mul / ew_add: broadcast the operand, then dispatch."""
    fn_conv = (functions.elementwise_mult if kind == "mul"
               else functions.elementwise_add)

    def impl(args, at, lowering, block=None):
        x, y = args
        if lowering == "kernel":
            k = _kops()
            fn = k.elementwise_mult if kind == "mul" else k.elementwise_add
            return fn(x, y, **(block or {}))
        yb = y.expand(x.shape)
        if lowering == "conv" and x.ndim >= 2:
            return fn_conv(x, yb, lowering="conv")
        return x * yb if kind == "mul" else x + yb
    return impl


def _impl_overlap_add(args, at, lowering, block=None):
    (frames,) = args
    if at["window"] and frames.shape[-1] != at["window"]:
        raise ValueError(
            f"overlap_add: frames have length {frames.shape[-1]} but the "
            f"window attr says {at['window']}")
    return functions.overlap_add(frames, at["hop"], lowering=lowering,
                                 block=block)


def _impl_abs2(args, at, lowering, block=None):
    (x,) = args
    if lowering == "kernel":
        return _kops().abs2(x, **(block or {}))
    if not x.is_complex():
        # the reference's re² + 0² is x·x exactly (a matched filter's power)
        if lowering == "conv" and x.ndim >= 2:
            return functions.elementwise_mult(x, x, lowering="conv")
        return x * x
    re, im = x.real, x.imag
    if lowering == "conv" and re.ndim >= 2:
        return functions.elementwise_add(
            functions.elementwise_mult(re, re, lowering="conv"),
            functions.elementwise_mult(im, im, lowering="conv"),
            lowering="conv")
    return re * re + im * im


def _impl_fused(args, at, lowering, block=None):
    x, operands = args[0], tuple(args[1:])
    steps = at["steps"]
    if lowering == "kernel":
        return _kops().fused_elementwise(x, operands, steps, **(block or {}))
    k = 0
    acc = x
    for step in steps:
        tag = step[0]
        if tag == "abs2":
            acc = _impl_abs2((acc,), {}, lowering)
        elif tag in ("mul", "add"):
            fn = (functions.elementwise_mult if tag == "mul"
                  else functions.elementwise_add)
            o = operands[k].expand(acc.shape)
            k += 1
            if lowering == "conv" and acc.ndim >= 2:
                acc = fn(acc, o, lowering="conv")
            else:
                acc = acc * o if tag == "mul" else acc + o
        elif tag == "scale":
            acc = acc * step[1]
        else:
            raise ValueError(f"unknown fused step {tag!r}")
    return acc


# ---------------------------------------------------------------------------
# tune contexts
# ---------------------------------------------------------------------------
def _rows(shape) -> int:
    from repro_torch.kernels import tune
    return tune.leading_rows(shape)


def _ctx_pfb(at, shapes):
    m, p = int(shapes[1][0]), int(shapes[1][1])
    return {"m": m, "p": p, "t": int(shapes[0][-1]) // p}


def _ctx_fir(at, shapes):
    return {"k": int(shapes[1][-1]), "n": int(shapes[0][-1]),
            "rows": _rows(shapes[0])}


def _ctx_matmul(at, shapes):
    return {"m": _rows(shapes[0]), "n": int(shapes[1][-1]),
            "k": int(shapes[0][-1])}


def _ctx_unfold(at, shapes):
    return {"j": int(at["window"]), "n": int(shapes[0][-1]),
            "rows": _rows(shapes[0])}


def _ctx_dft(at, shapes):
    n = int(shapes[0][-1])
    return {"m": _rows(shapes[0]), "n": n, "k": n}


def _ctx_overlap_add(at, shapes):
    j = int(shapes[0][-1])
    hop = int(at["hop"])
    return {"j": j, "hop": hop, "k": j // hop, "t": int(shapes[0][-2]),
            "rows": _rows(shapes[0][:-1])}


def _ctx_ew_binary(at, shapes):
    shape = np.broadcast_shapes(tuple(shapes[0]), tuple(shapes[1]))
    return {"rows": _rows(shape), "cols": int(shape[-1]), "n_in": 2}


def _ctx_abs2(at, shapes):
    return {"rows": _rows(shapes[0]), "cols": int(shapes[0][-1]), "n_in": 2}


def _ctx_fused(at, shapes):
    steps = at["steps"]
    heads = 2 if (steps and steps[0][0] == "abs2") else 1
    return {"rows": _rows(shapes[0]), "cols": int(shapes[0][-1]),
            "n_in": heads + len(shapes) - 1}


# ---------------------------------------------------------------------------
# the declarations -- Table-1 ops (make_args as the reference's, so a test
# feeds both packages the same inputs)
# ---------------------------------------------------------------------------
def _NN(rng, n):
    return (rng.standard_normal((n, n), dtype=np.float32),
            rng.standard_normal((n, n), dtype=np.float32))


def _signal(rng, n):
    return rng.standard_normal((n * n,), dtype=np.float32)


register(OpDef(
    "ew_mul", _ew_binary("mul"), ("native", "conv", "kernel"),
    elementwise=True, fuse_step=lambda at: ("mul",),
    section="3.1", building_block="depthwise conv",
    eager=functions.elementwise_mult, oracle=lambda x, y: x * y,
    make_args=_NN, table_name="elementwise_mult",
    tune_space="elementwise", tune_ctx=_ctx_ew_binary))

register(OpDef(
    "ew_add", _ew_binary("add"), ("native", "conv", "kernel"),
    elementwise=True, fuse_step=lambda at: ("add",),
    section="3.3", building_block="depthwise conv",
    eager=functions.elementwise_add, oracle=lambda x, y: x + y,
    make_args=_NN, table_name="elementwise_add",
    tune_space="elementwise", tune_ctx=_ctx_ew_binary))

register(OpDef(
    "matmul",
    lambda a, at, lw, b=None: functions.matmul(a[0], a[1], lowering=lw,
                                               block=b),
    ("native", "conv", "kernel"),
    section="3.2", building_block="pointwise conv",
    eager=functions.matmul, oracle=lambda x, y: x @ y,
    make_args=_NN, table_name="matmul",
    tune_space="matmul", tune_ctx=_ctx_matmul))

register(OpDef(
    "summation",
    lambda a, at, lw, b=None: functions.summation(a[0], lowering=lw),
    ("native",), lowering_agnostic=True,   # the FC block has one code path
    section="3.4", building_block="fully connected",
    eager=functions.summation, oracle=lambda x: x.sum(-1),
    make_args=lambda rng, n: (_signal(rng, n),),
    table_name="summation"))

register(OpDef(
    "dft",
    lambda a, at, lw, b=None: functions.dft(
        a[0], lowering=lw, variant=at["variant"], block=b),
    ("native", "conv", "kernel"),
    attrs=(Attr("variant", "4mult"),),
    section="4.1", building_block="pointwise conv",
    eager=functions.dft, oracle=lambda x: np.fft.fft(x),
    make_args=lambda rng, n: (
        rng.standard_normal((max(1, n // 8), n), dtype=np.float32),),
    table_name="dft", tune_space="dft", tune_ctx=_ctx_dft))

register(OpDef(
    "idft",
    lambda a, at, lw, b=None: functions.idft(
        a[0], lowering=lw, variant=at["variant"], block=b),
    ("native", "conv", "kernel"),
    attrs=(Attr("variant", "4mult"),),
    section="4.2", building_block="pointwise conv",
    eager=functions.idft, oracle=lambda z: np.fft.ifft(z),
    make_args=lambda rng, n: ((
        rng.standard_normal((max(1, n // 8), n))
        + 1j * rng.standard_normal((max(1, n // 8), n))
    ).astype(np.complex64),),
    table_name="idft", tune_space="dft", tune_ctx=_ctx_dft))

register(OpDef(
    "fir",
    lambda a, at, lw, b=None: functions.fir(
        a[0], a[1], mode=at["mode"], flip=at["flip"], lowering=lw, block=b),
    ("native", "conv", "kernel"),
    attrs=(Attr("mode", "valid"), Attr("flip", True)),
    section="4.3", building_block="standard conv",
    eager=functions.fir, oracle=_np_fir_valid,
    make_args=lambda rng, n: (_signal(rng, n),
                              rng.standard_normal((31,), dtype=np.float32)),
    table_name="fir", tune_space="fir", tune_ctx=_ctx_fir))

register(OpDef(
    "unfold",
    lambda a, at, lw, b=None: functions.unfold(
        a[0], at["window"], lowering=lw, block=b),
    ("native", "conv", "kernel"),
    attrs=(Attr("window"),),
    section="4.4", building_block="standard conv",
    eager=functions.unfold, oracle=_np_unfold,
    make_args=lambda rng, n: (_signal(rng, n), 16),
    table_name="unfold", arg_attrs=("window",),
    tune_space="unfold", tune_ctx=_ctx_unfold))

register(OpDef(
    "overlap_add", _impl_overlap_add, ("native", "conv", "kernel"),
    attrs=(Attr("hop"), Attr("window", 0)),
    section="4.4 (inverse)", building_block="transposed conv",
    eager=functions.overlap_add, oracle=_np_overlap_add,
    make_args=lambda rng, n: (
        rng.standard_normal((max(2, n // 8), 64), dtype=np.float32), 32),
    table_name="overlap_add", arg_attrs=("hop",),
    tune_space="overlap_add", tune_ctx=_ctx_overlap_add))

register(OpDef(
    "pfb_frontend",
    lambda a, at, lw, b=None: pfb.pfb_frontend(a[0], a[1], lowering=lw,
                                               block=b),
    ("native", "conv", "kernel"),
    section="5.2", building_block="standard conv bank",
    eager=pfb.pfb_frontend, oracle=_np_pfb_frontend,
    make_args=lambda rng, n: (_signal(rng, n),
                              pfb.pfb_window(16, 8).astype(np.float32)),
    table_name="pfb_frontend", tune_space="pfb", tune_ctx=_ctx_pfb))

register(OpDef(
    "pfb",
    lambda a, at, lw, b=None: pfb.pfb(
        a[0], a[1], lowering=lw, variant=at["variant"], block=b),
    ("native", "conv", "kernel"),
    attrs=(Attr("variant", "4mult"),),
    section="5.2", building_block="conv bank + pointwise conv",
    eager=pfb.pfb, oracle=_np_pfb,
    make_args=lambda rng, n: (_signal(rng, n),
                              pfb.pfb_window(16, 8).astype(np.float32)),
    table_name="pfb", tune_space="pfb", tune_ctx=_ctx_pfb))

# ---------------------------------------------------------------------------
# glue primitives (graph-only: no Table-1 row)
# ---------------------------------------------------------------------------

register(OpDef(
    # multiply by a const vector along the last axis (same impl as
    # ew_mul; a distinct name keeps pipeline intent readable)
    "window", _ew_binary("mul"), ("native", "conv", "kernel"),
    elementwise=True, fuse_step=lambda at: ("mul",),
    section="3.1", building_block="depthwise conv",
    tune_space="elementwise", tune_ctx=_ctx_ew_binary))

register(OpDef(
    "abs2", _impl_abs2, ("native", "conv", "kernel"),
    elementwise=True, fuse_step=lambda at: ("abs2",),
    section="3.1+3.3", building_block="depthwise conv",
    tune_space="elementwise", tune_ctx=_ctx_abs2))

register(OpDef(
    "scale",
    lambda a, at, lw, b=None: a[0] * at["factor"],
    ("native",), elementwise=True,
    fuse_step=lambda at: ("scale", at["factor"]),
    lowering_agnostic=True, attrs=(Attr("factor"),)))

register(OpDef(
    "real",
    lambda a, at, lw, b=None: a[0].real,
    ("native",), lowering_agnostic=True))

register(OpDef(
    "downsample",     # pure data movement: the same view every lowering
    lambda a, at, lw, b=None: a[0][..., ::at["factor"]],
    ("native",), lowering_agnostic=True, attrs=(Attr("factor"),)))

register(OpDef(
    "frame_decimate",  # keep every factor-th frame (hop on a framed axis)
    lambda a, at, lw, b=None: a[0][..., ::at["factor"], :],
    ("native",), lowering_agnostic=True, attrs=(Attr("factor"),)))

register(OpDef(
    "fused_ew", _impl_fused, ("native", "conv", "kernel"),
    attrs=(Attr("steps"), Attr("members", ())),
    tune_space="elementwise", tune_ctx=_ctx_fused))


# ---------------------------------------------------------------------------
# derived views
# ---------------------------------------------------------------------------
def table_ops() -> list[OpDef]:
    """OpDefs with a Table-1 registry row (eager + oracle + make_args)."""
    return [d for d in OPDEFS.values() if d.table_name is not None]


__all__ = ["OpDef", "Attr", "OPDEFS", "REQUIRED", "register", "table_ops"]
