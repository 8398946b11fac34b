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
  * precision view -- ``precisions`` names the tiers the op supports
    (``"f32"`` always; ``"bf16"`` generically: inputs and output rounded
    through bfloat16 around the f32 impl; ``"int8"`` where a quantized
    impl exists or the op is pure data movement).  ``budgets`` declares
    the per-tier accuracy :class:`Budget` against the f32 oracle;
    ``qimpl`` is the int8 implementation (``(args, attrs, qpack,
    lowering, block)``, built on :mod:`repro_torch.core.quantize`, with
    ``lowering="kernel"`` routing to the int8 CUDA kernels per
    ``q_lowerings``) and ``qprep`` quantizes const weights once at plan
    build (``(attrs, {argpos: const}) -> qpack``).

The port declares every op of the reference: the eleven Table-1 ops
(``ew_mul``, ``ew_add``, ``matmul``, ``summation``, ``dft``, ``idft``,
``fir``, ``unfold``, ``overlap_add``, ``pfb_frontend``, ``pfb``) and the
graph-only glue (``window``, ``abs2``, ``scale``, ``real``,
``downsample``, ``frame_decimate``, ``fused_ew``), in the reference's
order, with the reference's precision declarations.  The streaming
fields come with their slice; a graph naming an op missing here fails
to compile with the reference's "unknown op" error.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import functions, pfb, quantize


def _kops():
    from repro_torch.kernels import ops
    return ops


# ---------------------------------------------------------------------------
# precision tiers: accuracy budgets + bf16 rounding
# ---------------------------------------------------------------------------
PRECISIONS = ("f32", "bf16", "int8")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sqnr_db(ref, out) -> float:
    """Signal-to-quantization-noise ratio in dB of ``out`` against the
    reference: ``10·log10(mean|ref|² / mean|out−ref|²)``; infinite for an
    exact match.  The one accuracy metric of the precision tiers."""
    ref = _np(ref)
    out = _np(out)
    p_ref = float(np.mean(np.abs(ref) ** 2))
    p_err = float(np.mean(np.abs(out - ref) ** 2))
    if p_err == 0.0:
        return float("inf")
    if p_ref == 0.0:
        return float("-inf")
    return 10.0 * float(np.log10(p_ref / p_err))


@dataclasses.dataclass(frozen=True)
class Budget:
    """Per-precision accuracy budget: a reduced-precision execution of
    the op must achieve at least ``sqnr_db`` dB against the f32
    reference (and/or stay within ``atol`` max abs error)."""
    sqnr_db: float | None = None
    atol: float | None = None

    def check(self, ref, out) -> tuple[bool, dict]:
        """(ok, achieved): achieved carries the measured metrics."""
        achieved = {"sqnr_db": sqnr_db(ref, out),
                    "max_abs_err": float(np.max(np.abs(_np(out) - _np(ref))))}
        ok = True
        if self.sqnr_db is not None and achieved["sqnr_db"] < self.sqnr_db:
            ok = False
        if self.atol is not None and achieved["max_abs_err"] > self.atol:
            ok = False
        return ok, achieved


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """bf16 numerics simulated on f32 tensors: round through bfloat16
    (round to nearest even) and back, real and imaginary parts separately
    for complex input; other dtypes pass unchanged.  So the bf16 tier
    composes with every lowering: kernels see f32 holding bf16 values."""
    if x.is_complex():
        part = x.real.dtype
        return torch.complex(x.real.to(torch.bfloat16).to(part),
                             x.imag.to(torch.bfloat16).to(part))
    if x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


# every op supporting bf16 inherits this budget unless it declares its
# own: 8 mantissa bits give ~48 dB per value, and f32 accumulation keeps
# composite ops comfortably above 30 dB
_BF16_DEFAULT_BUDGET = Budget(sqnr_db=30.0)


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
    precisions: tuple[str, ...] = ("f32", "bf16")
    # tiers the op supports; "int8" needs a qimpl or a precision-
    # transparent op (pure data movement: its f32 impl IS its int8 one)
    budgets: tuple[tuple[str, Budget], ...] = ()
    # (precision, Budget) pairs; bf16 falls back to the module default
    qimpl: Callable | None = None
    # (args, attrs, qpack, lowering, block) -> Tensor: the int8 impl;
    # qpack is the plan-built weight pack from qprep, or None (quantize
    # the weight per call)
    qprep: Callable | None = None              # (attrs, {argpos: const})
    # -> qpack | None: quantize const weights once at plan build
    qok: Callable[[dict], bool] | None = None  # attrs -> int8 supported?
    q_lowerings: tuple[str, ...] = ("native",)
    # lowerings the qimpl understands; any other request runs native
    qtune_space: str | None = None
    # kernels.tune space of the op's int8 kernel (shares tune_ctx)

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

    def supports_precision(self, precision: str,
                           attrs: dict | None = None) -> bool:
        """f32 always; otherwise the tier must be declared and (for
        int8) pass the op's attr-level ``qok`` guard when attrs are
        given."""
        if precision in (None, "f32"):
            return True
        if precision not in self.precisions:
            return False
        if precision == "int8" and self.qok is not None and attrs is not None:
            return bool(self.qok(attrs))
        return True

    def budget(self, precision: str) -> Budget | None:
        """The declared accuracy Budget for ``precision`` (bf16 falls
        back to the module default; f32 has none: it is the reference)."""
        for p, b in self.budgets:
            if p == precision:
                return b
        if precision == "bf16" and "bf16" in self.precisions:
            return _BF16_DEFAULT_BUDGET
        return None


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
# quantized (int8) implementations, on repro_torch.core.quantize: exact
# integer contractions, one f32 rescale at the epilogue.  lowering=
# "kernel" launches the int8 CUDA kernel, anything else runs the torch
# integer path; the two are bit-identical.
# ---------------------------------------------------------------------------
def _qimpl_matmul(args, at, qpack, lowering="native", block=None):
    x, w = args[0], args[1]
    wq, ws = qpack if qpack is not None else quantize.quantize_weights(w)
    if lowering == "kernel":
        return _kops().qmatmul(x, wq, ws.reshape(-1), **(block or {}))
    return quantize.qmatmul(x, wq, ws.reshape(-1))


def _qprep_matmul(at, consts):
    w = consts.get(1)
    if w is None:
        return None
    wq, ws = quantize.quantize_weights(w)
    return wq, ws.reshape(-1)


def _qimpl_dft(args, at, qpack, lowering="native", block=None):
    if lowering == "kernel":
        return _kops().qdft(args[0], **(block or {}))
    return quantize.qdft(args[0])


def _qimpl_idft(args, at, qpack, lowering="native", block=None):
    if lowering == "kernel":
        return _kops().qdft(args[0], inverse=True, **(block or {}))
    return quantize.qidft(args[0])


def _qimpl_fir(args, at, qpack, lowering="native", block=None):
    if at["mode"] != "valid":            # guarded by qok
        return functions.fir(args[0], args[1], mode=at["mode"],
                             flip=at["flip"])
    if lowering == "kernel":
        qtaps = (qpack if qpack is not None
                 else quantize.quantize_fir_taps(args[1], flip=at["flip"]))
        return _kops().qfir(args[0], *qtaps, **(block or {}))
    return quantize.qfir(args[0], args[1], flip=at["flip"], qtaps=qpack)


def _qprep_fir(at, consts):
    taps = consts.get(1)
    if taps is None or at["mode"] != "valid":
        return None
    return quantize.quantize_fir_taps(taps, flip=at["flip"])


def _qimpl_pfb_frontend(args, at, qpack, lowering="native", block=None):
    # native only: the f32 kernel frontend rides pfb_fused with an
    # identity DFT, which has no integer analogue (the identity would be
    # quantized too); the torch int8 einsum is already integer compute
    return quantize.qpfb_frontend(args[0], args[1] if len(args) > 1 else None,
                                  qtaps=qpack)


def _qimpl_pfb(args, at, qpack, lowering="native", block=None):
    if lowering == "kernel":
        qtaps = (qpack if qpack is not None
                 else quantize.quantize_pfb_taps(args[1]))
        return _kops().qpfb(args[0], *qtaps, **(block or {}))
    return quantize.qpfb(args[0], args[1] if len(args) > 1 else None,
                         qtaps=qpack)


def _qprep_pfb(at, consts):
    taps = consts.get(1)
    if taps is None:
        return None
    return quantize.quantize_pfb_taps(taps)


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
    tune_space="matmul", tune_ctx=_ctx_matmul,
    precisions=("f32", "bf16", "int8"),
    budgets=(("int8", Budget(sqnr_db=28.0)),),
    qimpl=_qimpl_matmul, qprep=_qprep_matmul,
    q_lowerings=("native", "kernel"), qtune_space="matmul_int8"))

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
    table_name="dft", tune_space="dft", tune_ctx=_ctx_dft,
    precisions=("f32", "bf16", "int8"),
    budgets=(("int8", Budget(sqnr_db=26.0)),),
    qimpl=_qimpl_dft,
    q_lowerings=("native", "kernel"), qtune_space="dft_int8"))

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
    table_name="idft", tune_space="dft", tune_ctx=_ctx_dft,
    precisions=("f32", "bf16", "int8"),
    budgets=(("int8", Budget(sqnr_db=26.0)),),
    qimpl=_qimpl_idft,
    q_lowerings=("native", "kernel"), qtune_space="dft_int8"))

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
    table_name="fir", tune_space="fir", tune_ctx=_ctx_fir,
    precisions=("f32", "bf16", "int8"),
    budgets=(("int8", Budget(sqnr_db=30.0)),),
    qimpl=_qimpl_fir, qprep=_qprep_fir,
    qok=lambda at: at["mode"] == "valid",
    q_lowerings=("native", "kernel"), qtune_space="fir_int8"))

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
    tune_space="unfold", tune_ctx=_ctx_unfold,
    # precision-transparent: pure data movement, the f32 impl IS the
    # int8 behavior, so int8 requests pass through instead of downgrading
    precisions=("f32", "bf16", "int8")))

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
    table_name="pfb_frontend", tune_space="pfb", tune_ctx=_ctx_pfb,
    precisions=("f32", "bf16", "int8"),
    budgets=(("int8", Budget(sqnr_db=26.0)),),
    qimpl=_qimpl_pfb_frontend, qprep=_qprep_pfb))

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
    table_name="pfb", tune_space="pfb", tune_ctx=_ctx_pfb,
    precisions=("f32", "bf16", "int8"),
    budgets=(("int8", Budget(sqnr_db=26.0)),),
    qimpl=_qimpl_pfb, qprep=_qprep_pfb,
    q_lowerings=("native", "kernel"), qtune_space="pfb_int8"))

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


__all__ = ["OpDef", "Attr", "OPDEFS", "REQUIRED", "register", "table_ops",
           "Budget", "sqnr_db", "bf16_round", "PRECISIONS"]
