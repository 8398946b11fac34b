"""Dense matmul kernels: the lowering target of the TINA pointwise
convolution (paper Eq. 9), in fp32 and in int8.

``csrc/matmul.cu`` (``tina_matmul``) replaces the JAX reference's
``kernels/matmul.py:matmul``: :func:`matmul` launches it for a CUDA
tensor and runs :func:`matmul_plain` for a CPU tensor.  It runs full
fp32 FMAs (no TF32), as the reference's 2e-5 tolerance requires.

``csrc/qmatmul.cu`` (``tina_matmul_int8``) replaces
``kernels/matmul.py:matmul_int8``: :func:`matmul_int8` launches it for a
CUDA tensor and runs :func:`matmul_int8_plain` (the exact integer
contraction of :mod:`repro_torch.core.quantize` and the same epilogue)
for a CPU tensor; the two agree bit for bit.

Both mask their ragged edges instead of padding to block multiples; the
sources say what bounds them and how.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantize
from repro_torch.kernels import _build, tune

# Compiled tiles of csrc/matmul.cu, (bm, bn, bk): 256 threads each, with
# an 8 x 8 or 4 x 4 micro-tile per thread; the two the default picks.
TILES = ((128, 128, 16), (64, 64, 16))
ORDERS = ("mn", "nm")   # which tile index blockIdx.x walks: M or N

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
INT8_LAUNCHES = 0   # the same for matmul_int8


def _default(ctx: dict) -> dict:
    big = min(ctx["m"], ctx["n"]) >= 1024
    return {"bm": 128 if big else 64, "bn": 128 if big else 64, "bk": 16,
            "order": "mn"}


# ctx: {"m": rows, "n": cols, "k": inner}.  Hard limits: a compiled tile
# and a grid order the kernel knows (the shared memory per tile is fixed,
# 16.6 KB at most).
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="matmul",
    params=("bm", "bn", "bk", "order"),
    candidates=lambda ctx: tuple(
        {"bm": bm, "bn": bn, "bk": bk, "order": order}
        for bm, bn, bk in TILES for order in ORDERS),
    valid=lambda cfg, ctx: ((cfg["bm"], cfg["bn"], cfg["bk"]) in TILES
                            and cfg["order"] in ORDERS),
    default=_default,
))


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: x (M, K) @ y (K, N) in fp32
    (``torch.backends.cuda.matmul.allow_tf32`` must stay False)."""
    return x @ y


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
           bn: int = 128, bk: int = 16, order: str = "mn") -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N), float32.

    A CPU tensor runs :func:`matmul_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return matmul_plain(x, y)
    if dev.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {dev}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"matmul: {name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"matmul: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"matmul: {name} must be contiguous")
    if (bm, bn, bk) not in TILES or order not in ORDERS:
        raise ValueError(f"matmul: tile {(bm, bn, bk)} order {order!r} not "
                         f"compiled; have {TILES} x {ORDERS}")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    code = _build.lib().tina_matmul(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
        int(order == "nm"), torch.cuda.current_stream(dev).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "matmul")
    return out


# -- int8 ------------------------------------------------------------------
# Compiled tiles of csrc/qmatmul.cu, (bm, bn, bk): 256 threads each, an
# 8 x 8 or 4 x 4 int32 micro-tile per thread, K in chunks of 32 int8.
TILES_INT8 = ((128, 128, 32), (64, 64, 32))


def _default_int8(ctx: dict) -> dict:
    big = min(ctx["m"], ctx["n"]) >= 1024
    return {"bm": 128 if big else 64, "bn": 128 if big else 64, "bk": 32}


# ctx: {"m": rows, "n": cols, "k": inner}.  Hard limits: a compiled tile
# (its static shared memory, 8.3 KB at most, is far inside the 227 KB a
# block may have) and K <= MAX_INT8_K, so that K * 127^2 fits the int32
# accumulator.
MAX_INT8_K = 0x7fffffff // (127 * 127)
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="matmul_int8",
    params=("bm", "bn", "bk"),
    candidates=lambda ctx: tuple({"bm": bm, "bn": bn, "bk": bk}
                                 for bm, bn, bk in TILES_INT8),
    valid=lambda cfg, ctx: ((cfg["bm"], cfg["bn"], cfg["bk"]) in TILES_INT8
                            and ctx["k"] <= MAX_INT8_K),
    default=_default_int8,
))


def matmul_int8_plain(xq: torch.Tensor, yq: torch.Tensor, sx: torch.Tensor,
                      sy: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: the exact int32 product
    xq (M, K) @ yq (K, N), then ``(float(acc) * sx[m]) * sy[n]``."""
    acc = quantize.int8_dot(xq, yq).to(torch.float32)
    return acc * sx.reshape(-1, 1) * sy.reshape(1, -1)


def check_int8_args(what: str, dev: torch.device, **tensors) -> None:
    """Raise unless each (tensor, dtype, shape) lies on ``dev``,
    contiguous, with its dtype and shape."""
    for name, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def matmul_int8(xq: torch.Tensor, yq: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor, *, bm: int = 128, bn: int = 128,
                bk: int = 32) -> torch.Tensor:
    """int8 xq (M, K) @ int8 yq (K, N) with exact int32 accumulation;
    float32 out = (acc * sx[m]) * sy[n] with sx (M,), sy (N,) float32.

    A CPU tensor runs :func:`matmul_int8_plain`; a CUDA tensor launches
    the kernel on the current stream or raises."""
    if xq.ndim != 2 or yq.ndim != 2 or xq.shape[1] != yq.shape[0]:
        raise ValueError(f"matmul_int8: shapes {tuple(xq.shape)} @ "
                         f"{tuple(yq.shape)}")
    m, k = xq.shape
    n = yq.shape[1]
    dev = xq.device
    if dev.type == "cpu":
        return matmul_int8_plain(xq, yq, sx, sy)
    if dev.type != "cuda":
        raise ValueError(f"matmul_int8: no kernel for device {dev}")
    check_int8_args("matmul_int8", dev, xq=(xq, torch.int8, (m, k)),
                    yq=(yq, torch.int8, (k, n)),
                    sx=(sx, torch.float32, (m,)), sy=(sy, torch.float32, (n,)))
    if (bm, bn, bk) not in TILES_INT8:
        raise ValueError(f"matmul_int8: tile {(bm, bn, bk)} not compiled; "
                         f"have {TILES_INT8}")
    if not 0 < k <= MAX_INT8_K:
        raise ValueError(f"matmul_int8: K = {k} outside 1..{MAX_INT8_K} "
                         "(K * 127^2 must fit the int32 accumulator)")
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    code = _build.lib().tina_matmul_int8(
        xq.data_ptr(), yq.data_ptr(), sx.data_ptr(), sy.data_ptr(),
        out.data_ptr(), m, n, k, bm, bn, bk,
        torch.cuda.current_stream(dev).cuda_stream)
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "matmul_int8")
    return out


__all__ = ["matmul", "matmul_plain", "TUNE_SPACE", "TILES", "ORDERS",
           "LAUNCHES", "matmul_int8", "matmul_int8_plain", "TUNE_SPACE_INT8",
           "TILES_INT8", "INT8_LAUNCHES", "MAX_INT8_K"]
