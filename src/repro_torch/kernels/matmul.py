"""Dense fp32 matmul kernel: the lowering target of the TINA pointwise
convolution (paper Eq. 9).

The CUDA kernel is ``csrc/matmul.cu`` (``tina_matmul`` replaces the JAX
reference's ``kernels/matmul.py:matmul``; the source says what bounds it
and how).  :func:`matmul` launches it for a CUDA tensor and runs
:func:`matmul_plain` for a CPU tensor.  It runs full fp32 FMAs (no
TF32), as the reference's 2e-5 tolerance requires, and masks its ragged
edges instead of padding to block multiples.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tune

# Compiled tiles of csrc/matmul.cu, (bm, bn, bk): 256 threads each, with
# an 8 x 8 or 4 x 4 micro-tile per thread; the two the default picks.
TILES = ((128, 128, 16), (64, 64, 16))
ORDERS = ("mn", "nm")   # which tile index blockIdx.x walks: M or N

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)


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


__all__ = ["matmul", "matmul_plain", "TUNE_SPACE", "TILES", "ORDERS",
           "LAUNCHES"]
