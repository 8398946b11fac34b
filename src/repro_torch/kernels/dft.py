"""Blocked complex DFT kernel: TINA §4.1/§4.2, the (inverse) Fourier
matrix product of signal rows.

The CUDA kernel is ``csrc/dft.cu`` (it replaces the JAX reference's
``kernels/dft.py:dft``; the source says what bounds it and how): a
3xTF32 product on the tensor cores (``wgmma``), each value split into two
TF32 parts, hi + lo, and X F taken as Xhi Fhi + Xhi Flo + Xlo Fhi.
:func:`dft` launches it for a CUDA tensor and runs :func:`dft_plain`, the
same arithmetic in plain fp32 torch, for a CPU tensor.  Two variants:

  * ``4mult``  Zr = Xr Fr − Xi Fi ; Zi = Xr Fi + Xi Fr
  * ``3mult``  Karatsuba: k1 = (Xr+Xi) Fr, k2 = Xr (Fi−Fr),
               k3 = Xi (Fr+Fi); Zr = k1 − k3, Zi = k1 + k2

The signal is complex64, read as interleaved pairs, or real float32,
whose imaginary plane is never formed ("null xi"): the real forward DFT
of an STFT does half the work of a complex one.  The result is complex64.

The F side is split on the host, once per matrix: :func:`tf32_planes`
makes the hi and lo TF32 parts of every plane the variant multiplies,
K-major (N, L) as the tensor cores take B, zero-padded to tile multiples
(``core/functions.py:_dfm_tf32_tensors`` keeps them per (n, inverse,
variant, device)).  The X side is split in the kernel.  TMA reads X where
its rows are 16-byte aligned; elsewhere the wrapper copies X into a
zero-padded buffer first (:func:`staging` says which, by shape).

:func:`dft_int8` is the int8 tier's real-signal DFT: ``tina_dft_int8`` in
``csrc/qmatmul.cu`` replaces the reference's ``kernels/dft.py:dft_int8``
(one int8 x block against the int8 Fr and Fi, two int32 accumulators, on
the s8 tensor cores, which take B K-major: a caller passes the K-major
copies of Fr and Fi made once, ``frt``/``fit``);
:func:`dft_int8_plain` is its function in plain torch, equal bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, tune
from repro_torch.kernels import matmul as mm_kernel

# The compiled tiles of csrc/dft.cu (rows x columns per block): 128 rows,
# two consumer warpgroups of 64, by 64 columns (a second f32 accumulator
# set per warpgroup, for accuracy, leaves no registers for 128), or by 16
# where N <= 16 (the PFB's DFT stage at P = 16: no dead columns past 16,
# and a quarter of the registers, so more blocks share an SM).
TILES = ((128, 64), (128, 16))
VARIANTS = ("4mult", "3mult")
BK = 32          # K per ring stage: one 128-byte row of f32
STAGES = 2       # ring depth
N_ALIGN = 64     # the planes' N padding: the tile's columns

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
INT8_LAUNCHES = 0   # the same for dft_int8


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of a tile's largest ring (a complex x at
    3mult): per stage the X tile (two 128-byte halves of a complex row)
    and a hi and a lo F tile for each of three planes, bm or bn rows of
    128 bytes; the mbarriers and 1 KB of alignment."""
    stage = 2 * bm * 128 + 2 * 3 * bn * 128
    return STAGES * stage + 2 * STAGES * 8 + 1024


def default_bn(n: int) -> int:
    """The column tile for N output columns: 16 where N <= 16, else 64."""
    return 16 if n <= 16 else 64


# ctx: {"m": rows, "n": out cols, "k": inner}.  Hard limit: a compiled
# tile, whose ring (160 KB at most: complex x, three planes) fits the
# 227 KB of shared memory a block may use.
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="dft",
    params=("bm", "bn"),
    candidates=lambda ctx: tuple({"bm": bm, "bn": bn} for bm, bn in TILES),
    valid=lambda cfg, ctx: ((cfg["bm"], cfg["bn"]) in TILES
                            and smem_bytes(cfg["bm"], cfg["bn"])
                            <= tune.SMEM_BUDGET),
    default=lambda ctx: {"bm": 128, "bn": default_bn(ctx["n"])},
))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# the TF32 split of csrc/hopper.cuh:split_tf32, shared with the GEMM
tf32_split = mm_kernel.tf32_split


def tf32_planes(fr: torch.Tensor, fi: torch.Tensor,
                variant: str = "4mult") -> torch.Tensor:
    """The F side of the kernel, made once per matrix: (2 P, n_pad,
    l_pad) float32, for each plane its hi then its lo TF32 part, K-major
    ((N, L), the transpose of fr), zero-padded to n_pad (a multiple of
    64) and l_pad (a multiple of 32).  The planes are Fr, Fi (4mult,
    P = 2) or Fr, Fi − Fr, Fr + Fi (3mult, P = 3), the differences taken
    in f32 as :func:`dft_plain` takes them."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown dft variant {variant!r}")
    l, n = fr.shape
    planes = ((fr, fi) if variant == "4mult" else (fr, fi - fr, fr + fi))
    out = torch.zeros((2 * len(planes), _round_up(n, N_ALIGN),
                       _round_up(l, BK)), dtype=torch.float32,
                      device=fr.device)
    for p, f in enumerate(planes):
        hi, lo = tf32_split(f.to(torch.float32).t())
        out[2 * p, :n, :l] = hi
        out[2 * p + 1, :n, :l] = lo
    return out


def staging(x: torch.Tensor) -> str:
    """How the kernel reads x: ``"tma"`` straight from x when its rows
    are 16-byte aligned (L a multiple of 2 for complex64, of 4 for
    float32, and an aligned start), else ``"padded_copy"``: x copied
    into rows zero-padded to a multiple of 4 first."""
    row_bytes = x.shape[-1] * (8 if x.is_complex() else 4)
    return ("tma" if row_bytes % 16 == 0 and x.data_ptr() % 16 == 0
            else "padded_copy")


def dft_plain(x: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
              variant: str = "3mult") -> torch.Tensor:
    """The kernel's products in plain torch: x (B, L) complex or real,
    fr/fi (L, N) -> complex (B, N).  A real x has no imaginary plane."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown dft variant {variant!r}")
    xr, xi = (x.real, x.imag) if x.is_complex() else (x, None)
    if variant == "4mult":
        zr, zi = xr @ fr, xr @ fi
        if xi is not None:
            zr = zr - xi @ fi
            zi = zi + xi @ fr
    else:
        k1 = (xr if xi is None else xr + xi) @ fr
        zr = k1 if xi is None else k1 - xi @ (fr + fi)
        zi = k1 + xr @ (fi - fr)
    return torch.complex(zr, zi)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"dft: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"dft: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"dft: {name} on {t.device}, x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"dft: {name} must be contiguous")


def dft(x: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor, *,
        variant: str = "3mult", bm: int = 128, bn: int = 64,
        planes: torch.Tensor | None = None,
        hermitian: bool = False) -> torch.Tensor:
    """x (B, L) complex64 or float32, fr/fi (L, N) float32 (the forward
    or inverse Fourier matrix) -> complex64 (B, N) = x (fr + i fi).
    ``planes``: :func:`tf32_planes` of (fr, fi, variant), made once by a
    caller whose matrix is a constant; None splits fr and fi here, per
    call.  ``hermitian`` (a real x at 4mult): the caller vouches that
    fr + i fi is a DFM, F[l, N - n] = conj F[l, n], so the kernel may
    compute columns 0 .. N/2 and write the others as their conjugates,
    which it does where that saves column tiles (the plain version
    computes every column).

    A CPU tensor runs :func:`dft_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    dev = x.device
    if dev.type == "cpu":
        return dft_plain(x, fr, fi, variant)
    if dev.type != "cuda":
        raise ValueError(f"dft: no kernel for device {dev}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown dft variant {variant!r}")
    b, l = x.shape
    n = fr.shape[1]
    cplx = x.is_complex()
    _check("x", x, torch.complex64 if cplx else torch.float32, (b, l), dev)
    _check("fr", fr, torch.float32, (l, n), dev)
    _check("fi", fi, torch.float32, (l, n), dev)
    if (bm, bn) not in TILES:
        raise ValueError(f"dft: tile ({bm}, {bn}) not compiled; have "
                         f"{TILES}")
    if hermitian and (cplx or variant != "4mult"):
        raise ValueError("dft: hermitian takes a real x at 4mult")
    if planes is None:
        planes = tf32_planes(fr, fi, variant)
    np_ = 2 if variant == "4mult" else 3
    _check("planes", planes, torch.float32,
           (2 * np_, _round_up(n, N_ALIGN), _round_up(l, BK)), dev)
    out = torch.empty((b, n), device=dev, dtype=torch.complex64)
    if out.numel() == 0:
        return out
    if staging(x) != "tma":
        xs = torch.zeros((b, _round_up(l, 4)), dtype=x.dtype, device=dev)
        xs[:, :l] = x
        x = xs
    code = _build.lib().tina_dft(
        x.data_ptr(), int(cplx), x.shape[1], planes.data_ptr(),
        planes.shape[1], planes.shape[2], out.data_ptr(), b, l, n,
        int(variant == "3mult"), int(hermitian), bm, bn,
        _build.stream(dev))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "dft")
    return out


# -- int8 ------------------------------------------------------------------
# Compiled tiles of tina_dft_int8 (bm, bn, bk): 128 rows (two consumer
# warpgroups of 64) by 128 or 64 columns of both planes, L in 128-byte
# steps through matmul_int8's four-stage TMA ring.  128 x 64 is for
# N <= 64, where 128 columns would compute and skip half.
TILES_INT8 = ((128, 128, 128), (128, 64, 128))


def int8_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of an int8 DFT tile: per stage a bm x bk
    chunk of xq and a bn x bk chunk of each of Fr^T and Fi^T, the
    mbarriers, 1 KB of alignment."""
    return mm_kernel.INT8_STAGES * (bm + 2 * bn) * bk \
        + 2 * mm_kernel.INT8_STAGES * 8 + 1024


# ctx: {"m": rows, "n": out cols, "k": inner}.  Hard limits: a compiled
# tile, whose ring (193 KB at 128 x 128) fits the 227 KB a block may use,
# and L <= MAX_INT8_K.  ops.qdft runs a complex input's four products
# through matmul_int8, at a tile of matmul_int8's own space.
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="dft_int8",
    params=("bm", "bn", "bk"),
    candidates=lambda ctx: tuple({"bm": bm, "bn": bn, "bk": bk}
                                 for bm, bn, bk in TILES_INT8),
    valid=lambda cfg, ctx: ((cfg["bm"], cfg["bn"], cfg["bk"]) in TILES_INT8
                            and int8_smem_bytes(cfg["bm"], cfg["bn"],
                                                cfg["bk"]) <= tune.SMEM_BUDGET
                            and ctx["k"] <= mm_kernel.MAX_INT8_K),
    default=lambda ctx: {"bm": 128, "bn": 128 if ctx["n"] > 64 else 64,
                         "bk": 128},
))


def dft_int8_plain(xq: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
                   sx: torch.Tensor, sr: torch.Tensor,
                   si: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: complex64 (B, N) =
    (xq @ fr · sx) · sr + i (xq @ fi · sx) · si, exact int32 sums."""
    return torch.complex(mm_kernel.matmul_int8_plain(xq, fr, sx, sr),
                         mm_kernel.matmul_int8_plain(xq, fi, sx, si))


def dft_int8(xq: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
             sx: torch.Tensor, sr: torch.Tensor, si: torch.Tensor, *,
             frt: torch.Tensor | None = None,
             fit: torch.Tensor | None = None, bm: int = 128, bn: int = 128,
             bk: int = 128) -> torch.Tensor:
    """Real-signal int8 DFT: xq (B, L) int8 rows with per-row scales sx
    (B,); fr / fi (L, N) the int8 Fourier matrix with per-column scales
    sr / si (N,) -> complex64 (B, N).  ``frt`` / ``fit``: the K-major
    (N, L) copies of fr and fi, the tensor cores' B operands, where the
    caller made them once (the int8 DFM: ``quantize._qdfm_kmajor``); None
    transposes here, per call.

    A CPU tensor runs :func:`dft_int8_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    if xq.ndim != 2 or fr.ndim != 2 or xq.shape[1] != fr.shape[0]:
        raise ValueError(f"dft_int8: shapes {tuple(xq.shape)} @ "
                         f"{tuple(fr.shape)}")
    b, l = xq.shape
    n = fr.shape[1]
    dev = xq.device
    if dev.type == "cpu":
        return dft_int8_plain(xq, fr, fi, sx, sr, si)
    if dev.type != "cuda":
        raise ValueError(f"dft_int8: no kernel for device {dev}")
    if frt is None:
        frt = fr.t().contiguous()
    if fit is None:
        fit = fi.t().contiguous()
    mm_kernel.check_args(
        "dft_int8", dev, xq=(xq, torch.int8, (b, l)),
        fr=(fr, torch.int8, (l, n)), fi=(fi, torch.int8, (l, n)),
        frt=(frt, torch.int8, (n, l)), fit=(fit, torch.int8, (n, l)),
        sx=(sx, torch.float32, (b,)), sr=(sr, torch.float32, (n,)),
        si=(si, torch.float32, (n,)))
    if (bm, bn, bk) not in TILES_INT8:
        raise ValueError(f"dft_int8: tile {(bm, bn, bk)} not compiled; "
                         f"have {TILES_INT8}")
    if not 0 < l <= mm_kernel.MAX_INT8_K:
        raise ValueError(f"dft_int8: L = {l} outside "
                         f"1..{mm_kernel.MAX_INT8_K}")
    out = torch.empty((b, n), device=dev, dtype=torch.complex64)
    if out.numel() == 0:
        return out
    if mm_kernel.int8_staging(xq, frt, fit) != "tma":
        lp = -(-l // mm_kernel.INT8_K_ALIGN) * mm_kernel.INT8_K_ALIGN
        xq, frt, fit = (mm_kernel.pad_k(t, lp) for t in (xq, frt, fit))
    code = _build.lib().tina_dft_int8(
        xq.data_ptr(), frt.data_ptr(), fit.data_ptr(), sx.data_ptr(),
        sr.data_ptr(), si.data_ptr(), out.data_ptr(), b, xq.shape[1], n, bm,
        bn, bk, _build.stream(dev))
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "dft_int8")
    return out


__all__ = ["dft", "dft_plain", "TUNE_SPACE", "TILES", "VARIANTS",
           "default_bn",
           "tf32_split", "tf32_planes", "staging", "smem_bytes",
           "LAUNCHES", "dft_int8", "dft_int8_plain", "TUNE_SPACE_INT8",
           "TILES_INT8", "INT8_LAUNCHES", "int8_smem_bytes"]
