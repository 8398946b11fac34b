"""Dense matmul kernels: the lowering target of the TINA pointwise
convolution (paper Eq. 9), in fp32 and in int8.

``csrc/matmul.cu`` (``tina_matmul``) replaces the JAX reference's
``kernels/matmul.py:matmul``: :func:`matmul` launches it for a CUDA
tensor and runs :func:`matmul_plain` for a CPU tensor.  It is a 3xTF32
product on the tensor cores (``wgmma``): each value split into two TF32
parts, hi + lo, and x y taken as xhi yhi + xhi ylo + xlo yhi, each
32-deep chunk in a fresh accumulator added in f32, which keeps it within
the reference's 2e-5 of an fp32 product.  The tensor cores take B
K-major: :func:`tf32_planes` (a CUDA pass, ``tina_tf32_planes``; its
plain twin :func:`tf32_planes_plain`) splits y into its hi and lo planes,
K-major and zero-padded, in one read; a caller whose y is a constant
makes them once and passes them as ``yt_planes``.  TMA reads x where its
rows are 16-byte aligned; elsewhere the wrapper copies x into
zero-padded rows first (:func:`staging` says which, by shape).

``csrc/qmatmul.cu`` (``tina_matmul_int8``, s8 ``wgmma`` on the tensor
cores, TMA loads) replaces ``kernels/matmul.py:matmul_int8``:
:func:`matmul_int8` launches it for a CUDA tensor and runs
:func:`matmul_int8_plain` (the exact integer contraction of
:mod:`repro_torch.core.quantize` and the same epilogue) for a CPU
tensor; the two agree bit for bit.  The tensor cores take B K-major:
callers whose yq is a constant pass its transpose made once (``yt``).

``csrc/bf16_gemm.cu`` (``tina_matmul_bf16``, bf16 ``wgmma`` on the
tensor cores, TMA loads) replaces the same ``kernels/matmul.py:matmul``
on bf16 operands, whose output the reference gives x's dtype:
:func:`matmul` launches it for bf16 CUDA tensors and runs
:func:`matmul_bf16_plain` (exact products summed in f32, rounded once to
bf16) for bf16 CPU tensors.  The tensor cores take B K-major here too:
callers whose y is a constant pass its K-major copy made once (``yt``).
One launch a call, through one of two kernels that :func:`bf16_route`
picks by shape: for M <= 64 (decode) a skinny kernel that streams y's
K-major copy in 64-row slabs against x's rows, K split over a cluster of
up to 8 blocks whose f32 partials are summed in rank order (the same
bits on every run and stream); above it a persistent, warp-specialised
kernel on 128 x 192 tiles (:data:`TILES_BF16`) whose sums go into the
result every :data:`BF16_PROMOTE` chunks with round-to-nearest f32 adds.

:func:`matmul` chooses the kernel by dtype: float32 goes to the 3xTF32
kernel, bfloat16 to the bf16 one; on the card any other dtype raises.
None pads M or N to block multiples; the sources say what bounds them
and how.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import quantize
from repro_torch.kernels import _build, tune

# Compiled tiles of csrc/matmul.cu, (bm, bn, bk): 128 rows (two consumer
# warpgroups of 64) by 128 or 64 columns, K in 32-deep f32 chunks through
# a four-stage TMA ring.
TILES = ((128, 128, 32), (128, 64, 32))
ORDERS = ("mn", "nm")   # which tile index consecutive blocks walk: M or N
BK = 32           # K per ring stage: one 128-byte row of f32
STAGES = 4        # ring depth
N_ALIGN = 128     # the planes' N padding: a multiple of every tile's bn
K_ALIGN = 4       # TMA: x's rows must be 16-byte multiples

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
PLANES_LAUNCHES = 0   # the same for the y split pass (tf32_planes)
INT8_LAUNCHES = 0   # the same for matmul_int8


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of an f32 tile: per stage a bm x bk chunk of
    x and a bn x bk chunk of each of y's two planes, the mbarriers, 1 KB
    of alignment."""
    return STAGES * 4 * (bm + 2 * bn) * bk + 2 * STAGES * 8 + 1024


def _default(ctx: dict) -> dict:
    return {"bm": 128, "bn": 128 if ctx["n"] > 64 else 64, "bk": BK,
            "order": "mn"}


# ctx: {"m": rows, "n": cols, "k": inner}.  Hard limits: a compiled tile
# (whose ring, 193 KB at 128 x 128, fits the 227 KB a block may use) and
# a grid order the kernel knows.
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="matmul",
    params=("bm", "bn", "bk", "order"),
    candidates=lambda ctx: tuple(
        {"bm": bm, "bn": bn, "bk": bk, "order": order}
        for bm, bn, bk in TILES for order in ORDERS),
    valid=lambda cfg, ctx: ((cfg["bm"], cfg["bn"], cfg["bk"]) in TILES
                            and cfg["order"] in ORDERS
                            and smem_bytes(cfg["bm"], cfg["bn"], cfg["bk"])
                            <= tune.SMEM_BUDGET),
    default=_default,
))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tf32_split(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``f``: hi = f rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), its
    low 13 bits zero; lo = the same rounding of f − hi (exact in f32).
    |f − hi − lo| <= 2^-22 |f|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(f)
    return hi, rna(f - hi)


def planes_shape(k: int, n: int) -> tuple[int, int, int]:
    """(2, n_pad, k_pad) of y's TF32 planes for a (K, N) y."""
    return (2, _round_up(n, N_ALIGN), _round_up(k, BK))


def tf32_planes_plain(y: torch.Tensor) -> torch.Tensor:
    """The split pass in plain torch: (2, n_pad, k_pad) float32, y's hi
    then its lo TF32 part (:func:`tf32_split`), K-major ((N, K), the
    transpose of y), zero-padded to n_pad (a multiple of 128) and k_pad
    (a multiple of 32)."""
    k, n = y.shape
    out = torch.zeros(planes_shape(k, n), dtype=torch.float32,
                      device=y.device)
    hi, lo = tf32_split(y.to(torch.float32).t())
    out[0, :n, :k] = hi
    out[1, :n, :k] = lo
    return out


def tf32_planes(y: torch.Tensor) -> torch.Tensor:
    """y (K, N) float32 -> its TF32 planes, the kernel's B side
    (:func:`tf32_planes_plain`'s layout, equal bit for bit).

    A CPU tensor runs :func:`tf32_planes_plain`; a CUDA tensor launches
    the split pass on the current stream or raises."""
    if y.ndim != 2:
        raise ValueError(f"tf32_planes: y must be 2-D, got {tuple(y.shape)}")
    dev = y.device
    if dev.type == "cpu":
        return tf32_planes_plain(y)
    if dev.type != "cuda":
        raise ValueError(f"tf32_planes: no kernel for device {dev}")
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("tf32_planes: y must be contiguous float32")
    k, n = y.shape
    out = torch.empty(planes_shape(k, n), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return out.zero_()
    code = _build.lib().tina_tf32_planes(
        y.data_ptr(), out.data_ptr(), k, n, out.shape[1], out.shape[2],
        _build.stream(dev))
    global PLANES_LAUNCHES
    PLANES_LAUNCHES += 1
    _build.check(code, "tf32_planes")
    return out


def staging(x: torch.Tensor) -> str:
    """How the kernel reads x: ``"tma"`` straight from x when its rows
    are 16-byte aligned (K a multiple of 4 and an aligned start), else
    ``"padded_copy"``: x copied into rows zero-padded to a multiple of 4
    first."""
    return ("tma" if x.shape[-1] % K_ALIGN == 0 and x.data_ptr() % 16 == 0
            else "padded_copy")


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: x (M, K) @ y (K, N) in fp32
    (``torch.backends.cuda.matmul.allow_tf32`` must stay False)."""
    return x @ y


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           yt_planes: torch.Tensor | None = None,
           yt: torch.Tensor | None = None, bm: int | None = None,
           bn: int | None = None, bk: int | None = None,
           order: str = "mn") -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in x's dtype, the kernel chosen by
    dtype: float32 operands run the 3xTF32 kernel, bfloat16 ones the
    bf16 kernel.  ``yt_planes`` (float32): :func:`tf32_planes` of y;
    ``yt`` (bfloat16): y's K-major copy (N, K); each made once by a
    caller whose y is a constant, or None to make it here, per call.
    The tile (bm, bn, bk) defaults to the dtype's first compiled one.

    A CPU tensor runs :func:`matmul_bf16_plain` (both bfloat16) or
    :func:`matmul_plain`; a CUDA tensor launches the kernel on the
    current stream or raises."""
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    dev = x.device
    bf16 = x.dtype == torch.bfloat16 and y.dtype == torch.bfloat16
    if dev.type == "cpu":
        return matmul_bf16_plain(x, y) if bf16 else matmul_plain(x, y)
    if dev.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {dev}")
    if bf16:
        return _matmul_bf16(x, y, yt, bm, bn, bk, order)
    bm, bn, bk = (TILES[0][0] if bm is None else bm,
                  TILES[0][1] if bn is None else bn,
                  BK if bk is None else bk)
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"matmul: {name} must be float32 (or both x "
                            f"and y bfloat16), got {t.dtype}")
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
    if yt_planes is None:
        yt_planes = tf32_planes(y)
    if (yt_planes.dtype != torch.float32 or yt_planes.device != dev
            or not yt_planes.is_contiguous()
            or tuple(yt_planes.shape) != planes_shape(k, n)):
        raise ValueError(f"matmul: yt_planes {yt_planes.dtype}"
                         f"{tuple(yt_planes.shape)} on {yt_planes.device}, "
                         f"expected float32{planes_shape(k, n)} on {dev}, "
                         "contiguous")
    if staging(x) != "tma":
        xs = torch.zeros((m, _round_up(k, K_ALIGN)), dtype=x.dtype,
                         device=dev)
        xs[:, :k] = x
        x = xs
    code = _build.lib().tina_matmul(
        x.data_ptr(), x.shape[1], yt_planes.data_ptr(), yt_planes.shape[1],
        yt_planes.shape[2], out.data_ptr(), m, n, k, bm, bn, bk,
        int(order == "nm"), _build.stream(dev))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "matmul")
    return out


# -- bf16 ------------------------------------------------------------------
# The compiled tile of csrc/bf16_gemm.cu's tiled kernel (M > 64), (bm, bn,
# bk): 128 rows (two consumer warpgroups of 64) by 192 columns, K in
# 64-deep (128-byte) chunks through a four-stage TMA ring, persistent
# blocks; the sums of BF16_PROMOTE chunks at a time go into the result
# with round-to-nearest f32 adds.
BF16_BK = 64          # K per ring stage (both kernels): one 128-byte row
TILES_BF16 = ((128, 192, BF16_BK),)
BF16_PROMOTE = 3
BF16_K_ALIGN = 8      # TMA: rows of x and yt must be 16-byte multiples
BF16_LAUNCHES = 0     # kernel launches since the last reset (plain excluded)
# The skinny kernel (M <= 64): 64 columns of y a block against x's rows
# rounded up to one of BF16_SKINNY_ROWS, K split over a cluster of at
# most BF16_MAX_SPLITS blocks, the fewest splits that give a block to
# each of H100_SMS.  chip_smoke.py's lm phase sweeps the split count at
# olmo_1b's decode shapes: there fewer splits (a wave short of the SMs)
# are 3-9 % faster, ~0.07 ms of a decode step that the host bounds at
# 20-36 ms (PERF.md), and more are slower.  The rule stays a block a SM:
# it does not depend on the shape, and the sweep's per-shape optima come
# from three shapes of one model.
BF16_SKINNY_ROWS = (8, 16, 32, 64)
BF16_SKINNY_COLS = 64
BF16_MAX_SPLITS = 8
H100_SMS = 132        # SMs of an H100 SXM


def bf16_route(m: int, n: int, k: int) -> tuple[str, dict]:
    """Which bf16 kernel an (M, K) @ (K, N) product runs, and how:
    ``("skinny", {"rows", "splits", "chunks", "blocks"})`` for M <= 64:
    x's rows rounded up to ``rows``, K's 64-deep chunks cut into
    ``splits`` runs of ``chunks`` (the last may be shorter, none is
    empty), ``blocks`` in all; else ``("tiled", {"bm", "bn", "bk",
    "promote", "tiles"})``: the compiled tile, its promotion interval in
    chunks and the count of output tiles."""
    k_tiles = -(-k // BF16_BK)
    if m <= BF16_SKINNY_ROWS[-1]:
        rows = next(r for r in BF16_SKINNY_ROWS if r >= m)
        slabs = -(-n // BF16_SKINNY_COLS)
        splits = max(1, min(BF16_MAX_SPLITS, k_tiles,
                            -(-H100_SMS // slabs)))
        chunks = -(-k_tiles // splits)
        splits = -(-k_tiles // chunks)
        return "skinny", {"rows": rows, "splits": splits, "chunks": chunks,
                          "blocks": slabs * splits}
    bm, bn, bk = TILES_BF16[0]
    return "tiled", {"bm": bm, "bn": bn, "bk": bk, "promote": BF16_PROMOTE,
                     "tiles": -(-m // bm) * -(-n // bn)}


@functools.lru_cache(maxsize=256)
def _bf16_launch_args(m: int, n: int, k: int) -> tuple[int, int, int, int]:
    """:func:`bf16_route` as the C entry's (kind, width, splits, chunks),
    kept per shape: a model calls the same few shapes on every step."""
    kind, r = bf16_route(m, n, k)
    if kind == "skinny":
        return 0, r["rows"], r["splits"], r["chunks"]
    return 1, r["bn"], r["promote"], 0


def matmul_bf16_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's function in plain torch: x (M, K) @ y (K, N)
    with exact products summed in float32, rounded once to bfloat16
    (``torch.backends.cuda.matmul.allow_tf32`` must stay False)."""
    return (x.float() @ y.float()).to(torch.bfloat16)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              floor: float = 2.0 ** -8) -> torch.Tensor:
    """|got - want| in bf16 ulps of want (float32 tensors of the same
    shape), the ulp (2^(e - 7) for |want| in [2^e, 2^(e+1))) taken at
    max(|want|, floor * max|want|).  Two bf16 products that differ only
    in the order of their f32 sums round to values one ulp apart at
    most, except near zero: where a sum cancels, the f32 orders' own
    difference (~2^-24 sqrt(K) of the terms) can exceed a bf16 ulp of
    the element, and ``floor`` counts such elements in ulps of a value
    2^8 below the largest.  ``floor=0`` gives the ulps at |want|."""
    g, w = got.float(), want.float()
    ref = w.abs().clamp_min(floor * w.abs().max().item())
    ref = ref.clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
    return (g - w).abs() / ulp


def bf16_tile(bm: int | None = None, bn: int | None = None,
              bk: int | None = None, order: str = "mn") -> tuple:
    """(bm, bn, bk) of the bf16 tiled kernel, None filled from its
    compiled tile; ValueError on a tile it has not compiled or an order
    but "mn" (its blocks walk groups of M tiles).  The skinny kernel
    (M <= 64) has no tile to choose; the check holds for every call."""
    tile = tuple(d if v is None else int(v)
                 for v, d in zip((bm, bn, bk), TILES_BF16[0]))
    if tile not in TILES_BF16 or order != "mn":
        raise ValueError(f"matmul_bf16: invalid block config {tile} order "
                         f"{order!r}; compiled: {TILES_BF16}, order 'mn'")
    return tile


def _matmul_bf16(x: torch.Tensor, y: torch.Tensor, yt: torch.Tensor | None,
                 bm: int | None, bn: int | None, bk: int | None,
                 order: str) -> torch.Tensor:
    """:func:`matmul` for bfloat16 CUDA operands: launches the kernel."""
    bf16_tile(bm, bn, bk, order)
    m, k = x.shape
    n = y.shape[1]
    dev = x.device
    if yt is None:
        yt = y.t().contiguous()
    check_args("matmul", dev, x=(x, torch.bfloat16, (m, k)),
               yt=(yt, torch.bfloat16, (n, k)))
    if y.device != dev:
        raise ValueError(f"matmul: y on {y.device}, x on {dev}")
    out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    if (k % BF16_K_ALIGN or x.data_ptr() % 16 or yt.data_ptr() % 16):
        kp = -(-k // BF16_K_ALIGN) * BF16_K_ALIGN
        x, yt = pad_k(x, kp), pad_k(yt, kp)
    code = _build.lib().tina_matmul_bf16(
        x.data_ptr(), yt.data_ptr(), out.data_ptr(), m, n, x.shape[1],
        *_bf16_launch_args(m, n, x.shape[1]),
        _build.stream(dev))
    global BF16_LAUNCHES
    BF16_LAUNCHES += 1
    _build.check(code, "matmul_bf16")
    return out


# -- int8 ------------------------------------------------------------------
# The compiled tile of csrc/qmatmul.cu, (bm, bn, bk): 128 rows (two
# consumer warpgroups of 64) by 128 columns, K in 128-byte steps through
# a four-stage TMA ring.
TILES_INT8 = ((128, 128, 128),)
INT8_STAGES = 4
INT8_K_ALIGN = 16    # TMA: rows of xq and yt must be 16-byte multiples


def int8_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Dynamic shared memory of an int8 tile: per stage a bm x bk chunk
    of xq and a bn x bk chunk of yt, the mbarriers, 1 KB of alignment."""
    return INT8_STAGES * (bm + bn) * bk + 2 * INT8_STAGES * 8 + 1024


# ctx: {"m": rows, "n": cols, "k": inner}.  Hard limits: the compiled
# tile, whose ring (129 KB) fits the 227 KB of shared memory, and
# K <= MAX_INT8_K, so that K * 127^2 fits the int32 accumulator.
MAX_INT8_K = 0x7fffffff // (127 * 127)
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="matmul_int8",
    params=("bm", "bn", "bk"),
    candidates=lambda ctx: tuple({"bm": bm, "bn": bn, "bk": bk}
                                 for bm, bn, bk in TILES_INT8),
    valid=lambda cfg, ctx: ((cfg["bm"], cfg["bn"], cfg["bk"]) in TILES_INT8
                            and int8_smem_bytes(cfg["bm"], cfg["bn"],
                                                cfg["bk"]) <= tune.SMEM_BUDGET
                            and ctx["k"] <= MAX_INT8_K),
    default=lambda ctx: dict(zip(("bm", "bn", "bk"), TILES_INT8[0])),
))


def matmul_int8_plain(xq: torch.Tensor, yq: torch.Tensor, sx: torch.Tensor,
                      sy: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: the exact int32 product
    xq (M, K) @ yq (K, N), then ``(float(acc) * sx[m]) * sy[n]``."""
    acc = quantize.int8_dot(xq, yq).to(torch.float32)
    return acc * sx.reshape(-1, 1) * sy.reshape(1, -1)


def check_args(what: str, dev: torch.device, **tensors) -> None:
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


def int8_staging(xq: torch.Tensor, *bts: torch.Tensor) -> str:
    """How an int8 kernel reads its operands: ``"tma"`` straight from xq
    and the K-major B operands ``bts`` when K is a multiple of 16 and all
    start 16-byte aligned, else ``"padded_copy"``: all copied into rows
    zero-padded to a multiple of 16 first (zeros add nothing to an int32
    sum)."""
    ok = (xq.shape[1] % INT8_K_ALIGN == 0
          and all(t.data_ptr() % 16 == 0 for t in (xq, *bts)))
    return "tma" if ok else "padded_copy"


def pad_k(t: torch.Tensor, k: int) -> torch.Tensor:
    """t (rows, K) copied into zero-padded rows of k >= K columns."""
    out = torch.zeros((t.shape[0], k), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def matmul_int8(xq: torch.Tensor, yq: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor, *, yt: torch.Tensor | None = None,
                bm: int = 128, bn: int = 128, bk: int = 128) -> torch.Tensor:
    """int8 xq (M, K) @ int8 yq (K, N) with exact int32 accumulation;
    float32 out = (acc * sx[m]) * sy[n] with sx (M,), sy (N,) float32.
    ``yt``: yq's K-major copy (N, K), the tensor cores' B operand, where
    the caller made it once (yq a constant); None transposes yq here, per
    call.

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
    if yt is None:
        yt = yq.t().contiguous()
    check_args("matmul_int8", dev, xq=(xq, torch.int8, (m, k)),
               yq=(yq, torch.int8, (k, n)), yt=(yt, torch.int8, (n, k)),
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
    if int8_staging(xq, yt) != "tma":
        kp = -(-k // INT8_K_ALIGN) * INT8_K_ALIGN
        xq, yt = pad_k(xq, kp), pad_k(yt, kp)
    code = _build.lib().tina_matmul_int8(
        xq.data_ptr(), yt.data_ptr(), sx.data_ptr(), sy.data_ptr(),
        out.data_ptr(), m, n, xq.shape[1], bm, bn, bk,
        _build.stream(dev))
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "matmul_int8")
    return out


__all__ = ["matmul", "matmul_plain", "matmul_bf16_plain", "TILES_BF16",
           "BF16_LAUNCHES", "bf16_ulps", "bf16_tile", "bf16_route",
           "BF16_PROMOTE", "TUNE_SPACE", "TILES",
           "ORDERS", "LAUNCHES", "PLANES_LAUNCHES", "tf32_split", "tf32_planes",
           "tf32_planes_plain", "planes_shape", "staging", "smem_bytes",
           "matmul_int8", "matmul_int8_plain", "TUNE_SPACE_INT8",
           "TILES_INT8", "INT8_LAUNCHES", "MAX_INT8_K", "int8_staging",
           "int8_smem_bytes"]
