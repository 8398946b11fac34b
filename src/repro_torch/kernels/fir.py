"""FIR kernel: TINA §4.3, the 'valid' cross-correlation of signal rows
with one tap vector.

The CUDA kernel is ``csrc/fir.cu`` (``tina_fir`` replaces the JAX
reference's ``kernels/fir.py:fir_valid``; the source says what bounds it
and how).  :func:`fir_valid` launches it for a CUDA tensor and runs
:func:`fir_valid_plain`, the same ascending-k sum in plain torch, for a
CPU tensor; the two agree bit for bit.  Unlike the TPU kernel there is
no halo rule (K − 1 ≤ bn) and no padded copy: a block stages the samples
each of its tiles reads, and ``pad_left`` / ``pad_right`` zeros are
implicit.  :func:`smem_bytes` and :func:`tile_span` describe the
kernel's ring and staged spans as ``csrc/fir.cu`` computes them.
``flip`` reads the taps reversed as they are staged, so a true FIR needs
no reversed copy of its taps either.

:func:`fir_valid_int8` is the int8 tier's FIR: ``csrc/qfir.cu``
(``tina_fir_int8``) replaces the reference's ``kernels/fir.py:
fir_valid_int8``; it quantizes every window in the kernel and runs an
int32 MAC against int8 taps.  :func:`fir_valid_int8_plain` is the same
function in plain torch, equal bit for bit.  :func:`quantize_check`
runs the check-only ``csrc/qcheck.cu``: the kernels' quantize against
the division it replaces, on every float of a scale.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantize
from repro_torch.kernels import _build, tune
from repro_torch.kernels import matmul as mm_kernel

TAP_CHUNK = 1024    # csrc/fir.cu: taps of one job (a tile's K in chunks)
STAGES = 3          # csrc/fir.cu: staged spans in a block's ring
THREADS = (128, 256)   # csrc/fir.cu: threads a block (compiled)

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
INT8_LAUNCHES = 0   # the same for fir_valid_int8


def _round4(a: int) -> int:
    return -(-a // 4) * 4


def smem_bytes(bn: int, k: int) -> int:
    """Dynamic shared memory one block asks for (``csrc/fir.cu:launch``):
    ``STAGES`` stages, each a chunk's taps (K rounded up to 4, at most
    TAP_CHUNK) and the samples a tile of ``bn`` outputs reads, bn + K
    rounded up to 4 + 8 (the 0-3 sample lead and the window's float4
    loaded a step ahead)."""
    kc = _round4(min(k, TAP_CHUNK))
    return 4 * STAGES * (2 * kc + bn + 8)


def tile_span(t0: int, k0: int, kc: int, pad_left: int, bn: int,
              x_start: int) -> tuple[int, int, int]:
    """(a, pa, staged) of the job that runs taps k0 .. k0 + kc - 1 over
    the tile of ``bn`` outputs from ``t0``, as ``csrc/fir.cu:job_at`` and
    ``stage_job`` compute them: the lead ``a`` of its first sample from a
    16-byte boundary, the row position ``pa`` of staged sample 0 and the
    ``staged`` samples.  ``x_start`` is the floats by which the row
    starts past a 16-byte boundary."""
    p0 = t0 + k0 - pad_left
    a = (x_start + p0) % 4
    return a, p0 - a, bn + _round4(kc) + 8


def _valid(cfg: dict, ctx: dict) -> bool:
    bn, threads = cfg["bn"], cfg["threads"]
    return (threads in THREADS and bn == 16 * threads
            and smem_bytes(bn, ctx["k"]) <= tune.SMEM_BUDGET)


# ctx: {"k": taps, "n": signal length, "rows": flattened batch rows}.  A
# block of 128 or 256 threads computes tiles of bn = 16 threads outputs
# (four quads of four a thread): two compiled tiles; the shared memory of
# its three-stage ring fits any K.  The default, 2048 outputs on 128
# threads, measured fastest at K = 15, 31 and 63 at the fir_decimate and
# correlate widths (chip_smoke.py's fir_*_ms_per_tile).
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="fir",
    params=("bn", "threads"),
    candidates=lambda ctx: tuple(
        {"bn": 16 * threads, "threads": threads} for threads in THREADS),
    valid=_valid,
    default=lambda ctx: {"bn": 2048, "threads": 128},
))


def fir_valid_plain(x: torch.Tensor, kern: torch.Tensor, *,
                    pad_left: int = 0, pad_right: int = 0,
                    flip: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: from zero, one multiply
    and one add per tap in ascending k over the implicitly padded rows,
    with the taps reversed first for ``flip``."""
    if flip:
        kern = kern.flip(0)
    k = kern.shape[0]
    xp = torch.nn.functional.pad(x, (pad_left, pad_right))
    nout = xp.shape[-1] - k + 1
    acc = torch.zeros(x.shape[:-1] + (nout,), dtype=x.dtype, device=x.device)
    for i in range(k):
        acc = acc + xp[..., i:i + nout] * kern[i]
    return acc


def fir_valid(x: torch.Tensor, kern: torch.Tensor, *, pad_left: int = 0,
              pad_right: int = 0, flip: bool = False, bn: int = 2048,
              threads: int = 128) -> torch.Tensor:
    """x (R, N), kern (K,) -> (R, N + pad_left + pad_right − K + 1):
    out[r, t] = Σ_k xp[r, t + k]·h[k], xp the row between pad_left and
    pad_right zeros, h = kern, or kern reversed for ``flip`` (a true
    convolution).

    A CPU tensor runs :func:`fir_valid_plain`; a CUDA tensor launches the
    kernel on the current stream or raises."""
    rows, n = x.shape
    k = kern.shape[0]
    if kern.ndim != 1 or pad_left < 0 or pad_right < 0 \
            or n + pad_left + pad_right < k:
        raise ValueError(f"fir_valid: taps {tuple(kern.shape)} and pads "
                         f"({pad_left}, {pad_right}) do not fit a row of {n}")
    dev = x.device
    if dev.type == "cpu":
        return fir_valid_plain(x, kern, pad_left=pad_left,
                               pad_right=pad_right, flip=flip)
    if dev.type != "cuda":
        raise ValueError(f"fir_valid: no kernel for device {dev}")
    for name, t in (("x", x), ("kern", kern)):
        if t.dtype != torch.float32:
            raise TypeError(f"fir_valid: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"fir_valid: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"fir_valid: {name} must be contiguous")
    if not _valid({"bn": bn, "threads": threads}, {"k": k}):
        raise ValueError(f"fir_valid: bn={bn} threads={threads} is no "
                         f"compiled tile")
    out = torch.empty((rows, n + pad_left + pad_right - k + 1), device=dev,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    code = _build.lib().tina_fir(
        x.data_ptr(), kern.data_ptr(), out.data_ptr(), rows, n, k, pad_left,
        pad_right, int(flip), bn, threads,
        _build.stream(dev))
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "fir_valid")
    return out


# -- int8 ------------------------------------------------------------------
def int8_smem_bytes(bn: int, k: int) -> int:
    """Dynamic shared memory of one block of csrc/qfir.cu: the bn + K4
    samples its outputs read (K4: K rounded up to 4), its bn outputs on
    their way out, and the taps packed four to a word, K4 bytes."""
    k4 = -(-k // 4) * 4
    return 4 * (2 * bn + k4) + k4


def _valid_int8(cfg: dict, ctx: dict) -> bool:
    bn, threads = cfg["bn"], cfg["threads"]
    return (0 < threads <= tune.MAX_THREADS and threads % tune.WARP == 0
            and bn > 0 and bn % 4 == 0 and ctx["k"] <= mm_kernel.MAX_INT8_K
            and int8_smem_bytes(bn, ctx["k"]) <= tune.SMEM_BUDGET)


# ctx: {"k": taps, "n": signal length, "rows": flattened batch rows}.  A
# block owns bn outputs of one row, each thread four neighbouring ones at
# a time; the hard limits are bn a multiple of 4, the threads per block
# and the shared memory of the staged samples, outputs and taps (any K
# whose staging fits 227 KB).  The default, 1024 outputs on 128 threads
# (two quads a thread), measured fastest or next to it at K = 15, 31 and
# 63 at the fir_decimate and correlate widths (chip_smoke.py's
# *_ms_per_tile).
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="fir_int8",
    params=("bn", "threads"),
    candidates=lambda ctx: tuple({"bn": bn, "threads": threads}
                                 for bn in (512, 1024, 2048)
                                 for threads in (128, 256)),
    valid=_valid_int8,
    default=lambda ctx: {"bn": 1024, "threads": 128},
))


def fir_valid_int8_plain(x: torch.Tensor, tq: torch.Tensor,
                         ts: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: each window x[:, t:t+K]
    quantized on its own (the amax over its K samples, a tap at a time),
    an exact int32 sum against the int8 taps, then ``(acc * s) * ts`` --
    quantize.qfir's decisions and arithmetic without the unfolded copy."""
    k = tq.shape[0]
    nout = x.shape[-1] - k + 1
    amax = x[..., :nout].abs()
    for i in range(1, k):
        amax = torch.maximum(amax, x[..., i:i + nout].abs())
    scale = quantize.scale_of(amax)
    acc = torch.zeros(amax.shape, dtype=torch.int32, device=x.device)
    for i in range(k):
        acc += (quantize.quantize_with(x[..., i:i + nout], scale)
                .to(torch.int32) * tq[i].to(torch.int32))
    return acc.to(torch.float32) * scale * ts.reshape(-1)


def fir_valid_int8(x: torch.Tensor, tq: torch.Tensor, ts: torch.Tensor, *,
                   bn: int = 1024, threads: int = 128) -> torch.Tensor:
    """x (R, N) float32; tq (K,) int8 taps as quantize_fir_taps packs them
    (already reversed for a true FIR); ts (1,) float32 their scale ->
    float32 (R, N - K + 1), every window quantized on its own.

    A CPU tensor runs :func:`fir_valid_int8_plain`; a CUDA tensor
    launches the kernel on the current stream or raises."""
    if x.ndim != 2 or tq.ndim != 1 or not 0 < tq.shape[0] <= x.shape[1]:
        raise ValueError(f"fir_valid_int8: taps {tuple(tq.shape)} do not "
                         f"fit rows {tuple(x.shape)}")
    rows, n = x.shape
    k = tq.shape[0]
    dev = x.device
    if dev.type == "cpu":
        return fir_valid_int8_plain(x, tq, ts)
    if dev.type != "cuda":
        raise ValueError(f"fir_valid_int8: no kernel for device {dev}")
    mm_kernel.check_args(
        "fir_valid_int8", dev, x=(x, torch.float32, (rows, n)),
        tq=(tq, torch.int8, (k,)), ts=(ts, torch.float32, (1,)))
    if not _valid_int8({"bn": bn, "threads": threads}, {"k": k}):
        raise ValueError(f"fir_valid_int8: bn={bn} threads={threads} at "
                         f"K={k} does not fit the kernel (shared memory "
                         f"{int8_smem_bytes(bn, k)} B of "
                         f"{tune.SMEM_BUDGET})")
    out = torch.empty((rows, n - k + 1), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    code = _build.lib().tina_fir_int8(
        x.data_ptr(), tq.data_ptr(), ts.data_ptr(), out.data_ptr(), rows, n,
        k, bn, threads, _build.stream(dev))
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "fir_valid_int8")
    return out


def quantize_check(amax: torch.Tensor) -> torch.Tensor:
    """The check-only kernel of ``csrc/qcheck.cu``, called by no plan: for
    each amax (a CUDA float32 vector, each finite and >= 0) the count of
    float32 x in [-amax, amax] whose ``int8.cuh:quantize_rcp`` int
    differs from the division's, clip(rint(x / s), ±127), s = scale_of
    (amax).  Every such x is tried, so a count of 0 proves the two equal
    at that scale.  Returns int64 counts on the card; raises for a CPU
    tensor: its plain version would try some 2**31 values per scale."""
    if amax.device.type != "cuda":
        raise ValueError(f"quantize_check: needs a CUDA tensor, got "
                         f"{amax.device}")
    if amax.dtype != torch.float32 or amax.ndim != 1 \
            or not amax.is_contiguous():
        raise ValueError("quantize_check: amax must be a contiguous float32 "
                         "vector")
    if not bool(torch.isfinite(amax).all()) or bool((amax < 0).any()):
        raise ValueError("quantize_check: every amax must be finite and "
                         ">= 0")
    diffs = torch.zeros(amax.shape, dtype=torch.int64, device=amax.device)
    # 1056 block columns: eight 256-thread blocks on each of an H100's
    # 132 SMs, walking the floats of each amax with a grid stride
    code = _build.lib().tina_quantize_check(
        amax.data_ptr(), diffs.data_ptr(), amax.numel(), 1056,
        _build.stream(amax.device))
    _build.check(code, "quantize_check")
    return diffs


def quantize_check_pairs(amax: torch.Tensor) -> int:
    """The (x, amax) pairs :func:`quantize_check` tries: for each amax,
    every float32 in [-amax, amax], both zeros counted."""
    bits = amax.cpu().contiguous().view(torch.int32).to(torch.int64)
    return int((2 * (bits + 1)).sum())


__all__ = ["fir_valid", "fir_valid_plain", "TUNE_SPACE",
           "LAUNCHES", "TAP_CHUNK", "STAGES", "THREADS", "smem_bytes",
           "tile_span",
           "fir_valid_int8", "fir_valid_int8_plain", "TUNE_SPACE_INT8",
           "INT8_LAUNCHES", "int8_smem_bytes", "quantize_check",
           "quantize_check_pairs"]
