"""FIR kernel: TINA §4.3, the 'valid' cross-correlation of signal rows
with one tap vector.

The CUDA kernel is ``csrc/fir.cu`` (``tina_fir`` replaces the JAX
reference's ``kernels/fir.py:fir_valid``; the source says what bounds it
and how).  :func:`fir_valid` launches it for a CUDA tensor and runs
:func:`fir_valid_plain`, the same ascending-k sum in plain torch, for a
CPU tensor; the two agree bit for bit.  Unlike the TPU kernel there is
no halo rule (K − 1 ≤ bn) and no padded copy: a block stages the samples
its tile reads, and ``pad_left`` / ``pad_right`` zeros are implicit.
``flip`` reads the taps reversed as they are staged, so a true FIR needs
no reversed copy of its taps either.

:func:`fir_valid_int8` is the int8 tier's FIR: ``csrc/qfir.cu``
(``tina_fir_int8``) replaces the reference's ``kernels/fir.py:
fir_valid_int8``; it quantizes every window in the kernel and runs an
int32 MAC against int8 taps.  :func:`fir_valid_int8_plain` is the same
function in plain torch, equal bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantize
from repro_torch.kernels import _build, tune
from repro_torch.kernels import matmul as mm_kernel

TAP_CHUNK = 1024        # csrc/fir.cu: taps staged in shared memory at once
PER_THREAD = 8          # csrc/fir.cu: outputs per thread (V)

LAUNCHES = 0     # kernel launches since the last reset (plain runs excluded)
INT8_LAUNCHES = 0   # the same for fir_valid_int8


def smem_bytes(bn: int, k: int) -> int:
    """Dynamic shared memory one block asks for: a chunk of taps and the
    samples its ``bn`` outputs read (``csrc/fir.cu:launch``)."""
    kc = min(k, TAP_CHUNK)
    return 4 * (-(-kc // 8) * 8 + -(-(bn + kc + 8) // 4) * 4)


def _valid(cfg: dict, ctx: dict) -> bool:
    bn, threads = cfg["bn"], cfg["threads"]
    return (0 < threads <= tune.MAX_THREADS and threads % tune.WARP == 0
            and bn == threads * PER_THREAD
            and smem_bytes(bn, ctx["k"]) <= tune.SMEM_BUDGET)


# ctx: {"k": taps, "n": signal length, "rows": flattened batch rows}.  A
# block computes bn outputs of one row, bn / threads neighbouring outputs
# per thread (the compiled 8); the hard limits are those, the threads per
# block and the shared memory its taps and samples take.
TUNE_SPACE = tune.register(tune.TuneSpace(
    kernel="fir",
    params=("bn", "threads"),
    candidates=lambda ctx: tuple(
        {"bn": threads * PER_THREAD, "threads": threads}
        for threads in (128, 256)),
    valid=_valid,
    default=lambda ctx: {"bn": 2048, "threads": 256},
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
              threads: int = 256) -> torch.Tensor:
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
        torch.cuda.current_stream(dev).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    _build.check(code, "fir_valid")
    return out


# -- int8 ------------------------------------------------------------------
def int8_smem_bytes(bn: int, k: int) -> int:
    """Dynamic shared memory of one block of csrc/qfir.cu: the bn + K - 1
    samples its outputs read and the K taps widened to int."""
    return 4 * (bn + k - 1) + 4 * k


def _valid_int8(cfg: dict, ctx: dict) -> bool:
    bn, threads = cfg["bn"], cfg["threads"]
    return (0 < threads <= tune.MAX_THREADS and threads % tune.WARP == 0
            and bn > 0 and ctx["k"] <= mm_kernel.MAX_INT8_K
            and int8_smem_bytes(bn, ctx["k"]) <= tune.SMEM_BUDGET)


# ctx: {"k": taps, "n": signal length, "rows": flattened batch rows}.  A
# block owns bn outputs of one row, each thread every threads-th of them;
# the hard limits are the threads per block and the shared memory of the
# staged samples and taps (any K whose staging fits 227 KB).
TUNE_SPACE_INT8 = tune.register(tune.TuneSpace(
    kernel="fir_int8",
    params=("bn", "threads"),
    candidates=lambda ctx: tuple({"bn": bn, "threads": threads}
                                 for bn in (512, 1024, 2048)
                                 for threads in (128, 256)),
    valid=_valid_int8,
    default=lambda ctx: {"bn": 1024, "threads": 256},
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
                   bn: int = 1024, threads: int = 256) -> torch.Tensor:
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
    mm_kernel.check_int8_args(
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
        k, bn, threads, torch.cuda.current_stream(dev).cuda_stream)
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    _build.check(code, "fir_valid_int8")
    return out


__all__ = ["fir_valid", "fir_valid_plain", "TUNE_SPACE",
           "LAUNCHES", "TAP_CHUNK", "PER_THREAD", "smem_bytes",
           "fir_valid_int8", "fir_valid_int8_plain", "TUNE_SPACE_INT8",
           "INT8_LAUNCHES", "int8_smem_bytes"]
