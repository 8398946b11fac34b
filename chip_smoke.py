#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port: builds its kernels, holds each
against its plain torch version, and drives the ``pfb_power``,
``stft_overlap_add``, ``spectrogram``, ``fir_decimate``, ``correlate``
and ``cascaded_channelizer`` pipelines, the Table-1 op sweep and a
4096-cubed matmul end to end on one NVIDIA card, at f32, then at int8
and bf16.

    python3 chip_smoke.py            # from the root of a checkout

Prints one JSON line per phase:

  card      the card's name and power limit (``nvidia-smi``), versions
  build     seconds spent building ``src/repro_torch/csrc/*.cu`` with nvcc
  kernel    each kernel against its plain version at ragged shapes
            (PFB and DFT: max|diff| <= 1e-4 * max|plain|, fp32 sums
            taken in another order; matmul the same, at the JAX suite's
            shapes, every compiled tile and both grid orders; chain
            (complex and real abs2 heads), binary, unfold, overlap-add
            and FIR: exact equality -- the FIR at K = 1 to 4097, with
            implicit padding, with the taps as given and reversed
            (``flip``), and on strided rows)
  main      each pipeline through ``graph.compile(..., lowering=
            "kernel")`` then ``plan(x)``: ``pfb_power`` at the paper's
            Fig. 3 point and at full width (16 x 2**22 samples, P = 1024,
            M = 8); ``stft_overlap_add`` at full width (4 x 2**20
            samples, J = 1024, hop 512); ``spectrogram`` at its registered
            width (8 x 2**16 samples, J = 64); ``fir_decimate`` (31 and
            15 taps) and ``correlate`` (63-tap template) at 16 x 2**22;
            ``cascaded_channelizer`` (31 taps, P = 16, M = 4) at
            16 x 4,194,333; ``matmul`` 4096 x 4096 @ 4096 x 4096 as a
            one-node plan.  For each: launch counts per call (every count
            set to 0 just before the call, read just after), agreement
            with the native plan (1e-4 of its max) and with the numpy
            oracle on batch row 0 (2e-3 of its max), each kernel held
            against its plain version at the shape the path gives it (the
            kernel phase's tolerances), median times of 20 calls of the
            plan, the native plan, each kernel alone at the shape the
            path gives it, its plain version, and the one PyTorch call
            that computes the same function (``F.conv1d`` without TF32
            for the FIR, ``torch.matmul``, ``torch.add``; timed here
            only, the port never calls them); ``fir_decimate``'s first
            FIR and the matmul also at every tile of their tune spaces.
            Path ``table1``: every row of the Table-1 registry at the
            ``kernel`` lowering (its one lowering for ``summation``) on
            the row's own inputs at size 2048, with the launches of that
            call, each kernel that call launched run again on the same
            inputs and held against its plain version (the kernel
            phase's tolerances), the row against its native single-node
            plan on the card (1e-4 of its max), the numpy oracle (|diff|
            <= 2e-3 + 2e-3 |oracle|) and its kernel single-node plan
            (1e-5 + 1e-5 |eager|); once every row passed, the median
            times of both plans and the device times of each kernel and
            its plain version on the row's inputs
  int8_kernels  the four int8 kernels against their plain versions, bit
            for bit: ragged M, N, K (K < 4, K % 4 != 0), every compiled
            tile, rows not 4-byte aligned, +-127 operands at K = 2048
            against an int64 sum, the int8 DFM both ways, K = 1 to 4097
            taps both orientations, P = 16, 20, 48 and 1024, and inputs
            whose x / scale quotients are exact half-integers
  int8_main ``pfb_power`` at ``precision="int8"``, kernel lowering, full
            width: node precisions and the abs2 downgrade, launches per
            call (pfb_fused_int8 1, chain 1), the whole output against
            the int8 native plan bit for bit, row 0's SQNR against the
            numpy oracle (>= 26 dB, the pfb int8 budget), the kernel and
            the chain held against their plain versions, times of the
            plan, the native plan, the kernel (each compiled tile) and
            its plain version, and its bound (int8 ops at 1,979 TOPS or
            bytes at 3.35 TB/s)
  int8_paths  the other five pipelines at int8 at their cells' widths,
            the int8 Table-1 rows (one-node plans, each against its int8
            native plan and its op's SQNR budget) and a 4096-cubed int8
            matmul: launches, rows 0-1 against the int8 native plan for
            two rows (bit for bit; 2 ulp of max allowed where a complex
            idft recombines), row 0's SQNR (asserted for spectrogram and
            matmul, printed for the rest), each int8 kernel held against
            its plain version at the path's shapes, times, bounds and the
            ``torch._int_mm`` yardstick of the int8 contraction alone
  bf16      ``pfb_power`` at ``precision="bf16"``, kernel lowering, full
            width: launches, SQNR of row 0 (>= 30 dB), plan times
  kernels   the kernel table, all 13 TPU kernels: launches, errors,
            times, bounds

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; without CUDA, or outside a checkout, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 bytes/s and
# fp32 FMA-pipe flop/s (no tensor cores: the kernels run full fp32).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12    # dense int8 tensor-core ops/s (a MAC is 2)
REPEATS = 20
SPIN_CYCLES = 20_000_000   # ~10 ms of GPU clock: covers a run's enqueue
PFB_RTOL = 1e-4       # fp32 sums of P*M terms in another order
DFT_RTOL = 1e-4       # fp32 sums of n terms in another order
NATIVE_RTOL = 1e-4    # kernel plan vs native plan on the card
ORACLE_RTOL = 2e-3    # the reference suite's pipeline-vs-oracle tolerance
MM_RTOL = 1e-4        # fp32 sums of K terms in another order
SWEEP_TOL = 2e-3      # Table-1 row vs numpy oracle (tests/test_opdefs.py)
PLAN_TOL = 1e-5       # Table-1 row eager vs its single-node plan
STFT_J, STFT_HOP, STFT_X = 1024, 512, (4, 2 ** 20)
SPEC_J, SPEC_X = 64, (8, 2 ** 16)
FIR_X = (16, 2 ** 22)
CHAN_X = (16, 4_194_333)     # pipelines._chan_len(2 ** 22, 31, 16, 4)
MM_N = 4096
SWEEP_N = 2048


T0 = time.perf_counter()


def emit(**kv) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({**kv, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def median_ms(torch, fn, repeats: int = REPEATS) -> float:
    """Median of ``repeats`` calls, each timed with CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, repeats: int = REPEATS) -> float:
    """Device time of one call: a run of ``repeats`` back-to-back calls
    between two CUDA events, over the count, after two warm-up calls.  A
    spin kernel queued first keeps the card busy while the host enqueues
    the run, so the host's dispatch time opens no gaps between calls
    (for a kernel of tens of microseconds it would otherwise dominate)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max|got - want|, max|want|) over real views of both."""
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    return ((got - want).abs().max().item(), want.abs().max().item())


def pfb_cost(b, t, p, n, m) -> tuple[int, int]:
    """(bytes, flops) the fused PFB must move and do: frames, taps and
    F read once, complex output written once; FIR + two real products."""
    tout = t - m + 1
    nbytes = 4 * (b * t * p + m * p + 2 * p * n) + 8 * b * tout * n
    flops = 2 * m * b * tout * p + 4 * b * tout * p * n
    return nbytes, flops


def dft_cost(b, l, n, cplx) -> tuple[int, int]:
    """(bytes, flops) of one 4mult DFT of b rows: x, fr and fi read once,
    complex64 out written once; two real products for a real x, four for
    a complex one."""
    nbytes = (8 if cplx else 4) * b * l + 8 * l * n + 8 * b * n
    return nbytes, 2 * (4 if cplx else 2) * b * l * n


def fir_cost(rows, n_in, n_out, k) -> tuple[int, int]:
    """(bytes, flops) of one 'valid' FIR: the rows and the taps read once,
    the output written once; a multiply and an add per tap and output."""
    return 4 * (rows * n_in + k + rows * n_out), 2 * k * rows * n_out


def bound(nbytes: int, flops: int, peak: float = PEAK_F32_FLOPS
          ) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def bound8(nbytes: int, ops: int) -> tuple[float, str]:
    """The bound of an int8 kernel: its int8 multiply-adds (2 ops each)
    at the int8 tensor-core peak, or its bytes."""
    return bound(nbytes, ops, PEAK_INT8_OPS)


def qgemm_cost(m, k, n, planes=1) -> tuple[int, int]:
    """(bytes, ops) of an int8 GEMM: xq, the int8 matrices and the f32
    scales read once, f32 (complex64 for two planes) written once."""
    nbytes = m * k + planes * k * n + 4 * (m + planes * n) \
        + 4 * planes * m * n
    return nbytes, 2 * planes * m * k * n


def qfir_cost(rows, n_in, n_out, k) -> tuple[int, int]:
    """(bytes, ops) of one int8 FIR: f32 rows, int8 taps and their scale
    read once, f32 output written once; a MAC per tap and output."""
    return 4 * rows * n_in + k + 4 + 4 * rows * n_out, 2 * k * rows * n_out


def qpfb_cost(b, t, p, n, m) -> tuple[int, int]:
    """(bytes, ops) of the fused int8 PFB: frames, taps, scales and the
    int8 DFM read once, complex64 written once; the frontend's M MACs per
    (frame, branch) and the DFT's two P-deep MACs per output bin."""
    tout = t - m + 1
    nbytes = 4 * b * t * p + m * p + 4 * p + 2 * p * n + 8 * n \
        + 8 * b * tout * n
    return nbytes, 2 * m * b * tout * p + 4 * b * tout * p * n


def add_cost(*costs) -> tuple[int, int]:
    return (sum(c[0] for c in costs), sum(c[1] for c in costs))


def hold(torch, what, got, want, rtol=None) -> float:
    """Hold a kernel's output against its plain version on the same
    inputs, a slice of dim 0 at a time (the full-width unfold output is
    17 GB: a whole difference would not fit beside it).  ``rtol`` None:
    bit-exact; else max|diff| <= rtol * max|plain|.  Fails otherwise;
    returns max|diff|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
             f"{want.dtype}{tuple(want.shape)}")
    step = max(1, (1 << 28) // max(1, got[0].numel()))
    err = scale = 0.0
    exact = True
    for g, w in zip(got.split(step), want.split(step)):
        e, s = rel_err(torch, g, w)
        err, scale = max(err, e), max(scale, s)
        exact = exact and torch.equal(g, w)
    if rtol is None and not exact:
        fail(f"{what}: not bit-identical to plain (max |diff| {err})")
    if rtol is not None and not err <= rtol * scale:
        fail(f"{what}: {err} > {rtol} * {scale}")
    return err


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: run from the root of a checkout: "
              f"{SRC / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    from repro_torch import graph
    from repro_torch.core import functions, opdefs, quantize
    from repro_torch.core.blocks import fp32_convs
    from repro_torch.core.pfb import pfb_window
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import dft as dftk
    from repro_torch.kernels import elementwise as ew
    from repro_torch.kernels import fir as firk
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import pfb as pfbk
    from repro_torch.kernels import unfold as unfk

    def zero_counts() -> None:
        pfbk.LAUNCHES = ew.LAUNCHES = ew.BINARY_LAUNCHES = 0
        dftk.LAUNCHES = unfk.LAUNCHES = unfk.OLA_LAUNCHES = 0
        firk.LAUNCHES = mmk.LAUNCHES = 0
        mmk.INT8_LAUNCHES = dftk.INT8_LAUNCHES = 0
        firk.INT8_LAUNCHES = pfbk.INT8_LAUNCHES = 0

    def counts() -> dict:
        return {"pfb_fused": pfbk.LAUNCHES, "elementwise_chain": ew.LAUNCHES,
                "elementwise_binary": ew.BINARY_LAUNCHES,
                "dft": dftk.LAUNCHES, "unfold": unfk.LAUNCHES,
                "overlap_add": unfk.OLA_LAUNCHES, "fir_valid": firk.LAUNCHES,
                "matmul": mmk.LAUNCHES, "matmul_int8": mmk.INT8_LAUNCHES,
                "dft_int8": dftk.INT8_LAUNCHES,
                "fir_valid_int8": firk.INT8_LAUNCHES,
                "pfb_fused_int8": pfbk.INT8_LAUNCHES}

    # -- card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is True: the plain fp32 "
             "yardstick would run in TF32")
    emit(phase="card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0])
    dev = torch.device("cuda")

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.BUILD_INFO.get("seconds"),
         cached=_build.BUILD_INFO.get("cached"),
         sources=[str(s.relative_to(ROOT)) for s in _build.sources()])

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, dtype=dtype, generator=gen)

    # -- kernels against their plain versions, ragged shapes -----------------
    # Tout never a tile multiple; P below and above the 16-branch chunk;
    # taps longer than a tile; taps needing > 48 KB of shared memory
    pfb_cases = [(2, 301, 16, 4), (1, 203, 32, 8), (3, 130, 48, 16),
                 (2, 517, 1024, 8), (1, 300, 16, 100), (1, 700, 16, 600)]
    for i, (b, t, p, m) in enumerate(pfb_cases):
        default = ops._resolve(pfbk.TUNE_SPACE, {"m": m, "p": p, "t": t})
        tiles = pfbk.TILES if i == 1 else ((default["bt"], default["bn"]),)
        for bt, bn in tiles:
            x, taps = randn(b, t, p), randn(m, p)
            fr, fi = ops._fourier(p, str(dev))
            for f_im in (fi, None):
                got = pfbk.pfb_fused(x, taps, fr, f_im, bt=bt, bn=bn)
                torch.cuda.synchronize()
                want = pfbk.pfb_fused_plain(x, taps, fr, f_im)
                err, scale = rel_err(torch, got, want)
                ok = err <= PFB_RTOL * scale
                emit(phase="kernel", kernel="pfb_fused", shape=[b, t, p, m],
                     tile=[bt, bn], complex_out=f_im is not None,
                     max_abs_err=err, max_abs_plain=scale, ok=ok)
                if not ok:
                    fail(f"pfb_fused {(b, t, p, m)} tile {(bt, bn)}: "
                         f"{err} > {PFB_RTOL} * {scale}")
    z, a, c = randn(3, 1001, 33, dtype=torch.complex64), randn(3, 1001, 33), \
        randn(3, 1001, 33)
    for head, operands, steps, abs2_head in (
            (z, (), (), True), (z, (), (("scale", 0.37),), True),
            (a, (), (), True), (a, (), (("scale", 0.37),), True),
            (a, (c, a), (("mul",), ("add",), ("scale", 1.7)), False)):
        got = ew.elementwise_chain(head, operands, steps, abs2_head=abs2_head)
        torch.cuda.synchronize()
        want = ew.elementwise_chain_plain(head, operands, steps,
                                          abs2_head=abs2_head)
        err, _ = rel_err(torch, got, want)
        ok = torch.equal(got, want)
        emit(phase="kernel", kernel="elementwise_chain",
             steps=[list(s) for s in steps], abs2_head=abs2_head,
             head=str(head.dtype), max_abs_err=err, exact=ok)
        if not ok:
            fail(f"elementwise_chain {steps}: not bit-identical to plain "
                 f"(max |diff| {err})")

    # unfold, overlap-add and binary: exact copies and one-rounding sums
    for rows, n, j in ((3, 1000, 1), (3, 1000, 7), (3, 1000, 64),
                       (2, 5000, 4096)):
        x = randn(rows, n)
        got = ops.unfold(x, j)
        torch.cuda.synchronize()
        want = unfk.unfold_plain(x, j)
        ok = torch.equal(got, want)
        emit(phase="kernel", kernel="unfold", shape=[rows, n], window=j,
             max_abs_err=rel_err(torch, got, want)[0], exact=ok)
        if not ok:
            fail(f"unfold {(rows, n)} J={j}: not equal to plain")
    for shape, hop in (((2, 37, 64), 64), ((2, 37, 64), 32),
                       ((2, 37, 64), 16), ((2, 37, 64), 8),
                       ((2, 8, 64), 8), ((1, 2047, 1024), 512)):
        frames = randn(*shape)
        got = ops.overlap_add(frames, hop)
        torch.cuda.synchronize()
        want = unfk.overlap_add_plain(frames, hop)
        ok = torch.equal(got, want)
        emit(phase="kernel", kernel="overlap_add", shape=list(shape),
             hop=hop, max_abs_err=rel_err(torch, got, want)[0], exact=ok)
        if not ok:
            fail(f"overlap_add {shape} hop={hop}: not equal to plain")
    xb = randn(3, 1001, 33)
    for op, fn in (("mul", ops.elementwise_mult),
                   ("add", ops.elementwise_add)):
        for y in (randn(3, 1001, 33), randn(33)):
            got = fn(xb, y)
            torch.cuda.synchronize()
            want = ew.elementwise_binary_plain(xb, y, op)
            ok = torch.equal(got, want)
            emit(phase="kernel", kernel="elementwise_binary", op=op,
                 y=list(y.shape), max_abs_err=rel_err(torch, got, want)[0],
                 exact=ok)
            if not ok:
                fail(f"elementwise_{op} y {tuple(y.shape)}: not bit-"
                     "identical to plain")
    # DFT: every ragged case, both variants, real and complex, both ways
    for rows in (1, 37, 8188):
        for n in (7, 64, 1024):
            worst = 0.0
            for cplx in (False, True):
                x = randn(rows, n,
                          dtype=torch.complex64 if cplx else torch.float32)
                for inverse in (False, True):
                    fr, fi = functions._dfm_tensors(n, inverse,
                                                    torch.float32, str(dev))
                    for variant in dftk.VARIANTS:
                        got = ops.dft(x, fr, fi, variant=variant)
                        torch.cuda.synchronize()
                        want = dftk.dft_plain(x, fr, fi, variant)
                        err, scale = rel_err(torch, got, want)
                        worst = max(worst, err / scale)
                        if err > DFT_RTOL * scale:
                            fail(f"dft rows={rows} n={n} complex={cplx} "
                                 f"inverse={inverse} {variant}: {err} > "
                                 f"{DFT_RTOL} * {scale}")
            emit(phase="kernel", kernel="dft", rows=rows, n=n,
                 cases="real+complex x forward+inverse x 4mult+3mult",
                 max_rel_err=worst, ok=True)
    # FIR: the plain version's ascending-k sum, bit for bit; K = 1 to more
    # than a tap chunk, ragged rows and lengths, implicit 'same'/'full'
    # pads, taps as given and reversed (flip)
    for rows, n, k in ((3, 1000, 1), (2, 999, 8), (5, 4099, 15),
                       (1, 70001, 31), (7, 3000, 63), (2, 5003, 129),
                       (2, 9001, 4097)):
        x, kern = randn(rows, n), randn(k)
        for pads in ((0, 0), (k // 2, (k - 1) // 2), (k - 1, k - 1)):
            for flip in (False, True):
                got = firk.fir_valid(x, kern, pad_left=pads[0],
                                     pad_right=pads[1], flip=flip)
                torch.cuda.synchronize()
                want = firk.fir_valid_plain(x, kern, pad_left=pads[0],
                                            pad_right=pads[1], flip=flip)
                ok = torch.equal(got, want)
                emit(phase="kernel", kernel="fir_valid", shape=[rows, n],
                     k=k, pads=list(pads), flip=flip,
                     max_abs_err=rel_err(torch, got, want)[0], exact=ok)
                if not ok:
                    fail(f"fir_valid {(rows, n)} K={k} pads {pads} flip "
                         f"{flip}: not bit-identical to plain")
    xs, kern = randn(6, 5001)[::2], randn(31)       # strided rows
    for cfg in firk.TUNE_SPACE.configs({"k": 31}):
        got = ops.fir(xs, kern, pad_left=15, pad_right=15, flip=True, **cfg)
        torch.cuda.synchronize()
        want = firk.fir_valid_plain(xs.contiguous(), kern, pad_left=15,
                                    pad_right=15, flip=True)
        ok = torch.equal(got, want)
        emit(phase="kernel", kernel="fir_valid", shape=list(xs.shape),
             strided=True, tile=cfg, max_abs_err=rel_err(torch, got, want)[0],
             exact=ok)
        if not ok:
            fail(f"fir_valid strided rows tile {cfg}: not bit-identical")
    # matmul: the JAX suite's shapes (m, l, n), batched, every tile x order
    for xs_shape, ys_shape in (((1, 1), (1, 1)), ((257, 129), (129, 255)),
                               ((300, 100), (100, 50)),
                               ((3, 5, 40, 24), (24, 17))):
        x, y = randn(*xs_shape), randn(*ys_shape)
        want = mmk.matmul_plain(x.reshape(-1, xs_shape[-1]), y)
        worst = 0.0
        for bm, bn, bk in mmk.TILES:
            for order in mmk.ORDERS:
                got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)
                torch.cuda.synchronize()
                err, scale = rel_err(torch, got.reshape(want.shape), want)
                worst = max(worst, err / scale)
                if err > MM_RTOL * scale:
                    fail(f"matmul {xs_shape} @ {ys_shape} tile "
                         f"{(bm, bn, bk)} {order}: {err} > {MM_RTOL} * "
                         f"{scale}")
        emit(phase="kernel", kernel="matmul", x=list(xs_shape),
             y=list(ys_shape), cases="every tile x both orders",
             max_rel_err=worst, ok=True)

    # -- main path: pfb_power end to end -------------------------------------
    table = {}
    for label, b, n, p, m in (("fig3", 1, 2 ** 18, 32, 8),
                              ("full", 16, 2 ** 22, 1024, 8)):
        g = graph.build_pfb_power(p, m)
        plan = graph.compile(g, {"x": (b, n)}, lowering="kernel")
        nodes = [nd.op for nd in plan.graph.topo()]
        if nodes != ["input", "const", "pfb", "abs2"] or plan.downgrades \
                or set(plan.node_lowerings.values()) != {"kernel"}:
            fail(f"{label}: plan {nodes} {plan.node_lowerings} "
                 f"{plan.downgrades}")
        x = torch.randn(b, n, device=dev, generator=gen)
        # the counted run: counts set to 0 just before, read just after
        zero_counts()
        out = plan(x)
        torch.cuda.synchronize()
        launches = counts()
        want = dict.fromkeys(launches, 0)
        want.update(pfb_fused=1, elementwise_chain=1)
        if launches != want:
            fail(f"{label}: launches per call {launches}, want {want}")
        t = n // p
        tout = t - m + 1
        if tuple(out.shape) != (b, tout, p) or out.dtype != torch.float32 \
                or not bool(torch.isfinite(out).all()):
            fail(f"{label}: output {out.dtype}{tuple(out.shape)}, finite="
                 f"{bool(torch.isfinite(out).all())}")
        native = graph.compile(g, {"x": (b, n)}, lowering="native")
        ref = native(x)
        torch.cuda.synchronize()
        err_native, scale_native = rel_err(torch, out, ref)
        if err_native > PFB_RTOL * scale_native:
            fail(f"{label}: kernel plan vs native plan {err_native} > "
                 f"{PFB_RTOL} * {scale_native}")
        taps64 = pfb_window(p, m)
        want0 = np.abs(opdefs._np_pfb(x[0].double().cpu().numpy(),
                                      taps64)) ** 2
        got0 = out[0].double().cpu().numpy()
        err_oracle = float(np.max(np.abs(got0 - want0)))
        scale_oracle = float(np.max(np.abs(want0)))
        if err_oracle > ORACLE_RTOL * scale_oracle:
            fail(f"{label}: row 0 vs float64 oracle {err_oracle} > "
                 f"{ORACLE_RTOL} * {scale_oracle}")
        del ref

        # timing: the plan, each kernel alone, each plain version
        frames = x.reshape(b, t, p)
        taps_rev = torch.as_tensor(g.consts["taps"], device=dev).flip(0) \
            .contiguous()
        fr, fi = ops._fourier(p, str(dev))
        cfg = ops._resolve(pfbk.TUNE_SPACE, {"m": m, "p": p, "t": t})
        zk = pfbk.pfb_fused(frames, taps_rev, fr, fi, **cfg)
        before = (pfbk.LAUNCHES, ew.LAUNCHES)
        ms = {
            "plan": median_ms(torch, lambda: plan(x)),
            "plan_native": median_ms(torch, lambda: native(x)),
            "pfb_fused": device_ms(
                torch, lambda: pfbk.pfb_fused(frames, taps_rev, fr, fi, **cfg)),
            "pfb_fused_plain": device_ms(
                torch, lambda: pfbk.pfb_fused_plain(frames, taps_rev, fr, fi)),
            "elementwise_chain": device_ms(
                torch, lambda: ew.elementwise_chain(zk, (), (),
                                                    abs2_head=True)),
            "elementwise_chain_plain": device_ms(
                torch, lambda: ew.elementwise_chain_plain(zk, (), (),
                                                          abs2_head=True)),
        }
        calls = REPEATS + 2
        grew = (pfbk.LAUNCHES - before[0], ew.LAUNCHES - before[1])
        if grew != (2 * calls, 2 * calls):
            # each plan call: 1 + 1; each lone kernel: 1 of its own
            fail(f"{label}: launches grew by {grew} over {calls} timed "
                 "plan calls and lone kernel calls, want one each per call")
        kerr, kscale = rel_err(torch, zk,
                               pfbk.pfb_fused_plain(frames, taps_rev, fr, fi))
        cerr, _ = rel_err(
            torch, ew.elementwise_chain(zk, (), (), abs2_head=True),
            ew.elementwise_chain_plain(zk, (), (), abs2_head=True))
        pb, pf = pfb_cost(b, t, p, p, m)
        n_out = b * tout * p
        emit(phase="main", size=label, x=[b, n], p=p, m=m, tile=cfg,
             launches_per_call=launches, max_abs_err_vs_native=err_native,
             max_abs_native=scale_native, max_abs_err_row0_vs_oracle=err_oracle,
             max_abs_oracle_row0=scale_oracle, ms=ms,
             plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
             pfb_achieved_tflops=pf / (ms["pfb_fused"] * 1e-3) / 1e12,
             chain_achieved_gb_s=12 * n_out / (ms["elementwise_chain"] * 1e-3)
             / 1e9,
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        table[label] = dict(launches=launches, ms=ms, pfb=(pb, pf),
                            chain=(12 * n_out, 3 * n_out), pfb_err=kerr,
                            chain_err=cerr)
        del zk, out, x, frames

    # -- main paths: stft_overlap_add at full width, spectrogram ------------
    def drive(label, g, shape, want, oracle, row_rtol):
        """Compile the kernel plan, run it once with the counts at 0, and
        hold it against the native plan and the oracle on row 0."""
        torch.cuda.reset_peak_memory_stats()
        plan = graph.compile(g, {"x": shape}, lowering="kernel")
        agnostic = {"real", "frame_decimate", "downsample"}
        if plan.downgrades or any(
                lw != ("native" if plan.graph.nodes[nd].op in agnostic
                       else "kernel")
                for nd, lw in plan.node_lowerings.items()):
            fail(f"{label}: lowerings {plan.node_lowerings} downgrades "
                 f"{plan.downgrades}")
        x = torch.randn(*shape, device=dev, generator=gen)
        zero_counts()
        out = plan(x)
        torch.cuda.synchronize()
        launches = counts()
        full_want = dict.fromkeys(launches, 0)
        full_want.update(want)
        if launches != full_want:
            fail(f"{label}: launches per call {launches}, want {full_want}")
        if not bool(torch.isfinite(out).all()):
            fail(f"{label}: non-finite output")
        plan_peak = torch.cuda.max_memory_allocated() / 1e9
        native = graph.compile(g, {"x": shape}, lowering="native")
        ref = native(x)
        torch.cuda.synchronize()
        if ref.shape != out.shape:
            fail(f"{label}: shape {tuple(out.shape)} vs native "
                 f"{tuple(ref.shape)}")
        err_native, scale_native = rel_err(torch, out, ref)
        del ref                          # free it before timing anything
        if err_native > NATIVE_RTOL * scale_native:
            fail(f"{label}: kernel plan vs native plan {err_native} > "
                 f"{NATIVE_RTOL} * {scale_native}")
        want0 = oracle(x[0].cpu().numpy())
        got0 = out[0].double().cpu().numpy()
        if got0.shape != want0.shape:
            fail(f"{label}: row 0 {got0.shape} vs oracle {want0.shape}")
        err_oracle = float(np.max(np.abs(got0 - want0)))
        scale_oracle = float(np.max(np.abs(want0)))
        if err_oracle > row_rtol * scale_oracle:
            fail(f"{label}: row 0 vs oracle {err_oracle} > {row_rtol} * "
                 f"{scale_oracle}")
        info = dict(launches_per_call=launches, out=list(out.shape),
                    max_abs_err_vs_native=err_native,
                    max_abs_native=scale_native,
                    max_abs_err_row0_vs_oracle=err_oracle,
                    max_abs_oracle_row0=scale_oracle,
                    plan_peak_memory_gb=plan_peak)
        del out
        return plan, native, x, info

    def fold_ola(frames, hop):
        """overlap-add as one F.fold (the library yardstick), sliced to
        the valid region."""
        r, t, j = frames.shape
        k = j // hop
        full = torch.nn.functional.fold(
            frames.transpose(1, 2), output_size=(1, (t - 1) * hop + j),
            kernel_size=(1, j), stride=(1, hop))
        return full[:, 0, 0, (k - 1) * hop:(k - 1) * hop + (t - k + 1) * hop]

    # stft_overlap_add: 4 channels of a 1024-point STFT at 50 % overlap
    b, n = STFT_X
    j, hop = STFT_J, STFT_HOP
    g = graph.build_stft_overlap_add(j, hop)
    plan, native, x, info = drive(
        "stft_overlap_add", g, STFT_X,
        {"unfold": 1, "elementwise_binary": 2, "dft": 2, "overlap_add": 1},
        graph.stft_overlap_add_oracle(j, hop), ORACLE_RTOL)
    # the shapes the path gives each kernel, made by the kernels themselves
    win = plan.consts["win"]
    fd = functions.unfold(x, j)[:, ::hop, :].contiguous()  # native view
    t = fd.shape[1]
    fw = ew.elementwise_mult(fd, win)
    xr = fw.reshape(-1, j)
    fr, fi = functions._dfm_tensors(j, False, torch.float32, str(dev))
    ir, ii = functions._dfm_tensors(j, True, torch.float32, str(dev))
    ucfg = ops._resolve(unfk.TUNE_SPACE, {"j": j, "n": n, "rows": b})
    dcfg = ops._resolve(dftk.TUNE_SPACE, {"m": b * t, "n": j, "k": j})
    ocfg = ops._resolve(unfk.OLA_TUNE_SPACE, {"j": j, "hop": hop,
                                             "k": j // hop, "t": t,
                                             "rows": b})
    z = dftk.dft(xr, fr, fi, variant="4mult", **dcfg)
    zinv = dftk.dft(z, ir, ii, variant="4mult", **dcfg)
    r = zinv.real.contiguous().reshape(b, t, j)
    rw = ew.elementwise_mult(r, win)
    # each kernel against its plain version at these shapes, before timing
    errs = {
        "dft": max(
            hold(torch, "stft dft", z, dftk.dft_plain(xr, fr, fi, "4mult"),
                 DFT_RTOL),
            hold(torch, "stft idft", zinv,
                 dftk.dft_plain(z, ir, ii, "4mult"), DFT_RTOL)),
        "elementwise_binary": max(
            hold(torch, "stft window (frames)", fw,
                 ew.elementwise_binary_plain(fd, win, "mul")),
            hold(torch, "stft window (idft)", rw,
                 ew.elementwise_binary_plain(r, win, "mul"))),
        "overlap_add": hold(torch, "stft overlap_add",
                            unfk.overlap_add(rw, hop, **ocfg),
                            unfk.overlap_add_plain(rw, hop)),
    }
    big = unfk.unfold(x, j, **ucfg)
    errs["unfold"] = hold(torch, "stft unfold", big, unfk.unfold_plain(x, j))
    del big
    torch.cuda.synchronize()

    def both(fn_a, fn_b):
        return device_ms(torch, fn_a) + device_ms(torch, fn_b)

    ms = {"plan": median_ms(torch, lambda: plan(x)),
          "plan_native": median_ms(torch, lambda: native(x)),
          "plan_back_to_back": device_ms(torch, lambda: plan(x))}
    before = counts()
    ms.update({
        "unfold": device_ms(torch, lambda: unfk.unfold(x, j, **ucfg)),
        "unfold_plain": device_ms(torch, lambda: unfk.unfold_plain(x, j)),
        "unfold_library": device_ms(
            torch, lambda: x.unfold(-1, j, 1).contiguous()),
        "elementwise_binary": both(lambda: ew.elementwise_mult(fd, win),
                                   lambda: ew.elementwise_mult(r, win)),
        "elementwise_binary_plain": both(
            lambda: ew.elementwise_binary_plain(fd, win, "mul"),
            lambda: ew.elementwise_binary_plain(r, win, "mul")),
        "elementwise_binary_library": both(lambda: torch.mul(fd, win),
                                           lambda: torch.mul(r, win)),
        "dft_forward": device_ms(
            torch, lambda: dftk.dft(xr, fr, fi, variant="4mult", **dcfg)),
        "dft_inverse": device_ms(
            torch, lambda: dftk.dft(z, ir, ii, variant="4mult", **dcfg)),
        "dft_plain": both(lambda: dftk.dft_plain(xr, fr, fi, "4mult"),
                          lambda: dftk.dft_plain(z, ir, ii, "4mult")),
        "dft_library": both(lambda: torch.fft.fft(xr),
                            lambda: torch.fft.ifft(z)),
        "overlap_add": device_ms(
            torch, lambda: unfk.overlap_add(rw, hop, **ocfg)),
        "overlap_add_plain": device_ms(
            torch, lambda: unfk.overlap_add_plain(rw, hop)),
        "overlap_add_library": device_ms(torch, lambda: fold_ola(rw, hop)),
    })
    ms["dft"] = ms["dft_forward"] + ms["dft_inverse"]
    calls = REPEATS + 2
    grew = {k: counts()[k] - before[k] for k in before}
    if grew != {**dict.fromkeys(grew, 0), "elementwise_binary": 2 * calls,
                "dft": 2 * calls, "unfold": calls, "overlap_add": calls}:
        fail(f"stft_overlap_add: lone kernel launches grew by {grew}")
    rows_f = b * t
    nt = t - j // hop + 1
    cost = {
        "unfold": (4 * (b * n + b * (n - j + 1) * j), 0),
        "elementwise_binary": (2 * 4 * (2 * rows_f * j + j), 2 * rows_f * j),
        "dft": add_cost(dft_cost(rows_f, j, j, False),
                        dft_cost(rows_f, j, j, True)),
        "overlap_add": (4 * (b * t * j + b * nt * hop),
                        b * nt * hop * (j // hop)),
    }
    emit(phase="main", path="stft_overlap_add", x=list(STFT_X), window=j,
         hop=hop, frames=rows_f, tiles={"unfold": ucfg, "dft": dcfg,
                                        "overlap_add": ocfg},
         max_abs_err_vs_plain=errs, ms=ms, plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         plan_bound_ms=sum(bound(*c)[0] for c in cost.values()),
         unfold_gb_s=cost["unfold"][0] / (ms["unfold"] * 1e-3) / 1e9,
         dft_achieved_tflops=cost["dft"][1] / (ms["dft"] * 1e-3) / 1e12,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **info)
    table["stft"] = dict(launches=info["launches_per_call"], ms=ms,
                         cost=cost, err=errs)
    del plan, native, x, fd, fw, xr, z, zinv, r, rw

    # spectrogram at its registered width
    b, n = SPEC_X
    j = SPEC_J
    g = graph.build_spectrogram(j)
    plan, native, x, info = drive(
        "spectrogram", g, SPEC_X,
        {"unfold": 1, "elementwise_binary": 1, "dft": 1,
         "elementwise_chain": 1},
        graph.spectrogram_oracle(j), ORACLE_RTOL)
    win = plan.consts["win"]
    ucfg = ops._resolve(unfk.TUNE_SPACE, {"j": j, "n": n, "rows": b})
    frames = unfk.unfold(x, j, **ucfg)
    fw = ew.elementwise_mult(frames, win)
    xr = fw.reshape(-1, j)
    fr, fi = functions._dfm_tensors(j, False, torch.float32, str(dev))
    dcfg = ops._resolve(dftk.TUNE_SPACE, {"m": xr.shape[0], "n": j, "k": j})
    z = dftk.dft(xr, fr, fi, variant="4mult", **dcfg)
    steps = (("scale", 1.0 / j),)
    # each kernel against its plain version at these shapes, before timing
    spec_errs = {
        "unfold": hold(torch, "spectrogram unfold", frames,
                       unfk.unfold_plain(x, j)),
        "elementwise_binary": hold(
            torch, "spectrogram window", fw,
            ew.elementwise_binary_plain(frames, win, "mul")),
        "dft": hold(torch, "spectrogram dft", z,
                    dftk.dft_plain(xr, fr, fi, "4mult"), DFT_RTOL),
        "elementwise_chain": hold(
            torch, "spectrogram abs2+scale",
            ew.elementwise_chain(z, (), steps, abs2_head=True),
            ew.elementwise_chain_plain(z, (), steps, abs2_head=True)),
    }
    ms = {
        "plan": median_ms(torch, lambda: plan(x)),
        "plan_native": median_ms(torch, lambda: native(x)),
        "plan_back_to_back": device_ms(torch, lambda: plan(x)),
        "unfold": device_ms(torch, lambda: unfk.unfold(x, j, **ucfg)),
        "unfold_plain": device_ms(torch, lambda: unfk.unfold_plain(x, j)),
        "unfold_library": device_ms(
            torch, lambda: x.unfold(-1, j, 1).contiguous()),
        "elementwise_binary": device_ms(
            torch, lambda: ew.elementwise_mult(frames, win)),
        "elementwise_binary_plain": device_ms(
            torch, lambda: ew.elementwise_binary_plain(frames, win, "mul")),
        "elementwise_binary_library": device_ms(
            torch, lambda: torch.mul(frames, win)),
        "dft": device_ms(
            torch, lambda: dftk.dft(xr, fr, fi, variant="4mult", **dcfg)),
        "dft_plain": device_ms(
            torch, lambda: dftk.dft_plain(xr, fr, fi, "4mult")),
        "dft_library": device_ms(torch, lambda: torch.fft.fft(xr)),
        "elementwise_chain": device_ms(
            torch, lambda: ew.elementwise_chain(z, (), steps,
                                                abs2_head=True)),
        "elementwise_chain_plain": device_ms(
            torch, lambda: ew.elementwise_chain_plain(z, (), steps,
                                                      abs2_head=True)),
    }
    nf = xr.shape[0]
    emit(phase="main", path="spectrogram", x=list(SPEC_X), window=j,
         frames=nf, tiles={"unfold": ucfg, "dft": dcfg},
         max_abs_err_vs_plain=spec_errs, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         plan_bound_ms=sum(bound(*c)[0] for c in (
             (4 * (b * n + nf * j), 0), (4 * (2 * nf * j + j), nf * j),
             dft_cost(nf, j, j, False), (12 * nf * j, 4 * nf * j))),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **info)
    del plan, native, x, frames, fw, xr, z

    # -- main paths: the three FIR pipelines at full width -------------------
    def conv1d(sig, kern):
        """The FIR as one F.conv1d (the library yardstick); call it under
        fp32_convs() so cuDNN runs full fp32, not TF32."""
        return torch.nn.functional.conv1d(sig[:, None], kern[None, None])[:, 0]

    def fir_cfg(k, n_in, rows_in):
        return ops._resolve(firk.TUNE_SPACE,
                            {"k": k, "n": n_in, "rows": rows_in})

    def check_grew(label, before, want):
        grew = {k: counts()[k] - before[k] for k in before}
        full_want = dict.fromkeys(grew, 0)
        full_want.update({k: v * calls for k, v in want.items()})
        if grew != full_want:
            fail(f"{label}: lone kernel launches grew by {grew}, want "
                 f"{full_want}")

    # fir_decimate: FIR (31 taps) -> ↓2 -> FIR (15 taps) -> ↓2
    b, n = FIR_X
    g = graph.build_fir_decimate(31, 15)
    plan, native, x, info = drive(
        "fir_decimate", g, FIR_X, {"fir_valid": 2},
        graph.fir_decimate_oracle(31, 15), ORACLE_RTOL)
    t1, t2 = plan.consts["taps1"], plan.consts["taps2"]  # flip=True
    h1, h2 = t1.flip(0), t2.flip(0)   # reversed, for the F.conv1d yardstick
    c1 = fir_cfg(31, n, b)
    y1 = firk.fir_valid(x, t1, flip=True, **c1)
    x2 = y1[:, ::2].contiguous()      # the ↓2 view the wrapper makes whole
    c2 = fir_cfg(15, x2.shape[1], b)
    y2 = firk.fir_valid(x2, t2, flip=True, **c2)
    dec_err = max(
        hold(torch, "fir_decimate fir 1", y1,
             firk.fir_valid_plain(x, t1, flip=True)),
        hold(torch, "fir_decimate fir 2", y2,
             firk.fir_valid_plain(x2, t2, flip=True)))
    ms = {"plan": median_ms(torch, lambda: plan(x)),
          "plan_native": median_ms(torch, lambda: native(x)),
          "plan_back_to_back": device_ms(torch, lambda: plan(x))}
    before = counts()
    ms.update({
        "fir_1": device_ms(
            torch, lambda: firk.fir_valid(x, t1, flip=True, **c1)),
        "fir_2": device_ms(
            torch, lambda: firk.fir_valid(x2, t2, flip=True, **c2)),
        "fir_valid_plain": both(
            lambda: firk.fir_valid_plain(x, t1, flip=True),
            lambda: firk.fir_valid_plain(x2, t2, flip=True)),
        "downsample_copy": device_ms(torch,
                                     lambda: y1[:, ::2].contiguous()),
    })
    with fp32_convs():
        ms["fir_valid_library"] = both(lambda: conv1d(x, h1),
                                       lambda: conv1d(x2, h2))
    ms["fir_valid"] = ms["fir_1"] + ms["fir_2"]
    check_grew("fir_decimate", before, {"fir_valid": 2})
    # FIR 1 at every tile of its tune space (for the next tuning PR)
    fir_1_tiles = {f"{c['bn']}/{c['threads']}": device_ms(
        torch, lambda c=c: firk.fir_valid(x, t1, flip=True, **c))
        for c in firk.TUNE_SPACE.configs({"k": 31})}
    cost1 = fir_cost(b, n, y1.shape[1], 31)
    cost2 = fir_cost(b, x2.shape[1], y2.shape[1], 15)
    emit(phase="main", path="fir_decimate", x=list(FIR_X), taps=[31, 15],
         tiles={"fir_1": c1, "fir_2": c2},
         max_abs_err_vs_plain={"fir_valid": dec_err}, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={"fir_1": bound(*cost1)[0], "fir_2": bound(*cost2)[0]},
         plan_bound_ms=bound(*cost1)[0] + bound(*cost2)[0],
         fir_1_gb_s=cost1[0] / (ms["fir_1"] * 1e-3) / 1e9,
         fir_1_ms_per_tile=fir_1_tiles,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **info)
    table["fir_decimate"] = dict(launches=info["launches_per_call"], ms=ms,
                                 cost=add_cost(cost1, cost2), err=dec_err)
    del plan, native, x, y1, x2, y2

    # correlate: FIR with the 63-tap template (no flip) -> abs2 -> scale
    g = graph.build_correlate(63)
    plan, native, x, info = drive(
        "correlate", g, FIR_X, {"fir_valid": 1, "elementwise_chain": 1},
        graph.correlate_oracle(63), ORACLE_RTOL)
    tmpl = plan.consts["template"]                 # flip=False: as it is
    cc = fir_cfg(63, n, b)
    y = firk.fir_valid(x, tmpl, **cc)
    (fused,) = [nd for nd in plan.graph.topo() if nd.op == "fused_ew"]
    if fused.attr["steps"][0] != ("abs2",):
        fail(f"correlate: fused chain {fused.attr['steps']}")
    steps = fused.attr["steps"][1:]                # after the abs2 head
    pw = ew.elementwise_chain(y, (), steps, abs2_head=True)
    cor_errs = {
        "fir_valid": hold(torch, "correlate fir", y,
                          firk.fir_valid_plain(x, tmpl)),
        "elementwise_chain": hold(
            torch, "correlate abs2*scale (real head)", pw,
            ew.elementwise_chain_plain(y, (), steps, abs2_head=True)),
    }
    ms = {"plan": median_ms(torch, lambda: plan(x)),
          "plan_native": median_ms(torch, lambda: native(x)),
          "plan_back_to_back": device_ms(torch, lambda: plan(x))}
    before = counts()
    ms.update({
        "fir_valid": device_ms(torch, lambda: firk.fir_valid(x, tmpl, **cc)),
        "fir_valid_plain": device_ms(torch,
                                     lambda: firk.fir_valid_plain(x, tmpl)),
        "elementwise_chain": device_ms(
            torch, lambda: ew.elementwise_chain(y, (), steps,
                                                abs2_head=True)),
        "elementwise_chain_plain": device_ms(
            torch, lambda: ew.elementwise_chain_plain(y, (), steps,
                                                      abs2_head=True)),
    })
    with fp32_convs():
        ms["fir_valid_library"] = device_ms(torch, lambda: conv1d(x, tmpl))
    check_grew("correlate", before, {"fir_valid": 1, "elementwise_chain": 1})
    nout = y.numel()
    cor_cost = {"fir_valid": fir_cost(b, n, y.shape[1], 63),
                "elementwise_chain": (8 * nout, 2 * nout)}
    emit(phase="main", path="correlate", x=list(FIR_X), taps=63, tiles=cc,
         max_abs_err_vs_plain=cor_errs, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={k: bound(*c)[0] for k, c in cor_cost.items()},
         plan_bound_ms=sum(bound(*c)[0] for c in cor_cost.values()),
         fir_gb_s=cor_cost["fir_valid"][0] / (ms["fir_valid"] * 1e-3) / 1e9,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **info)
    del plan, native, x, y, pw

    # cascaded_channelizer: FIR (31 taps) -> ↓2 -> PFB (P = 16, M = 4) -> abs2
    if CHAN_X[1] != graph.pipelines._chan_len(2 ** 22, 31, 16, 4):
        fail(f"cascaded_channelizer: {CHAN_X} is no valid length")
    b, n = CHAN_X
    p, m = 16, 4
    g = graph.build_cascaded_channelizer(31, p, m)
    plan, native, x, info = drive(
        "cascaded_channelizer", g, CHAN_X,
        {"fir_valid": 1, "pfb_fused": 1, "elementwise_chain": 1},
        graph.cascaded_channelizer_oracle(31, p, m), ORACLE_RTOL)
    lp = plan.consts["lowpass"]                    # flip=True
    h = lp.flip(0)                    # reversed, for the F.conv1d yardstick
    cc = fir_cfg(31, n, b)
    y = firk.fir_valid(x, lp, flip=True, **cc)
    frames = y[:, ::2].reshape(b, -1, p).contiguous()   # ↓2, then frames
    t = frames.shape[1]
    taps_rev = plan.consts["taps"].flip(0).contiguous()
    fr, fi = ops._fourier(p, str(dev))
    pcfg = ops._resolve(pfbk.TUNE_SPACE, {"m": m, "p": p, "t": t})
    zk = pfbk.pfb_fused(frames, taps_rev, fr, fi, **pcfg)
    pw = ew.elementwise_chain(zk, (), (), abs2_head=True)
    chan_errs = {
        "fir_valid": hold(torch, "cascaded fir", y,
                          firk.fir_valid_plain(x, lp, flip=True)),
        "pfb_fused": hold(torch, "cascaded pfb", zk,
                          pfbk.pfb_fused_plain(frames, taps_rev, fr, fi),
                          PFB_RTOL),
        "elementwise_chain": hold(
            torch, "cascaded abs2", pw,
            ew.elementwise_chain_plain(zk, (), (), abs2_head=True)),
    }
    ms = {"plan": median_ms(torch, lambda: plan(x)),
          "plan_native": median_ms(torch, lambda: native(x)),
          "plan_back_to_back": device_ms(torch, lambda: plan(x))}
    before = counts()
    ms.update({
        "fir_valid": device_ms(
            torch, lambda: firk.fir_valid(x, lp, flip=True, **cc)),
        "fir_valid_plain": device_ms(
            torch, lambda: firk.fir_valid_plain(x, lp, flip=True)),
        "downsample_copy": device_ms(
            torch, lambda: y[:, ::2].reshape(b, -1, p).contiguous()),
        "pfb_fused": device_ms(
            torch, lambda: pfbk.pfb_fused(frames, taps_rev, fr, fi, **pcfg)),
        "pfb_fused_plain": device_ms(
            torch, lambda: pfbk.pfb_fused_plain(frames, taps_rev, fr, fi)),
        "elementwise_chain": device_ms(
            torch, lambda: ew.elementwise_chain(zk, (), (), abs2_head=True)),
        "elementwise_chain_plain": device_ms(
            torch, lambda: ew.elementwise_chain_plain(zk, (), (),
                                                      abs2_head=True)),
    })
    with fp32_convs():
        ms["fir_valid_library"] = device_ms(torch, lambda: conv1d(x, h))
    check_grew("cascaded_channelizer", before,
               {"fir_valid": 1, "pfb_fused": 1, "elementwise_chain": 1})
    n_out = pw.numel()
    chan_cost = {"fir_valid": fir_cost(b, n, y.shape[1], 31),
                 "pfb_fused": pfb_cost(b, t, p, p, m),
                 "elementwise_chain": (12 * n_out, 3 * n_out)}
    emit(phase="main", path="cascaded_channelizer", x=list(CHAN_X), taps=31,
         p=p, m=m, tiles={"fir_valid": cc, "pfb_fused": pcfg},
         max_abs_err_vs_plain=chan_errs, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={k: bound(*c)[0] for k, c in chan_cost.items()},
         plan_bound_ms=sum(bound(*c)[0] for c in chan_cost.values()),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **info)
    del plan, native, x, y, frames, zk, pw

    # -- main path: the Table-1 sweep at the kernel lowering -----------------
    def one_node(d, args):
        """A one-node graph from an OpDef's make_args tuple: the first
        array is the input, later arrays consts, non-arrays arg_attrs."""
        og = graph.Graph(f"one_{d.name}")
        refs, attrs = [], {}
        names = list(d.arg_attrs)
        for i, a in enumerate(args):
            if isinstance(a, np.ndarray):
                refs.append(og.input("x") if not refs
                            else og.const(a, f"c{i}"))
            else:
                attrs[names.pop(0)] = a
        og.output(og.apply(d.name, *refs, **attrs))
        return og

    def excess(got, want, tol):
        """max(|got - want| - tol (1 + |want|)): above 0 fails."""
        return float(np.max(np.abs(got - want) - tol * (1 + np.abs(want))))

    sweep_launches = {
        "ew_mul": {"elementwise_binary": 1},
        "ew_add": {"elementwise_binary": 1},
        "matmul": {"matmul": 1}, "summation": {}, "dft": {"dft": 1},
        "idft": {"dft": 1}, "fir": {"fir_valid": 1}, "unfold": {"unfold": 1},
        "overlap_add": {"overlap_add": 1}, "pfb_frontend": {"pfb_fused": 1},
        "pfb": {"pfb_fused": 1}}
    # each kernel wrapper the sweep reaches: (module, attribute, plain
    # version, its tune params, hold tolerance: None is bit-exact)
    wrappers = {
        "fir_valid": (firk, "fir_valid", firk.fir_valid_plain,
                      firk.TUNE_SPACE.params, None),
        "matmul": (mmk, "matmul", mmk.matmul_plain, mmk.TUNE_SPACE.params,
                   MM_RTOL),
        "dft": (dftk, "dft", dftk.dft_plain, dftk.TUNE_SPACE.params,
                DFT_RTOL),
        "unfold": (unfk, "unfold", unfk.unfold_plain, unfk.TUNE_SPACE.params,
                   None),
        "overlap_add": (unfk, "overlap_add", unfk.overlap_add_plain,
                        unfk.OLA_TUNE_SPACE.params, None),
        "pfb_fused": (pfbk, "pfb_fused", pfbk.pfb_fused_plain,
                      pfbk.TUNE_SPACE.params, PFB_RTOL),
        "elementwise_mult": (
            ew, "elementwise_mult",
            lambda x, y: ew.elementwise_binary_plain(x, y, "mul"),
            ew.TUNE_SPACE.params, None),
        "elementwise_add": (
            ew, "elementwise_add",
            lambda x, y: ew.elementwise_binary_plain(x, y, "add"),
            ew.TUNE_SPACE.params, None)}

    def recorded(fn):
        """fn() with every kernel wrapper of ``wrappers`` noting its
        calls: returns fn's result and [(kernel, args, kwargs)]."""
        noted, real = [], {}
        for name, (mod, attr, *_) in wrappers.items():
            real[name] = getattr(mod, attr)
            setattr(mod, attr, lambda *a, _n=name, **kw: (
                noted.append((_n, a, kw)), real[_n](*a, **kw))[1])
        out = fn()
        for name, (mod, attr, *_) in wrappers.items():
            setattr(mod, attr, real[name])
        return out, noted

    rng = np.random.default_rng(1234)
    sweep = {}
    for d in opdefs.table_ops():
        args = d.make_args(rng, SWEEP_N)
        targs = [torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
                 else a for a in args]
        lw = "kernel" if "kernel" in d.lowerings else d.lowerings[0]
        zero_counts()
        eager, launched = recorded(lambda: d.eager(*targs, lowering=lw))
        torch.cuda.synchronize()
        launches = counts()
        want_launches = dict.fromkeys(launches, 0)
        want_launches.update(sweep_launches[d.name])
        if launches != want_launches:
            fail(f"table1 {d.table_name}: launches {launches}, want "
                 f"{want_launches}")
        # each kernel the row launched, again on the same inputs, against
        # its plain version; then the row against its native one-node
        # plan (summation has no other lowering)
        errs = {}
        for name, a, kw in launched:
            mod, attr, plain, params, rtol = wrappers[name]
            errs[name] = max(errs.get(name, 0.0), hold(
                torch, f"table1 {d.table_name} {name}",
                getattr(mod, attr)(*a, **kw),
                plain(*a, **{k: v for k, v in kw.items()
                             if k not in params}), rtol))
        spec = {"x": (args[0].shape, args[0].dtype)}
        oplan = graph.compile(one_node(d, args), spec, lowering=lw)
        nplan = None if lw == "native" else graph.compile(
            one_node(d, args), spec, lowering="native")
        if oplan.downgrades:
            fail(f"table1 {d.table_name}: downgrades {oplan.downgrades}")
        native_err = None if nplan is None else hold(
            torch, f"table1 {d.table_name} vs native plan", eager,
            nplan(targs[0]), NATIVE_RTOL)
        planned = oplan(targs[0]).cpu().numpy()
        got = eager.cpu().numpy()
        want = np.asarray(d.oracle(*args))
        if got.shape != want.shape or planned.shape != got.shape:
            fail(f"table1 {d.table_name}: {got.shape} vs oracle "
                 f"{want.shape}, plan {planned.shape}")
        ex_plan, ex_oracle = excess(planned, got, PLAN_TOL), \
            excess(got, want, SWEEP_TOL)
        if ex_plan > 0 or ex_oracle > 0:
            fail(f"table1 {d.table_name}: eager vs plan over 1e-5 by "
                 f"{ex_plan}, vs oracle over 2e-3 by {ex_oracle}")
        emit(phase="main", path="table1", op=d.table_name, lowering=lw,
             args=[list(a.shape) if isinstance(a, np.ndarray) else a
                   for a in args],
             launches_per_call={k: v for k, v in launches.items() if v},
             max_abs_err_vs_plain=errs, max_abs_err_vs_native=native_err,
             max_abs_err_vs_oracle=float(np.max(np.abs(got - want))),
             max_abs_oracle=float(np.max(np.abs(want))),
             max_abs_err_vs_plan=float(np.max(np.abs(planned - got))),
             ok=True)
        sweep[d.name] = (d, targs, oplan, nplan, launched, launches, errs)
        del eager, planned, got, want
    # every row checked: now the times of its plan, its native plan, and
    # each kernel it launched and that kernel's plain version
    sweep_ms = {}
    for name, (d, targs, oplan, nplan, launched, _, _) in sweep.items():
        x0 = targs[0]
        ms = {"plan": median_ms(torch, lambda: oplan(x0))}
        if nplan is not None:
            ms["plan_native"] = median_ms(torch, lambda: nplan(x0))
        for kname, a, kw in launched:
            mod, attr, plain, params, _ = wrappers[kname]
            pkw = {k: v for k, v in kw.items() if k not in params}
            ms[kname] = device_ms(
                torch, lambda: getattr(mod, attr)(*a, **kw))
            ms[kname + "_plain"] = device_ms(torch, lambda: plain(*a, **pkw))
        emit(phase="main", path="table1", op=d.table_name, ms=ms)
        sweep_ms[name] = ms
    (xa, ya) = sweep["ew_add"][1]
    add_launches, add_errs = sweep["ew_add"][5:]
    add_err = add_errs["elementwise_add"]
    add_ms = {k: sweep_ms["ew_add"][k]
              for k in ("elementwise_add", "elementwise_add_plain")}
    add_ms["elementwise_add_library"] = device_ms(torch,
                                                  lambda: torch.add(xa, ya))
    emit(phase="main", path="table1", op="elementwise_add",
         x=list(xa.shape), ms=add_ms, max_abs_err_vs_plain=add_err)
    # the binary kernel's launches in the elementwise_add row's counted run
    table["add"] = dict(
        launches={"elementwise_add": add_launches["elementwise_binary"]},
        ms=add_ms, err=add_err, cost=(12 * xa.numel(), xa.numel()))
    del sweep, xa, ya

    # -- main path: matmul, 4096 x 4096 @ 4096 x 4096, as a one-node plan ---
    g = graph.Graph(f"matmul_{MM_N}")
    y_np = rng.standard_normal((MM_N, MM_N), dtype=np.float32)
    g.output(g.apply("matmul", g.input("x"), g.const(y_np, "y")))
    y64 = y_np.astype(np.float64)
    plan, native, x, info = drive(
        "matmul", g, (MM_N, MM_N), {"matmul": 1},
        lambda x0: x0.astype(np.float64) @ y64, ORACLE_RTOL)
    yd = plan.consts["y"]
    mcfg = ops._resolve(mmk.TUNE_SPACE, {"m": MM_N, "n": MM_N, "k": MM_N})
    mm_err = hold(torch, "matmul 4096", mmk.matmul(x, yd, **mcfg),
                  mmk.matmul_plain(x, yd), MM_RTOL)
    ms = {"plan": median_ms(torch, lambda: plan(x)),
          "plan_native": median_ms(torch, lambda: native(x))}
    before = counts()
    ms.update({
        "matmul": device_ms(torch, lambda: mmk.matmul(x, yd, **mcfg)),
        "matmul_plain": device_ms(torch, lambda: mmk.matmul_plain(x, yd)),
        "matmul_library": device_ms(torch, lambda: torch.matmul(x, yd)),
    })
    check_grew("matmul", before, {"matmul": 1})
    mm_tiles = {f"{c['bm']}x{c['bn']}x{c['bk']}/{c['order']}": device_ms(
        torch, lambda c=c: mmk.matmul(x, yd, **c), repeats=5)
        for c in mmk.TUNE_SPACE.configs({"m": MM_N, "n": MM_N, "k": MM_N})}
    mm_cost = (4 * 3 * MM_N * MM_N, 2 * MM_N ** 3)
    emit(phase="main", path="matmul", x=[MM_N, MM_N], y=[MM_N, MM_N],
         tile=mcfg, max_abs_err_vs_plain=mm_err, ms=ms,
         bound_ms=bound(*mm_cost)[0],
         achieved_tflops=mm_cost[1] / (ms["matmul"] * 1e-3) / 1e12,
         ms_per_tile=mm_tiles,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **info)
    table["matmul"] = dict(launches=info["launches_per_call"], ms=ms,
                           cost=mm_cost, err=mm_err)
    del plan, native, x, yd

    # ======================================================================
    # the int8 tier (precision="int8") and the bf16 tier
    # ======================================================================
    def compile_quiet(g, shape, **kw):
        """graph.compile without the (expected, checked) downgrade warning
        of the nodes that declare no int8."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return graph.compile(g, {"x": shape}, **kw)

    def half_integer_signal(shape, period, seed):
        """f32 samples every window of ``period`` along dim -2 (a 2-D row:
        dim -1) of which holds one ±a, so its scale is s = 9/1024; all
        other samples are half-integer multiples of s, so x / s is
        exactly k + 0.5: the case round half to even decides."""
        a, sc = np.float32(1.1162109375), np.float32(9 / 1024)
        if np.float32(a * (np.float32(1) / np.float32(127))) != sc:
            fail("half-integer input: scale_of(a) is not 9/1024")
        r = np.random.default_rng(seed)
        xh = ((r.integers(-100, 100, shape) + 0.5) * sc).astype(np.float32)
        signs = np.where(r.random(shape) < 0.5, -a, a).astype(np.float32)
        idx = [slice(None)] * len(shape)
        idx[-1 if len(shape) == 2 else -2] = slice(None, None, period)
        xh[tuple(idx)] = signs[tuple(idx)]
        qh = xh[np.abs(xh) != a] / sc
        if not np.all(qh - np.floor(qh) == np.float32(0.5)):
            fail("half-integer input: a quotient is not k + 0.5")
        return torch.as_tensor(xh, device=dev)

    def int_mm(xq, wq_cm):
        """The library yardstick of an int8 contraction: torch._int_mm
        (cuBLASLt int8 -> int32), the contraction alone -- no quantize
        step, no rescale.  Timed here only; the port never calls it.
        ``wq_cm`` is the weight laid out column-major (``col_major``),
        once, outside the timing: cuBLASLt refuses a row-major (64, 64)
        int8 operand (CUBLAS_STATUS_NOT_SUPPORTED)."""
        return torch._int_mm(xq, wq_cm)

    def col_major(w):
        return w.t().contiguous().t()

    int8_floor = min(d.budget("int8").sqnr_db for d in opdefs.OPDEFS.values()
                     if d.budget("int8") is not None)
    eps32 = float(np.finfo(np.float32).eps)

    # -- int8 kernels against their plain versions, bit for bit -------------
    def int8_pair(m, k, n):
        xq, sx = quantize.quantize_symmetric(randn(m, k), axis=-1)
        wq, ws = quantize.quantize_weights(randn(k, n))
        return xq, wq, sx.reshape(-1), ws.reshape(-1)

    # matmul_int8: M, N, K not tile multiples, K below 4 and not a
    # multiple of 4, every compiled tile; rows that do not start 4-byte
    # aligned; the saturated headroom case at K = 2048
    for m, k, n in ((1, 1, 1), (257, 129, 255), (300, 100, 50), (70, 3, 33),
                    (130, 4097, 67)):
        xq, wq, sx, ws = int8_pair(m, k, n)
        want = mmk.matmul_int8_plain(xq, wq, sx, ws)
        for bm, bn, bk in mmk.TILES_INT8:
            hold(torch, f"matmul_int8 {(m, k, n)} tile {(bm, bn, bk)}",
                 mmk.matmul_int8(xq, wq, sx, ws, bm=bm, bn=bn, bk=bk), want)
        emit(phase="int8_kernels", kernel="matmul_int8", mkn=[m, k, n],
             tiles=[list(t) for t in mmk.TILES_INT8], exact=True)
    xq, wq, sx, ws = int8_pair(64, 2048, 96)
    buf = torch.empty(64 * 2048 + 1, dtype=torch.int8, device=dev)
    xs = buf[1:].view(64, 2048)
    xs.copy_(xq)
    for bm, bn, bk in mmk.TILES_INT8:
        hold(torch, "matmul_int8 unaligned rows",
             mmk.matmul_int8(xs, wq, sx, ws, bm=bm, bn=bn, bk=bk),
             mmk.matmul_int8_plain(xq, wq, sx, ws))
    sat = torch.where(torch.rand(512, 2048, device=dev, generator=gen) < 0.5,
                      -127, 127).to(torch.int8)
    wsat = torch.where(torch.rand(2048, 512, device=dev, generator=gen) < 0.5,
                       -127, 127).to(torch.int8)
    one = torch.ones(512, device=dev)
    acc64 = sat.cpu().long() @ wsat.cpu().long()      # int64, exact
    if acc64.abs().max() >= 2 ** 31:
        fail("headroom case overflows int32")
    for bm, bn, bk in mmk.TILES_INT8:
        hold(torch, "matmul_int8 headroom (+-127, K = 2048)",
             mmk.matmul_int8(sat, wsat, one, one, bm=bm, bn=bn, bk=bk).cpu(),
             acc64.float())
    hold(torch, "dft_int8 headroom (+-127, K = 2048)",
         dftk.dft_int8(sat, wsat, -wsat, one, one, one),
         dftk.dft_int8_plain(sat, wsat, -wsat, one, one, one))
    emit(phase="int8_kernels", kernel="matmul_int8",
         cases="unaligned rows; +-127 at K = 2048 (max |acc| "
               f"{int(acc64.abs().max())}) against an int64 sum",
         exact=True)
    # dft_int8: ragged rows and widths, forward and inverse int8 DFM
    for rows in (1, 37, 8188):
        for n in (7, 64, 1024):
            for inverse in (False, True):
                xq, sx = quantize.quantize_symmetric(randn(rows, n), axis=-1)
                qr, sr, qi, si = quantize._qdfm_tensors(n, inverse, str(dev))
                hold(torch, f"dft_int8 rows={rows} n={n} inverse={inverse}",
                     dftk.dft_int8(xq, qr, qi, sx.reshape(-1), sr, si),
                     dftk.dft_int8_plain(xq, qr, qi, sx.reshape(-1), sr, si))
        emit(phase="int8_kernels", kernel="dft_int8", rows=rows,
             n=[7, 64, 1024], inverse=[False, True], exact=True)
    # half-integer quotients where the quantize runs in torch (qmatmul,
    # qdft): the card's wrapper path against the CPU's torch integer path
    xh = half_integer_signal((96, 256), 256, 3)
    wq, ws = quantize.quantize_weights(randn(256, 72))
    hold(torch, "qmatmul half-integer quotients, card vs CPU",
         ops.qmatmul(xh, wq, ws.reshape(-1)).cpu(),
         quantize.qmatmul(xh.cpu(), wq.cpu(), ws.reshape(-1).cpu()))
    hold(torch, "qdft half-integer quotients, card vs CPU",
         ops.qdft(xh[:, :64].contiguous()).cpu(),
         quantize.qdft(xh[:, :64].contiguous().cpu()))
    # fir_valid_int8: K = 1 to 4097, ragged rows, taps as given and
    # reversed, every tile, half-integer quotients inside the kernel
    for rows, n, k in ((3, 1000, 1), (2, 999, 8), (5, 4099, 15),
                       (1, 70001, 31), (7, 3000, 63), (2, 5003, 129),
                       (2, 9001, 4097)):
        x = randn(rows, n)
        for flip in (False, True):
            tq, ts = quantize.quantize_fir_taps(randn(k), flip=flip)
            tq, ts = tq.reshape(-1), ts.reshape(1)
            hold(torch, f"fir_valid_int8 {(rows, n)} K={k} flip={flip}",
                 firk.fir_valid_int8(x, tq, ts),
                 firk.fir_valid_int8_plain(x, tq, ts))
        emit(phase="int8_kernels", kernel="fir_valid_int8", shape=[rows, n],
             k=k, flip=[False, True], exact=True)
    xh = half_integer_signal((3, 5000), 31, 9)
    tq, ts = quantize.quantize_fir_taps(randn(31))
    tq, ts = tq.reshape(-1), ts.reshape(1)
    want = firk.fir_valid_int8_plain(xh.cpu(), tq.cpu(), ts.cpu())
    for cfg in firk.TUNE_SPACE_INT8.configs({"k": 31}):
        hold(torch, f"fir_valid_int8 half-integers tile {cfg} vs CPU plain",
             firk.fir_valid_int8(xh, tq, ts, **cfg).cpu(), want)
    emit(phase="int8_kernels", kernel="fir_valid_int8",
         cases="half-integer quotients, every tile, against the CPU",
         exact=True)
    # pfb_fused_int8: P = 16, 20, 48 and 1024, ragged frame counts, both
    # tiles, half-integer quotients in the frontend
    for b, t, p, m in ((2, 301, 16, 4), (1, 203, 48, 8), (3, 130, 16, 16),
                       (1, 75, 1024, 8), (2, 40, 20, 3)):
        frames = randn(b, t, p)
        tq, ts = quantize.quantize_pfb_taps(randn(m, p))
        qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(dev))
        args = (frames, tq, ts.reshape(-1), qr, qi, sr, si)
        want = pfbk.pfb_fused_int8_plain(*args)
        for bt, bn in pfbk.TILES_INT8:
            hold(torch, f"pfb_fused_int8 {(b, t, p, m)} tile {(bt, bn)}",
                 pfbk.pfb_fused_int8(*args, bt=bt, bn=bn), want)
        emit(phase="int8_kernels", kernel="pfb_fused_int8",
             shape=[b, t, p, m], tiles=[list(t) for t in pfbk.TILES_INT8],
             exact=True)
    frames = half_integer_signal((2, 90, 48), 8, 10)
    tq, ts = quantize.quantize_pfb_taps(
        torch.as_tensor(pfb_window(48, 8).astype(np.float32), device=dev))
    qr, sr, qi, si = quantize._qdfm_tensors(48, False, str(dev))
    args = (frames, tq, ts.reshape(-1), qr, qi, sr, si)
    want = pfbk.pfb_fused_int8_plain(*(a.cpu() for a in args))
    for bt, bn in pfbk.TILES_INT8:
        hold(torch, f"pfb_fused_int8 half-integers tile {(bt, bn)} vs CPU",
             pfbk.pfb_fused_int8(*args, bt=bt, bn=bn).cpu(), want)
    emit(phase="int8_kernels", kernel="pfb_fused_int8",
         cases="half-integer quotients, both tiles, against the CPU",
         exact=True)

    # -- int8 main path: pfb_power at full width -----------------------------
    b, n, p, m = 16, 2 ** 22, 1024, 8
    g = graph.build_pfb_power(p, m)
    torch.cuda.reset_peak_memory_stats()
    plan8 = compile_quiet(g, (b, n), precision="int8", lowering="kernel")
    pname = next(nd.name for nd in plan8.graph.topo() if nd.op == "pfb")
    aname = next(nd.name for nd in plan8.graph.topo() if nd.op == "abs2")
    if plan8.node_precisions != {pname: "int8", aname: "f32"} \
            or plan8.downgrades != {aname: "precision:int8"} \
            or set(plan8.node_lowerings.values()) != {"kernel"}:
        fail(f"int8 pfb_power: precisions {plan8.node_precisions}, "
             f"downgrades {plan8.downgrades}, lowerings "
             f"{plan8.node_lowerings}")
    x = torch.randn(b, n, device=dev, generator=gen)
    zero_counts()
    out8 = plan8(x)
    torch.cuda.synchronize()
    launches = counts()
    want = {**dict.fromkeys(launches, 0), "pfb_fused_int8": 1,
            "elementwise_chain": 1}
    t = n // p
    tout = t - m + 1
    if launches != want:
        fail(f"int8 pfb_power: launches per call {launches}, want {want}")
    if tuple(out8.shape) != (b, tout, p) or not bool(
            torch.isfinite(out8).all()):
        fail(f"int8 pfb_power: output {tuple(out8.shape)} not finite or "
             "misshaped")
    native8 = compile_quiet(g, (b, n), precision="int8")
    if not torch.equal(out8, native8(x)):
        fail("int8 pfb_power: kernel plan not bit-identical to the int8 "
             "native plan")
    sq = opdefs.sqnr_db(graph.pfb_power_oracle(p, m)(x[0].cpu().numpy()),
                        out8[0].cpu().numpy())
    sq_floor = max(opdefs.OPDEFS["pfb"].budget("int8").sqnr_db, int8_floor)
    if not sq >= sq_floor:
        fail(f"int8 pfb_power: SQNR {sq} dB < {sq_floor}")
    tq, ts = plan8.qconsts[pname]
    frames = x.reshape(b, t, p)
    qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(dev))
    args = (frames, tq, ts.reshape(-1), qr, qi, sr, si)
    pcfg = ops._resolve(pfbk.TUNE_SPACE_INT8, {"m": m, "p": p, "t": t})
    zk = pfbk.pfb_fused_int8(*args, **pcfg)
    perr = hold(torch, "int8 main pfb_fused_int8", zk,
                pfbk.pfb_fused_int8_plain(*args))
    cerr = hold(torch, "int8 main abs2", ew.elementwise_chain(
        zk, (), (), abs2_head=True), ew.elementwise_chain_plain(
        zk, (), (), abs2_head=True))
    peak8 = torch.cuda.max_memory_allocated() / 1e9
    ms = {"plan": median_ms(torch, lambda: plan8(x)),
          "plan_back_to_back": device_ms(torch, lambda: plan8(x)),
          "plan_native": median_ms(torch, lambda: native8(x))}
    before = counts()
    ms.update({
        "pfb_fused_int8": device_ms(
            torch, lambda: pfbk.pfb_fused_int8(*args, **pcfg)),
        "pfb_fused_int8_plain": device_ms(
            torch, lambda: pfbk.pfb_fused_int8_plain(*args)),
        "elementwise_chain": device_ms(
            torch, lambda: ew.elementwise_chain(zk, (), (), abs2_head=True)),
        "elementwise_chain_plain": device_ms(
            torch, lambda: ew.elementwise_chain_plain(zk, (), (),
                                                      abs2_head=True)),
    })
    check_grew("int8 pfb_power", before,
               {"pfb_fused_int8": 1, "elementwise_chain": 1})
    pfb_tiles = {f"{bt}x{bn}": device_ms(
        torch, lambda bt=bt, bn=bn: pfbk.pfb_fused_int8(*args, bt=bt, bn=bn))
        for bt, bn in pfbk.TILES_INT8
        if pfbk.TUNE_SPACE_INT8.valid({"bt": bt, "bn": bn},
                                      {"m": m, "p": p, "t": t})}
    pcost = qpfb_cost(b, t, p, p, m)
    emit(phase="int8_main", path="pfb_power", precision="int8", x=[b, n],
         p=p, m=m, tile=pcfg, launches_per_call=launches,
         node_precisions=plan8.node_precisions, downgrades=plan8.downgrades,
         bitwise_vs_native_plan=True, sqnr_db_row0_vs_oracle=sq,
         sqnr_floor_db=sq_floor, max_abs_err_vs_plain={
             "pfb_fused_int8": perr, "elementwise_chain": cerr},
         ms=ms, ms_per_tile=pfb_tiles,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms=bound8(*pcost)[0], bound_by=bound8(*pcost)[1],
         pfb_int8_achieved_tops=pcost[1] / (ms["pfb_fused_int8"] * 1e-3)
         / 1e12, max_memory_gb=peak8)
    table["int8_pfb"] = dict(launches=launches, ms=ms, cost=pcost, err=perr)
    del plan8, native8, out8, x, frames, zk, args

    # -- int8 paths: the other five pipelines at their cells' widths --------
    def drive8(label, g, shape, want, oracle, floor=None, complex_idft=False):
        """The int8 kernel plan run once with the counts at 0; rows 0-1
        held against the int8 native plan compiled for those two rows
        (every row is computed on its own), bit for bit -- or within
        2 ulp of max|native| where a complex idft recombines; row 0's
        SQNR against the numpy oracle."""
        torch.cuda.reset_peak_memory_stats()
        plan = compile_quiet(g, shape, precision="int8", lowering="kernel")
        for nd in plan.graph.topo():
            if nd.op in ("input", "const"):
                continue
            d = opdefs.OPDEFS[nd.op]
            lw, pr = plan.node_lowerings[nd.name], plan.node_precisions[nd.name]
            if d.qimpl is not None and "kernel" in d.q_lowerings:
                ok = (lw, pr) == ("kernel", "int8")
            else:
                ok = lw == ("native" if d.lowering_agnostic else "kernel")
            if not ok or "lowering" in plan.downgrades.get(nd.name, ""):
                fail(f"{label}: node {nd.name} ({nd.op}) runs {lw}/{pr}, "
                     f"downgrades {plan.downgrades}")
        x = torch.randn(*shape, device=dev, generator=gen)
        zero_counts()
        out = plan(x)
        torch.cuda.synchronize()
        launches = counts()
        full_want = {**dict.fromkeys(launches, 0), **want}
        if launches != full_want:
            fail(f"{label}: launches per call {launches}, want {full_want}")
        if not bool(torch.isfinite(out).all()):
            fail(f"{label}: non-finite output")
        peak = torch.cuda.max_memory_allocated() / 1e9
        two = (2,) + tuple(shape[1:])
        native = compile_quiet(g, two, precision="int8")
        ref = native(x[:2].contiguous())
        torch.cuda.synchronize()
        bitwise = torch.equal(out[:2], ref)
        err, scale = rel_err(torch, out[:2], ref)
        if not bitwise and not (complex_idft and err <= 2 * eps32 * scale):
            fail(f"{label}: rows 0-1 vs the int8 native plan: max |diff| "
                 f"{err} of {scale}")
        sq = opdefs.sqnr_db(oracle(x[0].cpu().numpy()), out[0].cpu().numpy())
        if floor is not None and not sq >= floor:
            fail(f"{label}: SQNR {sq} dB < {floor}")
        info = dict(launches_per_call=launches, out=list(out.shape),
                    node_precisions=plan.node_precisions,
                    downgrades=plan.downgrades,
                    bitwise_vs_native_rows01=bitwise,
                    max_abs_err_vs_native_rows01=err,
                    sqnr_db_row0_vs_oracle=sq, plan_peak_memory_gb=peak)
        ms = {"plan": median_ms(torch, lambda: plan(x)),
              "plan_back_to_back": device_ms(torch, lambda: plan(x)),
              "plan_native_rows01": median_ms(
                  torch, lambda: native(x[:2].contiguous()))}
        del out, ref
        return plan, x, info, ms

    # spectrogram: unfold -> window -> dft (int8) -> |.|^2 -> scale
    b, n = SPEC_X
    j = SPEC_J
    g = graph.build_spectrogram(j)
    plan, x, info, ms = drive8(
        "int8 spectrogram", g, SPEC_X,
        {"unfold": 1, "elementwise_binary": 1, "dft_int8": 1,
         "elementwise_chain": 1}, graph.spectrogram_oracle(j), int8_floor)
    frames = unfk.unfold(x, j)
    xq, sx = quantize.quantize_symmetric(
        ew.elementwise_mult(frames, plan.consts["win"]).reshape(-1, j),
        axis=-1)
    sx = sx.reshape(-1)
    qr, sr, qi, si = quantize._qdfm_tensors(j, False, str(dev))
    qr_cm, qi_cm = col_major(qr), col_major(qi)
    dcfg = ops._resolve(dftk.TUNE_SPACE_INT8,
                        {"m": xq.shape[0], "n": j, "k": j})
    derr = hold(torch, "int8 spectrogram dft_int8",
                dftk.dft_int8(xq, qr, qi, sx, sr, si, **dcfg),
                dftk.dft_int8_plain(xq, qr, qi, sx, sr, si))
    before = counts()
    ms.update({
        "dft_int8": device_ms(
            torch, lambda: dftk.dft_int8(xq, qr, qi, sx, sr, si, **dcfg)),
        "dft_int8_plain": device_ms(
            torch, lambda: dftk.dft_int8_plain(xq, qr, qi, sx, sr, si)),
        "dft_int8_library": device_ms(
            torch, lambda: (int_mm(xq, qr_cm), int_mm(xq, qi_cm))),
    })
    check_grew("int8 spectrogram", before, {"dft_int8": 1})
    dcost = qgemm_cost(xq.shape[0], j, j, planes=2)
    emit(phase="int8_paths", path="spectrogram", x=list(SPEC_X), window=j,
         tile=dcfg, max_abs_err_vs_plain={"dft_int8": derr}, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={"dft_int8": bound8(*dcost)[0]}, **info)
    table["int8_dft"] = dict(launches=info["launches_per_call"], ms=ms,
                             cost=dcost, err=derr)
    del plan, x, frames, xq

    # stft_overlap_add: the forward dft on dft_int8, the complex idft as
    # four matmul_int8
    b, n = STFT_X
    j, hop = STFT_J, STFT_HOP
    g = graph.build_stft_overlap_add(j, hop)
    plan, x, info, ms = drive8(
        "int8 stft_overlap_add", g, STFT_X,
        {"unfold": 1, "elementwise_binary": 2, "dft_int8": 1,
         "matmul_int8": 4, "overlap_add": 1},
        graph.stft_overlap_add_oracle(j, hop), complex_idft=True)
    fd = functions.unfold(x, j)[:, ::hop, :].contiguous()
    xq, sx = quantize.quantize_symmetric(
        ew.elementwise_mult(fd, plan.consts["win"]).reshape(-1, j), axis=-1)
    sx = sx.reshape(-1)
    qr, sr, qi, si = quantize._qdfm_tensors(j, False, str(dev))
    qr_cm, qi_cm = col_major(qr), col_major(qi)
    dcfg = ops._resolve(dftk.TUNE_SPACE_INT8,
                        {"m": xq.shape[0], "n": j, "k": j})
    z = dftk.dft_int8(xq, qr, qi, sx, sr, si, **dcfg)
    serr = {"dft_int8": hold(torch, "int8 stft dft_int8", z,
                             dftk.dft_int8_plain(xq, qr, qi, sx, sr, si))}
    ir, isr, ii, isi = quantize._qdfm_tensors(j, True, str(dev))
    zrq, szr = quantize.quantize_symmetric(z.real, axis=-1)
    ziq, szi = quantize.quantize_symmetric(z.imag, axis=-1)
    prods = [(zrq, ir, szr.reshape(-1), isr), (ziq, ii, szi.reshape(-1), isi),
             (zrq, ii, szr.reshape(-1), isi), (ziq, ir, szi.reshape(-1), isr)]
    serr["matmul_int8"] = max(
        hold(torch, "int8 stft idft matmul_int8",
             mmk.matmul_int8(*pr, **dcfg), mmk.matmul_int8_plain(*pr))
        for pr in prods)
    before = counts()
    ms.update({
        "dft_int8": device_ms(
            torch, lambda: dftk.dft_int8(xq, qr, qi, sx, sr, si, **dcfg)),
        "dft_int8_plain": device_ms(
            torch, lambda: dftk.dft_int8_plain(xq, qr, qi, sx, sr, si)),
        "dft_int8_library": device_ms(
            torch, lambda: (int_mm(xq, qr_cm), int_mm(xq, qi_cm))),
        "matmul_int8": sum(device_ms(
            torch, lambda pr=pr: mmk.matmul_int8(*pr, **dcfg))
            for pr in prods),
        "matmul_int8_plain": sum(device_ms(
            torch, lambda pr=pr: mmk.matmul_int8_plain(*pr))
            for pr in prods),
        "matmul_int8_library": sum(device_ms(
            torch, lambda a=pr[0], w=col_major(pr[1]): int_mm(a, w))
            for pr in prods),
    })
    check_grew("int8 stft_overlap_add", before,
               {"dft_int8": 1, "matmul_int8": 4})
    rows_f = xq.shape[0]
    emit(phase="int8_paths", path="stft_overlap_add", x=list(STFT_X),
         window=j, hop=hop, frames=rows_f, tile=dcfg,
         max_abs_err_vs_plain=serr, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={"dft_int8": bound8(*qgemm_cost(rows_f, j, j, 2))[0],
                   "matmul_int8": 4 * bound8(*qgemm_cost(rows_f, j, j))[0]},
         **info)
    del plan, x, fd, xq, z, zrq, ziq, prods

    # fir_decimate: two int8 FIRs
    b, n = FIR_X
    g = graph.build_fir_decimate(31, 15)
    plan, x, info, ms = drive8(
        "int8 fir_decimate", g, FIR_X, {"fir_valid_int8": 2},
        graph.fir_decimate_oracle(31, 15))
    (tq1, ts1), (tq2, ts2) = (
        plan.qconsts[nd.name] for nd in plan.graph.topo() if nd.op == "fir")
    tq1, ts1, tq2, ts2 = tq1.reshape(-1), ts1.reshape(1), tq2.reshape(-1), \
        ts2.reshape(1)
    c1 = ops._resolve(firk.TUNE_SPACE_INT8, {"k": 31, "n": n, "rows": b})
    y1 = firk.fir_valid_int8(x, tq1, ts1, **c1)
    x2 = y1[:, ::2].contiguous()
    c2 = ops._resolve(firk.TUNE_SPACE_INT8,
                      {"k": 15, "n": x2.shape[1], "rows": b})
    y2 = firk.fir_valid_int8(x2, tq2, ts2, **c2)
    ferr = max(hold(torch, "int8 fir_decimate fir 1", y1,
                    firk.fir_valid_int8_plain(x, tq1, ts1)),
               hold(torch, "int8 fir_decimate fir 2", y2,
                    firk.fir_valid_int8_plain(x2, tq2, ts2)))
    before = counts()
    ms.update({
        "fir_1": device_ms(
            torch, lambda: firk.fir_valid_int8(x, tq1, ts1, **c1)),
        "fir_2": device_ms(
            torch, lambda: firk.fir_valid_int8(x2, tq2, ts2, **c2)),
        "fir_valid_int8_plain": both(
            lambda: firk.fir_valid_int8_plain(x, tq1, ts1),
            lambda: firk.fir_valid_int8_plain(x2, tq2, ts2)),
    })
    ms["fir_valid_int8"] = ms["fir_1"] + ms["fir_2"]
    check_grew("int8 fir_decimate", before, {"fir_valid_int8": 2})
    fir8_tiles = {f"{c['bn']}/{c['threads']}": device_ms(
        torch, lambda c=c: firk.fir_valid_int8(x, tq1, ts1, **c), repeats=5)
        for c in firk.TUNE_SPACE_INT8.configs({"k": 31})}
    fcost = add_cost(qfir_cost(b, n, y1.shape[1], 31),
                     qfir_cost(b, x2.shape[1], y2.shape[1], 15))
    emit(phase="int8_paths", path="fir_decimate", x=list(FIR_X),
         taps=[31, 15], tiles={"fir_1": c1, "fir_2": c2},
         max_abs_err_vs_plain={"fir_valid_int8": ferr}, ms=ms,
         fir_1_ms_per_tile=fir8_tiles,
         divisions_fir_1=int(y1.numel()) * 31,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={"fir_1": bound8(*qfir_cost(b, n, y1.shape[1], 31))[0],
                   "fir_2": bound8(*qfir_cost(b, x2.shape[1], y2.shape[1],
                                              15))[0]}, **info)
    table["int8_fir"] = dict(launches=info["launches_per_call"], ms=ms,
                             cost=fcost, err=ferr)
    del plan, x, y1, x2, y2

    # correlate: the 63-tap template on the int8 FIR, then |.|^2 * scale
    g = graph.build_correlate(63)
    plan, x, info, ms = drive8(
        "int8 correlate", g, FIR_X,
        {"fir_valid_int8": 1, "elementwise_chain": 1},
        graph.correlate_oracle(63))
    ((tq, ts),) = (plan.qconsts[nd.name] for nd in plan.graph.topo()
                   if nd.op == "fir")
    tq, ts = tq.reshape(-1), ts.reshape(1)
    cc = ops._resolve(firk.TUNE_SPACE_INT8, {"k": 63, "n": n, "rows": b})
    cerr = hold(torch, "int8 correlate fir", firk.fir_valid_int8(
        x, tq, ts, **cc), firk.fir_valid_int8_plain(x, tq, ts))
    before = counts()
    ms.update({
        "fir_valid_int8": device_ms(
            torch, lambda: firk.fir_valid_int8(x, tq, ts, **cc)),
        "fir_valid_int8_plain": device_ms(
            torch, lambda: firk.fir_valid_int8_plain(x, tq, ts)),
    })
    check_grew("int8 correlate", before, {"fir_valid_int8": 1})
    emit(phase="int8_paths", path="correlate", x=list(FIR_X), taps=63,
         tile=cc, max_abs_err_vs_plain={"fir_valid_int8": cerr}, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={"fir_valid_int8": bound8(*qfir_cost(
             b, n, n - 62, 63))[0]}, **info)
    del plan, x

    # cascaded_channelizer: int8 FIR (31) -> down 2 -> int8 PFB (16, 4)
    b, n = CHAN_X
    p, m = 16, 4
    g = graph.build_cascaded_channelizer(31, p, m)
    plan, x, info, ms = drive8(
        "int8 cascaded_channelizer", g, CHAN_X,
        {"fir_valid_int8": 1, "pfb_fused_int8": 1, "elementwise_chain": 1},
        graph.cascaded_channelizer_oracle(31, p, m))
    fname = next(nd.name for nd in plan.graph.topo() if nd.op == "fir")
    pname = next(nd.name for nd in plan.graph.topo() if nd.op == "pfb")
    tq, ts = plan.qconsts[fname]
    tq, ts = tq.reshape(-1), ts.reshape(1)
    cc = ops._resolve(firk.TUNE_SPACE_INT8, {"k": 31, "n": n, "rows": b})
    y = firk.fir_valid_int8(x, tq, ts, **cc)
    frames = y[:, ::2].reshape(b, -1, p).contiguous()
    t = frames.shape[1]
    pq, ps = plan.qconsts[pname]
    qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(dev))
    pargs = (frames, pq, ps.reshape(-1), qr, qi, sr, si)
    pcfg = ops._resolve(pfbk.TUNE_SPACE_INT8, {"m": m, "p": p, "t": t})
    kerr = {"fir_valid_int8": hold(torch, "int8 cascaded fir", y,
                                   firk.fir_valid_int8_plain(x, tq, ts)),
            "pfb_fused_int8": hold(
                torch, "int8 cascaded pfb",
                pfbk.pfb_fused_int8(*pargs, **pcfg),
                pfbk.pfb_fused_int8_plain(*pargs))}
    before = counts()
    ms.update({
        "fir_valid_int8": device_ms(
            torch, lambda: firk.fir_valid_int8(x, tq, ts, **cc)),
        "pfb_fused_int8": device_ms(
            torch, lambda: pfbk.pfb_fused_int8(*pargs, **pcfg)),
        "pfb_fused_int8_plain": device_ms(
            torch, lambda: pfbk.pfb_fused_int8_plain(*pargs)),
    })
    check_grew("int8 cascaded_channelizer", before,
               {"fir_valid_int8": 1, "pfb_fused_int8": 1})
    emit(phase="int8_paths", path="cascaded_channelizer", x=list(CHAN_X),
         taps=31, p=p, m=m, tiles={"fir_valid_int8": cc,
                                   "pfb_fused_int8": pcfg},
         max_abs_err_vs_plain=kerr, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={"fir_valid_int8": bound8(*qfir_cost(
             b, n, y.shape[1], 31))[0],
             "pfb_fused_int8": bound8(*qpfb_cost(b, t, p, p, m))[0]},
         **info)
    del plan, x, y, frames, pargs

    # the int8 Table-1 sweep: every op with an int8 kernel, one-node plans
    sweep8_launches = {"matmul": {"matmul_int8": 1}, "dft": {"dft_int8": 1},
                       "idft": {"matmul_int8": 4},
                       "fir": {"fir_valid_int8": 1},
                       "pfb": {"pfb_fused_int8": 1}}
    for d in opdefs.table_ops():
        if "kernel" not in d.q_lowerings:
            continue
        args = d.make_args(rng, SWEEP_N)
        spec = {"x": (args[0].shape, args[0].dtype)}
        kplan = graph.compile(one_node(d, args), spec, precision="int8",
                              lowering="kernel")
        nplan = graph.compile(one_node(d, args), spec, precision="int8")
        if kplan.downgrades or set(kplan.node_precisions.values()) \
                != {"int8"}:
            fail(f"int8 table1 {d.table_name}: {kplan.node_precisions} "
                 f"{kplan.downgrades}")
        x0 = torch.as_tensor(args[0], device=dev)
        zero_counts()
        got = kplan(x0)
        torch.cuda.synchronize()
        launches = counts()
        want_l = {**dict.fromkeys(launches, 0), **sweep8_launches[d.name]}
        if launches != want_l:
            fail(f"int8 table1 {d.table_name}: launches {launches}, want "
                 f"{want_l}")
        ref = nplan(x0)
        bitwise = torch.equal(got, ref)
        err, scale = rel_err(torch, got, ref)
        if not bitwise and not (d.name == "idft" and err <= 2 * eps32 * scale):
            fail(f"int8 table1 {d.table_name}: vs its int8 native plan "
                 f"{err} of {scale}")
        sq = opdefs.sqnr_db(d.oracle(*args), got.cpu().numpy())
        if not sq >= d.budget("int8").sqnr_db:
            fail(f"int8 table1 {d.table_name}: SQNR {sq} dB < "
                 f"{d.budget('int8').sqnr_db}")
        emit(phase="int8_paths", path="table1", op=d.table_name,
             precision="int8", launches_per_call={
                 k: v for k, v in launches.items() if v},
             bitwise_vs_native_plan=bitwise, max_abs_err_vs_native=err,
             sqnr_db_vs_oracle=sq, budget_db=d.budget("int8").sqnr_db,
             ms={"plan": median_ms(torch, lambda: kplan(x0)),
                 "plan_native": median_ms(torch, lambda: nplan(x0))})
        del kplan, nplan, got, ref

    # matmul 4096 x 4096 @ 4096 x 4096 at int8, a one-node plan
    g = graph.Graph(f"matmul_int8_{MM_N}")
    y_np = rng.standard_normal((MM_N, MM_N), dtype=np.float32)
    mnode = g.apply("matmul", g.input("x"), g.const(y_np, "y"))
    g.output(mnode)
    y64 = y_np.astype(np.float64)
    plan, x, info, ms = drive8(
        "int8 matmul", g, (MM_N, MM_N), {"matmul_int8": 1},
        lambda x0: x0.astype(np.float64) @ y64,
        opdefs.OPDEFS["matmul"].budget("int8").sqnr_db)
    wq, ws = plan.qconsts[mnode]
    xq, sx = quantize.quantize_symmetric(x, axis=-1)
    sx = sx.reshape(-1)
    mcfg = ops._resolve(mmk.TUNE_SPACE_INT8,
                        {"m": MM_N, "n": MM_N, "k": MM_N})
    merr = hold(torch, "int8 matmul 4096", mmk.matmul_int8(
        xq, wq, sx, ws, **mcfg), mmk.matmul_int8_plain(xq, wq, sx, ws))
    before = counts()
    ms.update({
        "matmul_int8": device_ms(
            torch, lambda: mmk.matmul_int8(xq, wq, sx, ws, **mcfg)),
        "matmul_int8_plain": device_ms(
            torch, lambda: mmk.matmul_int8_plain(xq, wq, sx, ws)),
        "matmul_int8_library": device_ms(
            torch, lambda w=col_major(wq): int_mm(xq, w)),
    })
    check_grew("int8 matmul", before, {"matmul_int8": 1})
    mm8_tiles = {f"{c['bm']}x{c['bn']}x{c['bk']}": device_ms(
        torch, lambda c=c: mmk.matmul_int8(xq, wq, sx, ws, **c), repeats=5)
        for c in mmk.TUNE_SPACE_INT8.configs(
            {"m": MM_N, "n": MM_N, "k": MM_N})}
    mcost = qgemm_cost(MM_N, MM_N, MM_N)
    emit(phase="int8_paths", path="matmul", x=[MM_N, MM_N],
         y=[MM_N, MM_N], tile=mcfg, max_abs_err_vs_plain=merr, ms=ms,
         ms_per_tile=mm8_tiles, bound_ms=bound8(*mcost)[0],
         achieved_tops=mcost[1] / (ms["matmul_int8"] * 1e-3) / 1e12,
         library_achieved_tops=mcost[1] / (ms["matmul_int8_library"] * 1e-3)
         / 1e12, **info)
    table["int8_mm"] = dict(launches=info["launches_per_call"], ms=ms,
                            cost=mcost, err=merr)
    del plan, x, xq

    # -- bf16: pfb_power at full width, kernel lowering ----------------------
    b, n, p, m = 16, 2 ** 22, 1024, 8
    g = graph.build_pfb_power(p, m)
    planb = graph.compile(g, {"x": (b, n)}, precision="bf16",
                          lowering="kernel")
    if set(planb.node_precisions.values()) != {"bf16"} or planb.downgrades \
            or set(planb.node_lowerings.values()) != {"kernel"}:
        fail(f"bf16 pfb_power: {planb.node_precisions} {planb.downgrades} "
             f"{planb.node_lowerings}")
    x = torch.randn(b, n, device=dev, generator=gen)
    zero_counts()
    outb = planb(x)
    torch.cuda.synchronize()
    launches = counts()
    want = {**dict.fromkeys(launches, 0), "pfb_fused": 1,
            "elementwise_chain": 1}
    if launches != want:
        fail(f"bf16 pfb_power: launches per call {launches}, want {want}")
    sqb = opdefs.sqnr_db(graph.pfb_power_oracle(p, m)(x[0].cpu().numpy()),
                         outb[0].cpu().numpy())
    if not sqb >= 30.0:
        fail(f"bf16 pfb_power: SQNR {sqb} dB < 30")
    nativeb = graph.compile(g, {"x": (2, n)}, precision="bf16")
    berr, bscale = rel_err(torch, outb[:2], nativeb(x[:2].contiguous()))
    emit(phase="bf16", path="pfb_power", precision="bf16", x=[b, n], p=p,
         m=m, launches_per_call=launches, sqnr_db_row0_vs_oracle=sqb,
         max_abs_err_rows01_vs_native_bf16=berr, max_abs_native=bscale,
         ms={"plan": median_ms(torch, lambda: planb(x)),
             "plan_back_to_back": device_ms(torch, lambda: planb(x))})
    del planb, nativeb, outb, x

    full, stft = table["full"], table["stft"]
    dec, mm, add = table["fir_decimate"], table["matmul"], table["add"]
    rows = []
    for name, src, replaces, cost, err, launches, ms, lib in (
            ("pfb_fused", "src/repro_torch/csrc/pfb.cu",
             "src/repro/kernels/pfb.py:144", full["pfb"], full["pfb_err"],
             full["launches"], full["ms"], None),
            ("elementwise_chain", "src/repro_torch/csrc/elementwise.cu",
             "src/repro/kernels/elementwise.py:118", full["chain"],
             full["chain_err"], full["launches"], full["ms"], None),
            ("elementwise_binary", "src/repro_torch/csrc/elementwise.cu",
             "src/repro/kernels/elementwise.py:65",
             stft["cost"]["elementwise_binary"],
             stft["err"]["elementwise_binary"], stft["launches"],
             stft["ms"], "elementwise_binary_library"),
            ("dft", "src/repro_torch/csrc/dft.cu",
             "src/repro/kernels/dft.py:74", stft["cost"]["dft"],
             stft["err"]["dft"], stft["launches"], stft["ms"],
             "dft_library"),
            ("unfold", "src/repro_torch/csrc/unfold.cu",
             "src/repro/kernels/unfold.py:49", stft["cost"]["unfold"],
             stft["err"]["unfold"], stft["launches"], stft["ms"],
             "unfold_library"),
            ("overlap_add", "src/repro_torch/csrc/unfold.cu",
             "src/repro/kernels/unfold.py:111", stft["cost"]["overlap_add"],
             stft["err"]["overlap_add"], stft["launches"], stft["ms"],
             "overlap_add_library"),
            ("fir_valid", "src/repro_torch/csrc/fir.cu",
             "src/repro/kernels/fir.py:59", dec["cost"], dec["err"],
             dec["launches"], dec["ms"], "fir_valid_library"),
            ("matmul", "src/repro_torch/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:122", mm["cost"], mm["err"],
             mm["launches"], mm["ms"], "matmul_library"),
            ("elementwise_add", "src/repro_torch/csrc/elementwise.cu",
             "src/repro/kernels/elementwise.py:71", add["cost"], add["err"],
             add["launches"], add["ms"], "elementwise_add_library")):
        b_ms, b_by = bound(*cost)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms[name],
                     "plain_ms": ms[name + "_plain"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": ms[lib] if lib else None})
    for name, src, replaces, entry, lib in (
            ("matmul_int8", "src/repro_torch/csrc/qmatmul.cu",
             "src/repro/kernels/matmul.py:170", table["int8_mm"],
             "matmul_int8_library"),
            ("dft_int8", "src/repro_torch/csrc/qmatmul.cu",
             "src/repro/kernels/dft.py:154", table["int8_dft"],
             "dft_int8_library"),
            ("fir_valid_int8", "src/repro_torch/csrc/qfir.cu",
             "src/repro/kernels/fir.py:135", table["int8_fir"], None),
            ("pfb_fused_int8", "src/repro_torch/csrc/qpfb.cu",
             "src/repro/kernels/pfb.py:227", table["int8_pfb"], None)):
        b_ms, b_by = bound8(*entry["cost"])
        ms = entry["ms"]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": entry["launches"][name],
                     "max_abs_err": entry["err"], "ms": ms[name],
                     "plain_ms": ms[name + "_plain"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": ms[lib] if lib else None})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
