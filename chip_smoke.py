#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port: builds its kernels, holds each
against its plain torch version, and drives the ``pfb_power`` pipeline
end to end on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Prints one JSON line per phase:

  card      the card's name and power limit (``nvidia-smi``), versions
  build     seconds spent building ``src/repro_torch/csrc/*.cu`` with nvcc
  kernel    each kernel against its plain version at ragged shapes
            (PFB: max|diff| <= 1e-4 * max|plain|, fp32 sums taken in
            another order; chain: exact equality)
  main      ``pfb_power`` through ``graph.compile(..., lowering="kernel")``
            then ``plan(x)`` at the paper's Fig. 3 point and at full
            width (16 x 2**22 samples, P = 1024, M = 8): launch counts
            per call, agreement with the native plan and with a float64
            numpy oracle on batch row 0, median times of 20 calls
  kernels   the kernel table: launches, errors, times, bounds

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 bytes/s and
# fp32 FMA-pipe flop/s (no tensor cores: the kernels run full fp32).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
REPEATS = 20
PFB_RTOL = 1e-4       # fp32 sums of P*M terms in another order
ORACLE_RTOL = 2e-3    # the reference suite's pipeline-vs-oracle tolerance


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


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


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


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
    from repro_torch.core import opdefs
    from repro_torch.core.pfb import pfb_window
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import elementwise as ew
    from repro_torch.kernels import pfb as pfbk

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
            (a, (c, a), (("mul",), ("add",), ("scale", 1.7)), False)):
        got = ew.elementwise_chain(head, operands, steps, abs2_head=abs2_head)
        torch.cuda.synchronize()
        want = ew.elementwise_chain_plain(head, operands, steps,
                                          abs2_head=abs2_head)
        err, _ = rel_err(torch, got, want)
        ok = torch.equal(got, want)
        emit(phase="kernel", kernel="elementwise_chain",
             steps=[list(s) for s in steps], abs2_head=abs2_head,
             max_abs_err=err, exact=ok)
        if not ok:
            fail(f"elementwise_chain {steps}: not bit-identical to plain "
                 f"(max |diff| {err})")

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
        pfbk.LAUNCHES = 0
        ew.LAUNCHES = 0
        out = plan(x)
        torch.cuda.synchronize()
        launches = {"pfb_fused": pfbk.LAUNCHES,
                    "elementwise_chain": ew.LAUNCHES}
        if launches != {"pfb_fused": 1, "elementwise_chain": 1}:
            fail(f"{label}: launches per call {launches}, want 1 and 1")
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
            "pfb_fused": median_ms(
                torch, lambda: pfbk.pfb_fused(frames, taps_rev, fr, fi, **cfg)),
            "pfb_fused_plain": median_ms(
                torch, lambda: pfbk.pfb_fused_plain(frames, taps_rev, fr, fi)),
            "elementwise_chain": median_ms(
                torch, lambda: ew.elementwise_chain(zk, (), (),
                                                    abs2_head=True)),
            "elementwise_chain_plain": median_ms(
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

    full = table["full"]
    rows = []
    for name, src, replaces, cost, err in (
            ("pfb_fused", "src/repro_torch/csrc/pfb.cu",
             "src/repro/kernels/pfb.py:144", full["pfb"], full["pfb_err"]),
            ("elementwise_chain", "src/repro_torch/csrc/elementwise.cu",
             "src/repro/kernels/elementwise.py:118", full["chain"],
             full["chain_err"])):
        b_ms, b_by = bound(*cost)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": full["launches"][name],
                     "max_abs_err": err, "ms": full["ms"][name],
                     "plain_ms": full["ms"][name + "_plain"],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
