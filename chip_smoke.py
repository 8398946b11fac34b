#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port: builds its kernels, holds each
against its plain torch version, and drives the ``pfb_power``,
``stft_overlap_add``, ``spectrogram``, ``fir_decimate``, ``correlate``
and ``cascaded_channelizer`` pipelines, the Table-1 op sweep and a
4096-cubed matmul end to end on one NVIDIA card, at f32, then at int8
and bf16; then streams every pipeline in chunks, autotunes plans,
serves ``pfb_power`` and the spectrogram through ``PipelineService``,
runs every pipeline, a stream and a service batch-sharded over a
1-device mesh and over 4 logical shards of the card, and serves olmo_1b
(prefill + decode) through the model zoo's port.

    python3 chip_smoke.py            # from the root of a checkout

Prints one JSON line per phase:

  card      the card's name and power limit (``nvidia-smi``), versions
  build     seconds spent building ``src/repro_torch/csrc/*.cu`` with nvcc
  sass      ptxas registers and spills of the tensor-core kernels, the
            PFB frontends, the f32 FIR's and the overlap-add's kernels,
            and the FIR's ring in shared memory per tile at K = 15, 31, 63;
            the warpgroup MMA instructions (HGMMA, IGMMA) that
            ``cuobjdump -sass`` finds in each kernel of ``tina_dft`` and
            ``tina_matmul`` (the 3xTF32 DFT and GEMM: HGMMA),
            ``tina_matmul_bf16`` (the bf16 GEMM's skinny and tiled
            kernels, both present, each with HGMMA; a spill fails; ptxas's
            notes that it serialized a kernel's wgmmas are printed) and
            ``tina_matmul_int8``, ``tina_dft_int8`` and the DFT stage of
            ``tina_pfb_int8`` (the s8 GEMM and DFTs: IGMMA); a kernel
            without them fails, as does a ``__dp4a`` (IDP) left in any
            kernel of ``tina_pfb_int8``, or a warpgroup MMA or a spill in
            the f32 PFB's frontend kernels (``tina_pfb``: its DFT stage is
            ``tina_dft``'s kernel)
  kernel    each kernel against its plain version at ragged shapes
            (PFB and DFT: max|diff| <= 1e-4 * max|plain|, fp32 sums
            taken in another order; the PFB also at P = 37 and on frames
            that start unaligned, its frontend's y rows and the frontend
            alone bit for bit against their twins, and at P = 1024
            against a float64 product of the same y (1e-5 of max);
            the DFT at every compiled tile, with
            the staging of x each case took and rows that start
            unaligned; matmul the same, at the JAX suite's
            shapes and K not a multiple of 4, every compiled tile and
            both grid orders, y's TF32 planes made per call and passed
            in, each case also against a float64 product (1e-5 of its
            max), the split pass bit for bit against its plain twin,
            and rows that start unaligned; chain
            (complex and real abs2 heads), binary (also x, y and out
            as views 0-3 floats past a 16-byte boundary, cols 1 to 1024,
            n not a multiple of 4), unfold, overlap-add
            and FIR: exact equality -- the overlap-add at hops that are
            and are not multiples of 4 (6, 5, 3), on frames that start
            16-byte aligned and not, at every thread count; the FIR at
            K = 1 to 4097, with implicit padding, with the taps as given
            and reversed (``flip``), on a grid of more tiles than
            resident blocks, on outputs shorter than one tile, on strided
            rows and on rows that start 1-3 floats past a 16-byte
            boundary at every compiled tile)
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
            kernel phase's tolerances), the DFT of ``stft_overlap_add``
            (forward and inverse) and ``spectrogram`` and the matmul
            also against a float64 product (1e-5 of its max), every plan
            output dense and sharing no storage with its input, median
            times of 20 calls of the
            plan, the native plan, each kernel alone at the shape the
            path gives it, its plain version, and the one PyTorch call
            that computes the same function (``F.conv1d`` without TF32
            for the FIR, ``torch.matmul``, ``torch.add``, ``torch.mul``;
            timed here only, the port never calls them); the f32 PFB's
            two kernels apart at ``pfb_power`` full width and at
            ``cascaded_channelizer`` (the frontend alone, the DFT stage
            alone on its y, ``torch.fft.fft`` of y as the stage's
            yardstick, the call against a float64 product); the binary
            kernel alone at each of its launches' shapes (stft,
            spectrogram, the Table-1 add) beside ``torch.mul`` /
            ``torch.add`` and its bytes bound; the FIRs at K = 31, 15
            (``fir_decimate``) and 63 (``correlate``) and the matmul also
            at every tile of their tune spaces, each FIR beside its
            fp32-pipe floor (its separate multiply and add); the
            overlap-add as the plan runs it (right after the multiply
            that writes its frames) and with L2 emptied before each
            call;
            the matmul plan's first call makes y's TF32 planes and its
            second launches the GEMM alone.
            Path ``table1``: every row of the Table-1 registry at the
            ``kernel`` lowering (its one lowering for ``summation``) on
            the row's own inputs at size 2048, with the launches of that
            call, each kernel that call launched run again on the same
            inputs and held against its plain version (the kernel
            phase's tolerances), the row against its native single-node
            plan on the card (1e-4 of its max), the numpy oracle (|diff|
            <= 2e-3 + 2e-3 |oracle|) and its kernel single-node plan
            (1e-5 + 1e-5 |eager|), the matmul row also against float64
            (1e-5 of its max); once every row passed, the median
            times of both plans and the device times of each kernel and
            its plain version on the row's inputs
  int8_kernels  the four int8 kernels against their plain versions, bit
            for bit: ragged M, N, K (K < 4, K % 4 != 0), every compiled
            tile, yq's (and the DFT's Fr and Fi) K-major copies made per
            call and passed in, rows not 16-byte aligned, +-127 operands
            at K = 2048 against an int64 sum, the int8 DFM both ways, an
            odd N and L not a multiple of 16 for the DFT, K = 1 to 4097
            taps both orientations, the PFB at P = 16, 20, 37, 48, 1000
            and 1024 on frames that start 16-byte aligned and not, its
            frontend's int8 rows and scales against their plain twin, and
            inputs whose x / scale quotients are exact half-integers; the
            quantize of ``csrc/int8.cuh`` against the division it
            replaces on every float x in [-amax, amax] for some 320
            scales (``csrc/qcheck.cu``): no int may differ
  int8_main ``pfb_power`` at ``precision="int8"``, kernel lowering, full
            width: node precisions and the abs2 downgrade, launches per
            call (pfb_fused_int8 1, chain 1), the whole output against
            the int8 native plan bit for bit, row 0's SQNR against the
            numpy oracle (>= 26 dB, the pfb int8 budget), the kernel and
            the chain held against their plain versions, times of the
            plan, the native plan, the kernel (each compiled tile) and
            its plain version, and its bound (int8 ops at 1,979 TOPS or
            bytes at 3.35 TB/s); its two kernels apart (the DFT stage
            run alone on the frontend's rows, the frontend the rest),
            each beside its bound, and ``torch._int_mm`` of the DFT
            stage's contraction (also at the cascaded path)
  int8_paths  the other five pipelines at int8 at their cells' widths,
            the int8 Table-1 rows (one-node plans, each against its int8
            native plan and its op's SQNR budget) and a 4096-cubed int8
            matmul: launches, rows 0-1 against the int8 native plan for
            two rows (bit for bit; 2 ulp of max allowed where a complex
            idft recombines), row 0's SQNR (asserted for spectrogram and
            matmul, printed for the rest), each int8 kernel held against
            its plain version at the path's shapes, times (``dft_int8``
            at both its tiles), bounds and the ``torch._int_mm``
            yardstick of the int8 contraction alone (for ``dft_int8``
            one call against [Fr | Fi])
  bf16      ``pfb_power`` at ``precision="bf16"``, kernel lowering, full
            width: launches, SQNR of row 0 (>= 30 dB), plan times
  stream    every pipeline through ``graph.ChunkedRunner`` at
            ``lowering="kernel"``, f32 and int8, at its cell's full width,
            pushed in (batch, 2**18) chunks (spectrogram 2**14): launches
            of the counted run (every count set to 0 just before, read
            just after: the path's kernels once per plan call), the
            concatenated output against the offline kernel plan (int8 bit
            for bit; f32 within 1e-6 of max, the differing elements
            counted), pushes, plan calls, plans compiled, the distinct
            window lengths, the device ms of the whole stream between two
            CUDA events (warm: every window's plan compiled; and cold)
            beside the offline plan's back-to-back ms, input samples/s,
            the median and max push (CUDA events; and the median push on
            the host's clock, and a plan-cache hit of its compile alone),
            peak memory; ``pfb_power`` and
            ``fir_decimate`` once more on an irregular push schedule from
            a seeded generator, free-running and with ``step_buckets``
            (same bar; the bucketed runner must compile fewer windows)
  autotune  ``TINA_AUTOTUNE=on`` with a cache in a temporary directory:
            ``pfb_power`` at ``lowering="auto"`` and at
            ``precision="auto"`` (kernel lowering), ``fir_decimate`` at
            ``block_configs="auto"`` at f32 and int8, and the 4096-cubed
            matmul at ``block_configs="auto"``, at full width: each
            node's winner, seconds spent tuning, nodes measured, the
            kernels the tuning launched (each of the case's must launch),
            the tuned plan against the kernel plan at its tiers (bit for
            bit where every winner is that plan's lowering and tile, else
            1e-4 of max), a reduced tier that won held to its stored
            budget verdict and its op's SQNR budget on row 0, what
            ``pick_joint`` stored (times, SQNR), both plans' back-to-back
            ms; then ``TINA_AUTOTUNE=cached`` with both caches cleared:
            no new measurement, the same winners, the same output
  serve     ``PipelineService`` on the card: ``pfb_power`` at full width
            (P = 1024, M = 8, requests of 2**22 samples, batch 16,
            continuous, kernel lowering), overlapped and not in the
            order on, off, off, on, each run from an empty page-locked
            host cache: the first request alone (its batch's latency
            reported apart,
            after the plan cache and the lazily made DFT state were
            cleared), then 256 requests (64 signals, each four times)
            from 4 threads, half rt and half batch, then an int8 tenant
            (``add_tenant``) the same way with 128; every future resolves, ``replay_batches`` equal bit
            for bit on every request, three responses per tenant against
            the numpy oracle (f32 within 2e-3 of max, int8 >= 26 dB),
            launches per batch (``pfb_fused`` 1 + chain 1, int8
            ``pfb_fused_int8`` 1 + chain 1), nothing degraded or
            quarantined, the service's plans the offline plans' cache
            entries, at most two page-locked output buffers per bucket,
            the first result unchanged after every later
            batch; printed: requests/s, input samples/s, latency
            percentiles, host ms per batch by part (pack, copy in, plan,
            copy out, deliver), the card's ms per batch by part (CUDA
            events), the device track's and the card's busy share of the
            window, peak memory, beside the offline plans' back-to-back
            ms.  Then one overlapped f32 window without a replay log,
            whose clients drop each result once they have checked it
            (the rate users see).  Then faults (``TINA_FAULTS``): a
            transient fault retried once and two poison rows isolated by
            bisection, the healthy rows replayed bit for bit; an f32
            kernel bucket forced past ``degrade_after`` fails its request
            with the fault and recompiles nothing (no plain version
            stands in for a kernel on the card); an int8 kernel bucket
            degrades to the f32 kernel plan on the card, equal to it bit
            for bit.  Then ``launch.dsp_serve.main`` in
            process: the spectrogram cell at the kernel lowering (its four
            kernels once a batch, 4 responses against the oracle), at
            ``lowering="auto"`` with ``--prewarm`` in a temporary tuner
            cache, and under ``--torch-profiler`` (the top five host ops
            per batch by self time)
  mesh      every pipeline above at full width, f32 and int8, through
            ``graph.compile(..., mesh=)`` on ``make_batch_mesh(1)`` and on
            4 logical shards of the card (``BatchMesh((cuda:0,) * 4)``,
            each shard on a CUDA stream of its own; and on every card
            where there are more): bit for bit the per-shard plans run on
            each slice, launches per call the shard count times the
            unsharded plan's, outputs dense and their own; device ms of
            20 back-to-back calls and host microseconds a call, sharded
            beside unsharded; the fig3 point (batch 1 on 1 device, batch
            4 on 4 shards); pfb full streamed through
            ``ChunkedRunner(mesh=)`` on 4 shards (int8 bit for bit, f32
            within 1e-6 of max of offline); a serving window (pfb full,
            an int8 tenant) on an unsharded, a 1-device and a 4-shard
            service in the order u, 1, 4, 4, 1, u: ladder from the shard
            count, launches, oracle, replay bit for bit, requests/s
  lm        the model zoo's serving path at olmo_1b's full width (16
            layers, d_model 2048, vocab 50304, bf16 compute, f32 weights
            from a seeded CUDA generator) through ``distributed.step`` at
            the kernel lowering: batch 8 x prompt 512, then 32 greedy
            decode steps; launches (the bf16 GEMM 112 per prefill and per
            step, the f32 GEMM none: the tied unembed is a plain f32
            product); the logits against the native lowering (2e-2 of
            max) over the prefill and 4 steps fed the same tokens, and
            both beside the model at f32 compute (a diagnostic); each GEMM
            shape of the path (the model's own K-major weights) against
            ``matmul_bf16_plain`` within one bf16 ulp (``bf16_ulps``: the
            ulp floored at 2^-8 of max; also counted at |plain|, and
            against a float64 product: no more elements beyond one ulp of
            it than the plain version), timed beside ``torch.matmul`` at
            bf16 (timed here only) and its bound, the decode shapes also
            over the 16 layers' own weights in turn (no L2 reuse) and at
            every split count; each shape's route (``bf16_route``:
            skinny or tiled, splits) and the wrapper's host microseconds
            a call; prefill and decode ms,
            tokens/s, a decode step's device time by kernel group
            (``torch.profiler``; a step without a bf16 GEMM kernel
            fails), its runtime launches by launch API and the card's idle
            share; a 2-layer f32 run (the 3xTF32 GEMM) whose decode
            equals its teacher-forced forward within 2e-2
  lm_zoo    the zoo's other families at their published widths, random
            weights from a seeded CUDA generator, bf16 compute, kernel
            lowering, each model freed before the next: arctic-480b (2 of
            35 layers: 26.8 GB of experts a layer), kimi-k2 (1 of 61),
            recurrentgemma-9b (14 of 38), rwkv6-3b, internvl2-2b (256
            patches + 256 tokens) and hubert-xlarge (one encoder forward
            over 8 x 512 frames), each cut printed; batch 8 x prompt 512,
            then 8 greedy decode steps: the bf16 GEMM's launches a prefill
            and a step against the config's ``layers.linear`` calls
            (``zoo_linears``), logits kernel vs native over the prefill
            and 4 steps (2e-2 of max, or twice the native bf16 run's
            distance from the model at f32 compute where the weights are
            f32, and again on the first layers alone where the native run
            lies over 0.1 from f32 compute (rwkv6); MoE rows only where
            both runs routed the token alike in
            every layer; the tokens the kernel lowering routes otherwise
            than the plain GEMM's run at most 1 % or 1.5 times the native
            lowering's share), a MoE forward
            twice bit for bit, decode vs forward at f32 for recurrentgemma
            and rwkv6, every bf16 GEMM shape of the path within one ulp of
            its plain version (timed beside torch.matmul and its bound);
            prefill and decode ms, tokens/s, peak memory, the profiled
            decode step's busy share and top kernels, MoE drop fractions
            and aux losses
  train     the training path (``make_train_step``, ``Trainer``,
            ``launch.train``): ``step``, olmo_1b's full config (f32
            params, bf16 compute, AdamW, remat, bf16 wire, clip 1.0, native
            lowering) on batch 8 x 512 from ``SyntheticDataset(seed=0)``,
            30 steps of ``warmup_cosine``: the loss a step (the mean of the
            last 5 at least 0.5 nats below step 1's, else it fails), ms a
            step (CUDA events, median of steps 3-30), tokens/s, peak
            memory, one profiled step's busy share and runtime launches,
            the step's bound (6 N T + the remat forward's 2 N_stack T
            FLOPs at the bf16 peak, plus the update's bytes at HBM's
            rate); ``microbatch`` (the same batch at microbatch 2 and 1:
            losses within 1 %, grad norms within 5 %, peaks printed);
            ``refuses_kernel``;
            ``launcher`` (``python -m repro_torch.launch.train --full``
            for 4 steps in a subprocess: exit 0, 4 metrics lines,
            checkpoints at steps 2 and 4, step 4 restored into the
            step's specs, a leaf's bits); ``resume`` (a subprocess under
            deterministic algorithms: olmo_1b reduced to 2 layers, 6
            steps, once uninterrupted and once under
            ``run_with_auto_restart`` failing at step 3: final params bit
            for bit); ``pfb_features`` (a 64-branch 8-tap PFB at the
            kernel lowering, one ``pfb_fused`` launch held against its
            plain version, log1p|.| features into reduced hubert_xlarge:
            one masked-prediction step lowers the loss)
  kernels   the kernel table, all 13 TPU kernels and the bf16 instance of
            the GEMM (per decode step of the lm phase: its 112 launches'
            device ms, bounds, plain and torch.matmul times summed):
            launches, errors, times, the launches in the mesh phase's
            counted runs (``mesh_launches``) and the train phase's
            (``train_launches``), bounds (an f32 product at
            the TF32 tensor-core peak; a bf16 one at the bf16 peak; the fused
            PFB's FIR at the fp32 pipe beside its DFT at TF32; the
            fp32-pipe figures print beside them in the path lines)

The last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before it; without CUDA, or outside a checkout, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 bytes/s,
# fp32 FMA-pipe flop/s, and the TF32 and int8 tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12   # dense TF32 tensor-core flop/s
PEAK_INT8_OPS = 1979e12    # dense int8 tensor-core ops/s (a MAC is 2)
REPEATS = 20
SPIN_CYCLES = 20_000_000   # ~10 ms of GPU clock: covers a run's enqueue
PFB_RTOL = 1e-4       # fp32 sums of P*M terms in another order
DFT_RTOL = 1e-4       # fp32 sums of n terms in another order
DFT_F64_RTOL = 1e-5   # the 3xTF32 DFT against a float64 product (one TF32
                      # pass would be near 1e-3)
NATIVE_RTOL = 1e-4    # kernel plan vs native plan on the card
ORACLE_RTOL = 2e-3    # the reference suite's pipeline-vs-oracle tolerance
MM_RTOL = 1e-4        # fp32 sums of K terms in another order
MM_F64_RTOL = 1e-5    # the 3xTF32 GEMM against a float64 product (as the
                      # DFT's; one TF32 pass would be near 1e-3)
SWEEP_TOL = 2e-3      # Table-1 row vs numpy oracle (tests/test_opdefs.py)
PLAN_TOL = 1e-5       # Table-1 row eager vs its single-node plan
STREAM_RTOL = 1e-6    # streamed vs offline f32 plan, of max (the JAX suite's
                      # streaming bar, tests/test_graph.py); int8: bit for bit
STFT_J, STFT_HOP, STFT_X = 1024, 512, (4, 2 ** 20)
SPEC_J, SPEC_X = 64, (8, 2 ** 16)
FIR_X = (16, 2 ** 22)
CHAN_X = (16, 4_194_333)     # pipelines._chan_len(2 ** 22, 31, 16, 4)
MM_N = 4096
SWEEP_N = 2048
PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core flop/s
LM_ARCH = "olmo_1b"        # the lm phase: its full config, random weights
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 512, 32
LM_SEED = 1234
LM_RTOL = 2e-2        # kernel vs native lowering logits, of max: the JAX
                      # suite's decode tolerance (bf16 rounds at every
                      # layer; the two GEMMs sum in other f32 orders)
LM_DECODE_TOL = 2e-2  # decode vs teacher-forced forward, rtol and atol
                      # (tests/test_system.py::test_decode_matches_forward)
# the lm_zoo phase: the zoo's other families at their published widths,
# depth cut only where one card's 80 GB forces it: (arch, layers run, why)
LM_ZOO = (
    ("arctic_480b", 2, "its bf16 experts are 26.8 GB a layer "
     "(128 x 3 x 7168 x 4864 x 2 B)"),
    ("kimi_k2_1t_a32b", 1, "33.8 GB of bf16 experts a layer "
     "(384 x 3 x 7168 x 2048 x 2 B), plus 4.7 GB of embedding and head"),
    ("recurrentgemma_9b", 14, "f32 weights, their bf16 copies and 4.2 GB of "
     "prefill logits; 4 repeats of (rglru, rglru, attn) and the (rglru, "
     "rglru) tail the full model has"),
    ("rwkv6_3b", 32, None),
    ("internvl2_2b", 24, None),
    ("hubert_xlarge", 48, None),
)
# the train phase: olmo_1b's full config, batch, length, steps, schedule
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 30
TRAIN_LR, TRAIN_WARMUP, TRAIN_SEED = 1e-3, 5, 0
TRAIN_DROP = 0.5      # nats, last 5 steps' mean below step 1's: the bar of
                      # tests/test_system.py::test_train_decreases_loss
TRAIN_UPDATE_BYTES = 32   # a parameter's bytes in the update: p, g, m, v
                          # read (16), p, m, v written (12), the bf16
                          # wire's write and read (4)
# the kill/resume check, run in a subprocess under deterministic
# algorithms (tests/test_runtime.py's setup): argv[1] is a scratch dir
RESUME_SCRIPT = r"""
import json, sys
import torch
torch.use_deterministic_algorithms(True)
from repro_torch.configs import get_reduced
from repro_torch.runtime import Trainer, TrainerConfig, run_with_auto_restart
from repro_torch.tree import leaves
root = sys.argv[1]
cfg = get_reduced("olmo_1b").scaled(n_layers=2, remat=False)


def mk(wd, fail=None):
    tc = TrainerConfig(total_steps=6, batch_size=2, seq_len=16, ckpt_every=2,
                       log_every=100, async_save=False, fail_at_step=fail)
    return Trainer(cfg, tc, workdir=f"{root}/{wd}", device="cuda",
                   log_fn=lambda s: None)


ref = mk("ref")
ref.run()
made = []


def make():
    made.append(mk("sup", 3 if not made else None))
    return made[-1]


final = run_with_auto_restart(make, max_restarts=2)
a = [t.cpu() for t in leaves(ref.params)]
b = [t.cpu() for t in leaves(made[-1].params)]
print(json.dumps({
    "attempts": len(made), "final_step": final["step"],
    "bitwise": len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b)),
    "max_abs_diff": max((x - y).abs().max().item() for x, y in zip(a, b)),
    "leaves": len(a), "loss": final["loss"],
    "ref_loss": ref.metrics_log[-1]["loss"]}))
"""
ZOO_BATCH, ZOO_PROMPT, ZOO_STEPS = 8, 512, 8   # internvl2: 256 patches + 256
ZOO_FLIP_SHARE = 0.01   # MoE tokens the kernel lowering may route otherwise
                        # than its plain GEMM, beyond 1.5x the native's
ZOO_DECODE_VS_FORWARD = ("recurrentgemma_9b", "rwkv6_3b")
ZOO_CHAOTIC = 0.1       # a native bf16 run this far from the f32 model (of
                        # max) says nothing of a kernel's: check shallower


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


def flushed_ms(torch, fn, repeats: int = REPEATS) -> float:
    """Median device time of one call with L2 emptied before it: 256 MB
    (five times the H100's 50 MB L2) written between calls, each call
    timed with its own CUDA events, after one warm-up call."""
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(repeats):
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fir_floor_ms(flops: int) -> float:
    """The f32 FIR's own floor: its multiplies and adds are separate
    fp32-pipe instructions (bit-exact, never an FMA), one instruction per
    flop at half the pipe's 67 TFLOP/s FMA rate."""
    return flops / (PEAK_F32_FLOPS / 2) * 1e3


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max|got - want|, max|want|) over real views of both."""
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    return ((got - want).abs().max().item(), want.abs().max().item())


def dft_columns(n: int, hermitian: bool) -> int:
    """The columns of F a real x's product needs: all N, or where F is
    the N-point DFM (hermitian) columns 0 .. N/2, the others being their
    conjugates."""
    return n // 2 + 1 if hermitian else n


def pfb_cost(b, t, p, n, m, hermitian=False) -> tuple[int, int, int]:
    """(bytes, FIR flops, DFT flops) the fused PFB must move and do:
    frames, taps and the F columns it needs (:func:`dft_columns`; the
    plan's call is hermitian) read once, complex output written once; the
    FIR's M multiply-adds per (frame, branch), then two real products
    over those columns."""
    tout = t - m + 1
    cols = dft_columns(n, hermitian)
    nbytes = 4 * (b * t * p + m * p + 2 * p * cols) + 8 * b * tout * n
    return nbytes, 2 * m * b * tout * p, 4 * b * tout * p * cols


def dft_cost(b, l, n, cplx, hermitian=False) -> tuple[int, int]:
    """(bytes, flops) of one 4mult DFT of b rows: x and the columns of fr
    and fi it needs (:func:`dft_columns`) read once, complex64 out written
    once; two real products over those columns for a real x, four for a
    complex one."""
    cols = dft_columns(n, hermitian)
    nbytes = (8 if cplx else 4) * b * l + 8 * l * cols + 8 * b * n
    return nbytes, 2 * (4 if cplx else 2) * b * l * cols


def fir_cost(rows, n_in, n_out, k) -> tuple[int, int]:
    """(bytes, flops) of one 'valid' FIR: the rows and the taps read once,
    the output written once; a multiply and an add per tap and output."""
    return 4 * (rows * n_in + k + rows * n_out), 2 * k * rows * n_out


def bound(nbytes: int, flops: int, peak: float = PEAK_F32_FLOPS
          ) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def bound_tf32(nbytes: int, flops: int) -> tuple[float, str]:
    """The bound of an f32 product (the DFT, the GEMM): its flops at the
    TF32 tensor-core peak, the fastest rate the card has for an f32
    product, or its bytes."""
    return bound(nbytes, flops, PEAK_TF32_FLOPS)


def bound_pfb(nbytes: int, fir_flops: int, dft_flops: int
              ) -> tuple[float, str]:
    """The bound of the fused PFB: its FIR on the fp32 pipe and its two
    real DFT products at the TF32 peak, one after the other, or its
    bytes."""
    tb = nbytes / PEAK_BYTES_S
    tf = fir_flops / PEAK_F32_FLOPS + dft_flops / PEAK_TF32_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def fp32_pipe_ms(nbytes: int, *flops: int) -> float:
    """A diagnostic beside an f32 product's bound: every flop on the
    67 TFLOP/s fp32 pipe, or the bytes (the bound before the tensor
    cores ran the products)."""
    return bound(nbytes, sum(flops))[0]


def bound_3xtf32(nbytes: int, flops: int) -> tuple[float, str]:
    """A diagnostic, not the bound: the 3xTF32 method's own floor, each
    fp32 product run as three TF32 products (3 x the flops at the TF32
    peak), or the bytes."""
    return bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)


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


# entry point -> the warpgroup MMA its kernels must hold
TC_ENTRIES = {"tina_dft": "HGMMA", "tina_matmul": "HGMMA",
              "tina_matmul_bf16": "HGMMA",
              "tina_matmul_int8": "IGMMA", "tina_dft_int8": "IGMMA",
              "tina_pfb_int8": "IGMMA"}


def tc_kernel(mangled: str):
    """(entry point, label) of a tensor-core kernel of ``TC_ENTRIES``
    from its mangled name, else None; a label carries the template
    arguments: <complex x, 3mult, tile width> of the DFT, <x rows> of the
    bf16 skinny kernel, <tile width, promotion interval> of the bf16
    tiled one, the tile width of the others."""
    import re
    width = re.search(r"ILi(\d+)E", mangled)
    if "dft_tf32_kernel" in mangled:
        args = mangled.split("_kernel", 1)[1].split("Ev", 1)[0]
        flags = ",".join(re.findall(r"Lb(\d)E", args)
                         + re.findall(r"Li(\d+)E", args))
        return "tina_dft", f"dft_tf32_kernel<{flags}>"
    if "bf16_matmul_skinny_kernel" in mangled and width:
        return ("tina_matmul_bf16",
                f"bf16_matmul_skinny_kernel<{width.group(1)}>")
    if "bf16_matmul_tiled_kernel" in mangled:
        args = mangled.split("tiled_kernel", 1)[1].split("Ev", 1)[0]
        return "tina_matmul_bf16", ("bf16_matmul_tiled_kernel<"
                                    + ",".join(re.findall(r"Li(\d+)E", args))
                                    + ">")
    if "tf32_matmul_kernel" in mangled and width:
        return "tina_matmul", f"tf32_matmul_kernel<{width.group(1)}>"
    if "s8_dft_kernel" in mangled and width:
        return "tina_dft_int8", f"s8_dft_kernel<{width.group(1)}>"
    if "qpfb_dft_kernel" in mangled and width:
        return "tina_pfb_int8", f"qpfb_dft_kernel<{width.group(1)}>"
    if "qmatmul_cu" in mangled and "matmul_kernel" in mangled:
        return "tina_matmul_int8", "matmul_kernel"
    return None


def pfb_frontend_label(mangled: str):
    """The label of one of pfb.cu's frontend kernels (two bool template
    arguments; qpfb.cu's has one), else None."""
    import re
    f = re.search(r"frontend_kernelILb(\d)ELb(\d)E", mangled)
    return f"pfb_frontend_kernel<{f.group(1)},{f.group(2)}>" if f else None


def wgmma_counts(lib_path) -> tuple[dict, dict, dict]:
    """({entry point: {kernel: {"HGMMA"/"IGMMA": count}}}, {kernel of
    qpfb.cu: IDP count}, {frontend kernel of pfb.cu: warpgroup MMA
    count}): the warpgroup MMA instructions in the SASS of the kernels of
    every entry point of ``TC_ENTRIES`` in the built library, the
    ``__dp4a`` (IDP) instructions left in each kernel of the int8 PFB,
    and the warpgroup MMAs in the f32 PFB's frontend (it has none: its DFT
    stage is tina_dft's kernel), from ``cuobjdump -sass``."""
    import os
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, fn = {entry: {} for entry in TC_ENTRIES}, None
    idp, pfb = {}, None
    front, fk = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = tc_kernel(m.group(1))
            fn = out[k[0]].setdefault(k[1], {}) if k else None
            fk = pfb_frontend_label(m.group(1))
            if fk:
                front.setdefault(fk, 0)
            pfb = None
            if "qpfb_cu" in m.group(1):
                k = re.search(r"(frontend_kernel|qpfb_dft_kernel)IL[bi]"
                              r"(\d+)E", m.group(1))
                pfb = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
                idp.setdefault(pfb, 0)
            continue
        op = re.search(r"\b([HI]GMMA)\.", line)
        if fn is not None and op:
            fn[op.group(1)] = fn.get(op.group(1), 0) + 1
        if pfb is not None and re.search(r"\bIDP\.", line):
            idp[pfb] += 1
        if fk is not None and op:
            front[fk] += 1
    return out, idp, front


def simt_label(mangled: str):
    """The label of one of the f32 FIR's kernels (fir.cu, T threads a
    block) or of the overlap-add's (unfold.cu, the float4 route or
    not), else None."""
    import re
    f = re.search(r"fir_cu\S*10fir_kernelILi(\d+)E", mangled)
    if f:
        return f"fir_kernel<{f.group(1)}>"
    f = re.search(r"overlap_add_kernelILb(\d)E", mangled)
    return f"overlap_add_kernel<{f.group(1)}>" if f else None


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers", "spill_bytes"}} of the tensor-core kernels
    (``TC_ENTRIES``), of the int8 and f32 PFBs' frontends and of the f32
    FIR's and overlap-add's kernels (:func:`simt_label`), from the
    build's ``-Xptxas -v`` log."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = tc_kernel(m.group(1))
            f = re.search(r"frontend_kernelILb(\d)E", m.group(1))
            name = k[1] if k else pfb_frontend_label(m.group(1)) or (
                f"frontend_kernel<{f.group(1)}>" if f else None) or \
                simt_label(m.group(1))
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def dft_f64_err(torch, x, fr, fi, got) -> float:
    """max|got - x (fr + i fi)| over max|x (fr + i fi)|, the product taken
    in float64 on the same f32 inputs: 3xTF32 keeps it near 1e-6, one TF32
    pass would be near 1e-3."""
    xd = x.to(torch.complex128)
    frd, fid = fr.double(), fi.double()
    want = torch.complex(xd.real @ frd - xd.imag @ fid,
                         xd.real @ fid + xd.imag @ frd)
    g, w = torch.view_as_real(got).double(), torch.view_as_real(want)
    return ((g - w).abs().max() / w.abs().max()).item()


def mm_f64_err(torch, x, y, got) -> float:
    """max|got - x y| over max|x y|, the product taken in float64 on the
    same f32 inputs (the 3xTF32 GEMM's accuracy, as dft_f64_err)."""
    want = x.double() @ y.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def bound_bf16(nbytes: int, flops: int) -> tuple[float, str]:
    """The bound of a bf16 product: its flops at the dense bf16
    tensor-core peak, or its bytes."""
    return bound(nbytes, flops, PEAK_BF16_FLOPS)


def bf16_gemm_cost(m: int, k: int, n: int) -> tuple[int, int]:
    """(bytes, flops) of a bf16 GEMM: x, y read once, bf16 out written
    once; a multiply and an add per product."""
    return 2 * (m * k + k * n + m * n), 2 * m * k * n


def profile_device(torch, fn, n: int) -> dict:
    """``fn`` run ``n`` times under ``torch.profiler``: the card's kernel
    ms a run by group (the bf16 GEMMs, cuBLAS's products, softmax, the
    rest) and by kernel name, and the runtime launches a run (by launch
    API: the bf16 skinny kernel's cluster launch is
    ``cudaLaunchKernelExC``)."""
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    groups, top, by_api, launches = {}, {}, {}, 0
    for ev in events:
        if ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += ev.count
            by_api[ev.key] = by_api.get(ev.key, 0) + ev.count / n
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        ms = (getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0)) or 0.0) \
            / n / 1e3
        name = ev.key
        group = ("bf16_gemm" if "bf16_matmul" in name else
                 "cublas" if "gemm" in name or "gemv" in name else
                 "softmax" if "softmax" in name else "rest")
        groups[group] = groups.get(group, 0.0) + ms
        top[name[:72]] = top.get(name[:72], 0.0) + ms
    return {"groups": groups, "top": top, "by_api": by_api,
            "launches": launches / n}


def lm_phase(torch, dev, card, zero_counts, counts) -> dict:
    """The model zoo's serving path at ``LM_ARCH``'s full width (phase
    ``lm``); returns the kernel table's row of the bf16 GEMM."""
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import step as step_lib
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul as mmk
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib

    t_phase = time.perf_counter()
    cfg = get(LM_ARCH).scaled(tina_lowering="kernel")
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
             cfg.vocab_size, cfg.compute_dtype, cfg.param_dtype,
             cfg.tie_embeddings)
    if shape != (16, 2048, 16, 8192, 50304, "bfloat16", "float32", True):
        fail(f"lm: {LM_ARCH} is not the config this phase was written for: "
             f"{shape}")
    b, s, steps = LM_BATCH, LM_PROMPT, LM_STEPS
    max_len = s + steps
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = model_lib.prepare(model_lib.init_model(cfg, generator=gen), cfg)
    batch = {"tokens": torch.as_tensor(
        make_batch(cfg, b, s, seed=LM_SEED)["tokens"], device=dev)}
    ncfg = cfg.scaled(tina_lowering="native")
    steps_of = {c.tina_lowering: (
        step_lib.make_prefill_step(c, batch_size=b, seq_len=s),
        step_lib.make_decode_step(c, batch_size=b, cache_len=max_len))
        for c in (cfg, ncfg)}
    prefill, decode = steps_of["kernel"]

    def caches():
        return model_lib.init_caches(cfg, b, max_len, device=dev)

    # warm-up (the library's first launches, cuBLAS's handles), then the
    # counted run: counts set to 0 just before the prefill, read after it
    # and after the last decode step
    c = caches()
    _, c = prefill(params, batch, c)
    tok = torch.zeros(b, dtype=torch.int32, device=dev)
    for _ in range(2):
        tok, _, c = decode(params, tok, c)
    del c
    c = caches()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    logits0, c = prefill(params, batch, c)
    tok = torch.argmax(logits0, -1).to(torch.int32)
    e1.record()
    e1.synchronize()
    prefill_host_ms = (time.perf_counter() - t0) * 1e3
    at_prefill = counts()
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, logits, c = decode(params, tok, c)
        toks.append(tok)
    e2.record()
    e2.synchronize()
    decode_host_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    per_step = 7 * cfg.n_layers          # wq, wk, wv, wo, up, gate, down
    want_prefill = {**dict.fromkeys(launches, 0), "matmul_bf16": per_step}
    want = {**want_prefill, "matmul_bf16": per_step * (steps + 1)}
    if at_prefill != want_prefill or launches != want:
        fail(f"lm: launches {at_prefill} after the prefill and {launches} "
             f"after {steps} decode steps; want {want_prefill} and {want}")
    gen_toks = torch.stack(toks, 1)
    if tuple(gen_toks.shape) != (b, steps + 1) or not bool(
            ((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()) or \
            tuple(logits.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all() and torch.isfinite(logits0).all()):
        fail(f"lm: tokens {tuple(gen_toks.shape)}, logits "
             f"{tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    prefill_ms = e0.elapsed_time(e1)
    decode_ms = e1.elapsed_time(e2) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del c

    # the kernel lowering against the native one (torch.matmul at bf16),
    # the same weights, fed the counted run's tokens: the prefill's last
    # logits and the first 4 decode steps'
    def teacher_forced(lowering, n):
        pre, dec = steps_of[lowering]
        cc = caches()
        lg, cc = pre(params, batch, cc)
        out = [lg]
        for i in range(n):
            _, lg, cc = dec(params, gen_toks[:, i], cc)
            out.append(lg)
        return out
    kern, nat = teacher_forced("kernel", 4), teacher_forced("native", 4)
    vs_native = []
    for i, (k_, n_) in enumerate(zip(kern, nat)):
        err, scale = rel_err(torch, k_, n_)
        vs_native.append(err / scale)
        if not err <= LM_RTOL * scale:
            fail(f"lm: {'prefill' if i == 0 else f'decode step {i}'} logits "
                 f"kernel vs native {err} > {LM_RTOL} * {scale}")
    if not torch.equal(torch.argmax(kern[0], -1).to(torch.int32),
                       gen_toks[:, 0]):
        fail("lm: the prefill's greedy tokens differ between two runs of "
             "the kernel lowering")
    # a diagnostic: both bf16 lowerings against the same model computed
    # at f32 (native lowering, its own caches), fed the same tokens: how
    # far bf16 rounding alone moves the logits
    f32cfg = ncfg.scaled(compute_dtype="float32")
    steps_of["f32"] = (
        step_lib.make_prefill_step(f32cfg, batch_size=b, seq_len=s),
        step_lib.make_decode_step(f32cfg, batch_size=b, cache_len=max_len))
    c_f32 = model_lib.init_caches(f32cfg, b, max_len, device=dev)
    ref32 = [steps_of["f32"][0](params, batch, c_f32)[0]]
    for i in range(4):
        ref32.append(steps_of["f32"][1](params, gen_toks[:, i], c_f32)[1])
    vs_f32 = {name: [e / sc for e, sc in (rel_err(torch, a, r)
                                          for a, r in zip(got, ref32))]
              for name, got in (("kernel", kern), ("native", nat))}
    del kern, nat, ref32, c_f32

    # every GEMM shape of the path against the plain version, with the
    # model's own K-major weights (layer 0): within one bf16 ulp
    # (mmk.bf16_ulps; also counted at |plain| and against a float64
    # product rounded to bf16: the kernel may lie there no more often than
    # the plain f32 product), and timed beside torch.matmul and the bound;
    # each shape's route, and the wrapper's host time a call.  A decode
    # shape's weight (8.4 MB or 33.6 MB) timed alone stays in the 50 MB
    # L2: it is also timed over the 16 layers' own weights in turn
    def layer_wts(name):
        return [sb["sub0"]["attn"]["wq"]["wt"] if name == "qkvo" else
                sb["sub0"]["ffn"]["up" if name == "up_gate" else "down"]["wt"]
                for sb in params["stack"]]
    per_layer = {"qkvo": 4, "up_gate": 2, "down": 1}
    shapes, worst_abs = [], 0.0
    for rows, where in ((b * s, "prefill"), (b, "decode")):
        for name in per_layer:
            ws = layer_wts(name)
            wt = ws[0]
            n, k = wt.shape
            x = torch.randn(rows, k, device=dev, generator=gen).to(
                torch.bfloat16)
            y = wt.t()
            got = mmk.matmul(x, y, yt=wt)
            want_ = mmk.matmul_bf16_plain(x, y)
            exact = (x.double() @ y.double()).to(torch.bfloat16)
            torch.cuda.synchronize()
            ulps = mmk.bf16_ulps(got, want_).max().item()
            strict = mmk.bf16_ulps(got, want_, floor=0)
            k_exact = (mmk.bf16_ulps(got, exact, floor=0) > 1).sum().item()
            p_exact = (mmk.bf16_ulps(want_, exact, floor=0) > 1).sum().item()
            abs_err = (got.float() - want_.float()).abs().max().item()
            worst_abs = max(worst_abs, abs_err)
            if not ulps <= 1.0:
                fail(f"lm: matmul_bf16 {(rows, k, n)} is {ulps} bf16 ulps "
                     "from its plain version")
            if k_exact > p_exact:
                fail(f"lm: matmul_bf16 {(rows, k, n)}: {k_exact} elements "
                     f"beyond one bf16 ulp of the float64 product, the plain "
                     f"version {p_exact}")
            nbytes, flops = bf16_gemm_cost(rows, k, n)
            b_ms, b_by = bound_bf16(nbytes, flops)
            kind, route = mmk.bf16_route(rows, n, k)
            for _ in range(3):
                mmk.matmul(x, y, yt=wt)
            torch.cuda.synchronize()
            host = []
            for _ in range(50):      # enqueue only: no sync inside
                t1 = time.perf_counter()
                mmk.matmul(x, y, yt=wt)
                host.append(time.perf_counter() - t1)
            torch.cuda.synchronize()
            rec = {"where": where, "gemm": name, "mkn": [rows, k, n],
                   "route": kind, "splits": route.get("splits"),
                   "route_params": route,
                   "host_us_per_call": statistics.median(host) * 1e6,
                   "per_layer": per_layer[name], "max_ulps": ulps,
                   "max_ulps_at_plain": strict.max().item(),
                   "n_beyond_1_ulp_at_plain": int((strict > 1).sum()),
                   "n": got.numel(), "n_beyond_1_ulp_of_float64":
                   {"kernel": k_exact, "plain": p_exact},
                   "max_abs_err": abs_err,
                   "ms": device_ms(torch, lambda: mmk.matmul(x, y, yt=wt)),
                   "torch_matmul_ms": device_ms(
                       torch, lambda: torch.matmul(x, y)),
                   "plain_ms": device_ms(
                       torch, lambda: mmk.matmul_bf16_plain(x, y)),
                   "bound_ms": b_ms, "bound_by": b_by}
            if where == "decode":
                # the skinny kernel at every split count over the 16
                # layers' weights in turn (the route takes the fewest
                # that give a block per SM): what a split costs
                k_tiles = -(-k // mmk.BF16_BK)
                sweep = {}
                for sp in range(1, mmk.BF16_MAX_SPLITS + 1):
                    ch = -(-k_tiles // sp)
                    sp = -(-k_tiles // ch)
                    if sp in sweep:
                        continue
                    o = torch.empty(rows, n, device=dev, dtype=torch.bfloat16)

                    def split_run(sp=sp, ch=ch, o=o):
                        for w in ws:
                            _build.check(_build.lib().tina_matmul_bf16(
                                x.data_ptr(), w.data_ptr(), o.data_ptr(),
                                rows, n, k, 0, route["rows"], sp, ch,
                                torch.cuda.current_stream(dev).cuda_stream),
                                "matmul_bf16 (split sweep)")
                    sweep[sp] = device_ms(torch, split_run) / len(ws)
                rec["split_sweep_ms_16_layers_in_turn"] = sweep
                rec["ms_16_layers_in_turn"] = device_ms(
                    torch, lambda: [mmk.matmul(x, w.t(), yt=w)
                                    for w in ws]) / len(ws)
                rec["torch_matmul_ms_16_layers_in_turn"] = device_ms(
                    torch, lambda: [torch.matmul(x, w.t())
                                    for w in ws]) / len(ws)
            rec["x_torch_matmul"] = rec["ms"] / rec["torch_matmul_ms"]
            rec["x_bound"] = rec["ms"] / b_ms
            shapes.append(rec)
            emit(phase="lm", case="gemm", nvidia_smi=card, **rec)
            del x, got, want_, exact, strict

    # a decode step's 112 GEMMs, each shape's figure times its launches
    dec = [r for r in shapes if r["where"] == "decode"]

    def step_sum(key):
        return cfg.n_layers * sum(r[key] * r["per_layer"] for r in dec)

    # where a decode step's time goes: torch.profiler's kernel times and
    # runtime launches over three steps (the card's busy time), grouped
    # as the bf16 GEMMs, cuBLAS's f32 products (the decode attention's
    # two einsums and the tied unembed), the softmax and the rest
    # (norms, rope, casts, copies, residual adds); the f32 unembed alone
    # (its one product, CUDA events); beside the counted run's step
    c = caches()
    _, c = prefill(params, batch, c)
    tok = gen_toks[:, 0]
    h = torch.randn(b, 1, cfg.d_model, device=dev, generator=gen).to(
        torch.bfloat16)
    unembed_ms = device_ms(torch, lambda: layers.unembed(params["embed"], h,
                                                         cfg))
    prof_steps = 3
    prof = profile_device(torch, lambda: decode(params, tok, c), prof_steps)
    groups, top, by_api = prof["groups"], prof["top"], prof["by_api"]
    launches_rt = prof["launches"] * prof_steps
    busy = sum(groups.values())
    if busy and not groups.get("bf16_gemm"):
        fail(f"lm: the profiler found no bf16 GEMM kernel in a decode step: "
             f"{sorted(top)}")
    del c
    breakdown = {
        "step_ms": decode_ms, "step_host_ms": decode_host_ms / steps,
        "device_busy_ms": busy or None,
        "device_idle_share": 1 - busy / decode_ms if busy else None,
        "device_ms_by_group": groups,
        "bf16_gemm_share_of_device": (groups.get("bf16_gemm", 0.0) / busy
                                      if busy else None),
        "bf16_gemm_share_of_step": (groups.get("bf16_gemm", 0.0) / decode_ms
                                    if busy else None),
        "bf16_gemms_alone_ms": step_sum("ms"),
        "bf16_gemms_16_layers_in_turn_ms": step_sum("ms_16_layers_in_turn"),
        "torch_matmul_16_layers_in_turn_ms": step_sum(
            "torch_matmul_ms_16_layers_in_turn"),
        "unembed_f32_alone_ms": unembed_ms,
        "runtime_launches_per_step": launches_rt / prof_steps,
        "runtime_launches_per_step_by_api": by_api,
        "top_kernels_ms": dict(sorted(top.items(),
                                      key=lambda kv: -kv[1])[:6])}

    # reduced depth at f32 compute (the 3xTF32 GEMM): decode equals the
    # teacher-forced forward, as the JAX suite asks
    cfg32 = get(LM_ARCH).scaled(n_layers=2, compute_dtype="float32",
                                tina_lowering="kernel")
    p32 = model_lib.prepare(model_lib.init_model(cfg32, generator=gen),
                            cfg32)
    b32, s32 = 2, 64
    t32 = torch.randint(0, cfg32.vocab_size, (b32, s32), device=dev,
                        generator=gen, dtype=torch.int32)
    zero_counts()
    full, _, _ = model_lib.forward(p32, {"tokens": t32}, cfg32)
    torch.cuda.synchronize()
    f32_launches = {k_: v for k_, v in counts().items() if v}
    if f32_launches.get("matmul") != 7 * cfg32.n_layers or \
            f32_launches.get("matmul_bf16"):
        fail(f"lm f32: a forward launched {f32_launches}, want matmul "
             f"{7 * cfg32.n_layers} and no bf16 GEMM")
    c32 = model_lib.init_caches(cfg32, b32, s32, device=dev)
    _, c32, _ = model_lib.forward(p32, {"tokens": t32[:, :s32 - 4]}, cfg32,
                                  caches=c32)
    dec_err = 0.0
    for i in range(s32 - 4, s32):
        lg, c32 = model_lib.decode_step(p32, t32[:, i], c32, cfg32)
        d = (lg - full[:, i]).abs()
        dec_err = max(dec_err, d.max().item())
        if not bool((d <= LM_DECODE_TOL + LM_DECODE_TOL
                     * full[:, i].abs()).all()):
            fail(f"lm f32: decode step {i} differs from the forward by "
                 f"{d.max().item()}")
    del p32, c32, full

    emit(phase="lm", case="serve", nvidia_smi=card, arch=LM_ARCH,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         compute_dtype=cfg.compute_dtype, lowering=cfg.tina_lowering,
         batch=b, prompt=s, decode_steps=steps,
         launches_prefill=at_prefill["matmul_bf16"],
         launches_total={k_: v for k_, v in launches.items() if v},
         prefill_ms=prefill_ms, prefill_host_ms=prefill_host_ms,
         prefill_tokens_per_s=b * s / (prefill_ms / 1e3),
         decode_ms_per_step=decode_ms,
         decode_host_ms_per_step=decode_host_ms / steps,
         decode_tokens_per_s=b / (decode_ms / 1e3),
         kernel_vs_native_rel_err=vs_native,
         bf16_vs_f32_compute_rel_err=vs_f32, peak_memory_gb=peak_gb,
         first_tokens=gen_toks[0, :8].tolist(),
         decode_breakdown=breakdown,
         f32_reduced={"layers": cfg32.n_layers, "batch": b32, "seq": s32,
                      "forward_launches": f32_launches,
                      "decode_vs_forward_max_abs": dec_err},
         seconds=time.perf_counter() - t_phase)
    return {"name": "matmul_bf16", "route": "cuda",
            "source": "src/repro_torch/csrc/bf16_gemm.cu",
            "replaces": "src/repro/kernels/matmul.py:122",
            "launches": launches["matmul_bf16"], "max_abs_err": worst_abs,
            "ms": step_sum("ms"), "plain_ms": step_sum("plain_ms"),
            "bound_ms": step_sum("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in dec) else "operations",
            "library_ms": step_sum("torch_matmul_ms")}


class MoeRoutes:
    """While open, every MoE block's routing is kept (its experts and
    which of them kept each token, per layer, in call order); ``take``
    returns those of the calls since the last one."""

    def __init__(self, moe_lib):
        self.moe_lib, self.log = moe_lib, []

    def __enter__(self):
        self.real = real = self.moe_lib.moe_block

        def recording(p, x, cfg):
            y, aux = real(p, x, cfg)
            # the router's margin at the cut: the k-th largest probability
            # less the (k+1)-th (a near tie flips on an ulp of x)
            k = cfg.n_experts_per_token
            probs = router_top(x, p["router"]["w"], k + 1)
            self.log.append({**aux, "margin": probs[:, k - 1] - probs[:, k]})
            return y, aux

        self.moe_lib.moe_block = recording
        return self

    def __exit__(self, *exc):
        self.moe_lib.moe_block = self.real

    def take(self) -> list:
        out, self.log = self.log, []
        return out


def router_top(x, w, n: int):
    """The n largest router probabilities of each token, descending: the
    MoE block's f32 router on x."""
    xt = x.reshape(-1, x.shape[-1]).float()
    probs = (xt @ w.float()).softmax(-1)
    return probs.sort(-1, descending=True).values[:, :n]


def zoo_linears(cfg, prefill: bool) -> int:
    """The ``layers.linear`` calls (bf16 GEMM launches at the kernel
    lowering) of one call of ``cfg``'s model: attention 4 and its MLP
    (SwiGLU/GeGLU 3, GELU 2; a MoE block's shared expert and dense
    residual MLP 3 each, its experts and router none), an RG-LRU block 5
    and its MLP, an RWKV block 5 (time mix) + 3 (channel mix), the
    frontend's projection once a prefill; the untied head is an f32
    product (none)."""
    mlp = 2 if cfg.mlp_type == "gelu" else 3
    ffn = 3 * (bool(cfg.shared_experts) + bool(cfg.dense_residual_ff)) \
        if cfg.moe else mlp
    per = {"attn": 4 + ffn, "rglru": 5 + mlp, "rwkv": 8}
    return sum(per[k] for k in cfg.layer_kinds) + \
        (1 if prefill and cfg.frontend else 0)


def lm_zoo_config(torch, dev, card, zero_counts, counts, arch: str,
                  layers_run: int, why) -> int:
    """One config of the ``lm_zoo`` phase; returns the bf16 GEMM's
    launches in its counted run."""
    from repro_torch.configs import get
    from repro_torch.data.pipeline import make_batch
    from repro_torch.distributed import step as step_lib
    from repro_torch.kernels import matmul as mmk
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib

    t_cfg = time.perf_counter()
    full = get(arch)
    cfg = full.scaled(n_layers=layers_run, tina_lowering="kernel")
    if cfg.compute_dtype != "bfloat16":
        fail(f"lm_zoo: {arch} computes in {cfg.compute_dtype}, not bfloat16")
    encoder = cfg.family == "audio"
    b, s, steps = ZOO_BATCH, ZOO_PROMPT, ZOO_STEPS
    max_len = s + steps
    emit(phase="lm_zoo", case="config", arch=arch, family=cfg.family,
         layers=layers_run, of_layers=full.n_layers, depth_cut=why,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         experts=cfg.n_experts, top_k=cfg.n_experts_per_token,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = model_lib.prepare(model_lib.init_model(cfg, generator=gen), cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             make_batch(cfg, b, s, seed=LM_SEED).items()}
    ncfg = cfg.scaled(tina_lowering="native")
    prefill = step_lib.make_prefill_step(cfg, batch_size=b, seq_len=s)
    decode = step_lib.make_decode_step(cfg, batch_size=b, cache_len=max_len)

    def caches(c=cfg):
        return model_lib.init_caches(c, b, max_len, device=dev)

    def encode(c=cfg):
        return model_lib.forward(params, batch, c)

    # warm-up, then the counted run: counts set to 0 just before the
    # prefill (the encoder's forward), read after it and after the last
    # decode step; each bf16 GEMM's (M, K, N) and weight noted
    if encoder:
        encode()
    else:
        _, c = prefill(params, batch, caches())
        decode(params, torch.zeros(b, dtype=torch.int32, device=dev), c)
        del c
    shapes, real = {}, mmk._matmul_bf16

    def noting(x, y, yt, *rest):
        shapes.setdefault((x.shape[0], x.shape[1], y.shape[1]),
                          y.t().contiguous() if yt is None else yt)
        return real(x, y, yt, *rest)

    c = None if encoder else caches()
    torch.cuda.synchronize()
    mmk._matmul_bf16 = noting
    try:
        with MoeRoutes(moe_lib) as routes:
            zero_counts()
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
            t0 = time.perf_counter()
            e0.record()
            if encoder:
                logits0, _, aux = encode()
            else:
                logits0, c = prefill(params, batch, c)
            e1.record()
            e1.synchronize()
            prefill_host_ms = (time.perf_counter() - t0) * 1e3
            at_prefill = counts()
            prefill_routes = routes.take()
            toks = [torch.argmax(logits0, -1).to(torch.int32)]
            t0 = time.perf_counter()
            for _ in range(0 if encoder else steps):
                tok, logits, c = decode(params, toks[-1], c)
                toks.append(tok)
            e2.record()
            e2.synchronize()
            decode_host_ms = (time.perf_counter() - t0) * 1e3
            launches = counts()
    finally:
        mmk._matmul_bf16 = real
    want_pre = zoo_linears(cfg, True)
    want_step = zoo_linears(cfg, False)
    want_total = want_pre + (0 if encoder else steps * want_step)
    other = {k: v for k, v in launches.items() if v and k != "matmul_bf16"}
    if at_prefill["matmul_bf16"] != want_pre or \
            launches["matmul_bf16"] != want_total or other:
        fail(f"lm_zoo {arch}: bf16 GEMM launches {at_prefill['matmul_bf16']} "
             f"after the prefill and {launches['matmul_bf16']} in all, want "
             f"{want_pre} and {want_total}; other kernels {other}")
    if encoder:
        finite = bool(torch.isfinite(logits0).all())
        if tuple(logits0.shape) != (b, s, cfg.vocab_size) or not finite:
            fail(f"lm_zoo {arch}: encoder logits {tuple(logits0.shape)}, "
                 f"finite {finite}")
    else:
        gen_toks = torch.stack(toks, 1)
        if tuple(gen_toks.shape) != (b, steps + 1) or not bool(
                ((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()) or \
                tuple(logits.shape) != (b, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all() and
                torch.isfinite(logits0).all()):
            fail(f"lm_zoo {arch}: tokens {tuple(gen_toks.shape)}, logits "
                 f"{tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
    prefill_ms = e0.elapsed_time(e1)
    decode_ms = None if encoder else e1.elapsed_time(e2) / steps
    moe = {}
    if cfg.moe:
        moe = {"drop_frac_per_layer": [float(a["moe_drop_frac"])
                                       for a in prefill_routes],
               "aux_loss_per_layer": [float(a["moe_aux_loss"])
                                      for a in prefill_routes],
               "capacity_prefill": moe_lib.capacity(b * s, cfg),
               "capacity_decode": moe_lib.capacity(b, cfg)}
    del logits0
    if not encoder:
        del c

    # the kernel lowering against the native one (torch.matmul at bf16),
    # the same weights, fed the counted run's tokens: the prefill's last
    # logits and 4 decode steps' (the encoder: its forward).  Where the
    # weights are f32, the model at f32 compute (native) too: the bar is
    # LM_RTOL or twice the native bf16 run's distance from it, whichever
    # is larger (a bf16 run's own rounding noise, which these models
    # amplify with depth).  MoE (bf16 weights, no f32 run): the rows
    # compared are those whose tokens routed alike (experts and kept
    # slots) in every layer in both runs.  A near tie in the router flips
    # on an ulp of its input, so the share of tokens routed otherwise is
    # held against a control: the kernel lowering against the plain
    # version of its GEMM (exact products summed in f32, rounded once)
    # may flip no more than LM_ZOO_FLIP_SHARE or 1.5 times what the
    # native lowering flips against it
    def teacher_forced(c_, plain=False):
        real = mmk._matmul_bf16
        if plain:
            mmk._matmul_bf16 = lambda x, y, *rest: mmk.matmul_bf16_plain(x, y)
        try:
            with MoeRoutes(moe_lib) as r:
                if encoder:
                    out = [model_lib.forward(params, batch, c_)[0]]
                    return out, [r.take()]
                pre = step_lib.make_prefill_step(c_, batch_size=b, seq_len=s)
                dec = step_lib.make_decode_step(c_, batch_size=b,
                                                cache_len=max_len)
                cc = caches(c_)
                lg, cc = pre(params, batch, cc)
                out, rts = [lg], [r.take()]
                for i in range(4):
                    _, lg, cc = dec(params, gen_toks[:, i], cc)
                    out.append(lg)
                    rts.append(r.take())
                return out, rts
        finally:
            mmk._matmul_bf16 = real

    def alike(ra, rb, tally=None):
        """Per call, which tokens routed alike in every layer."""
        out = []
        for ca, cb in zip(ra, rb):
            same = torch.ones(ca[0]["moe_experts"].shape[0],
                              dtype=torch.bool, device=dev)
            for li, (la, lb) in enumerate(zip(ca, cb)):
                same_e = (la["moe_experts"] == lb["moe_experts"]).all(-1)
                same_k = (la["moe_kept"] == lb["moe_kept"]).all(-1)
                if tally is not None:
                    tally["experts_per_layer"][li] += int((~same_e).sum())
                    tally["kept_only_per_layer"][li] += int(
                        (same_e & ~same_k).sum())
                    if bool((~same_e).any()):
                        tally["max_margin_of_flipped"] = max(
                            tally["max_margin_of_flipped"],
                            lb["margin"][~same_e].max().item())
                same &= same_e & same_k
            out.append(same)
        return out

    def share(rows):
        return sum(int((~r).sum()) for r in rows) / sum(r.numel()
                                                        for r in rows)

    kern, kroutes = teacher_forced(cfg)
    nat, nroutes = teacher_forced(ncfg)
    ref32 = None
    if cfg.param_dtype == "float32":
        ref32, _ = teacher_forced(ncfg.scaled(compute_dtype="float32"))
    flips = None
    if cfg.moe:
        flips = {"experts_per_layer": [0] * cfg.n_layers,
                 "kept_only_per_layer": [0] * cfg.n_layers,
                 "max_margin_of_flipped": 0.0,
                 "median_margin": torch.cat(
                     [la["margin"] for c_ in nroutes for la in c_]
                 ).median().item()}
        kn = alike(kroutes, nroutes, flips)
        _, proutes = teacher_forced(cfg, plain=True)
        flips.update(tokens=sum(r.numel() for r in kn),
                     share_kernel_vs_native=share(kn),
                     share_kernel_vs_plain=share(alike(kroutes, proutes)),
                     share_native_vs_plain=share(alike(nroutes, proutes)))
        del proutes
    def hold_logits(kern, nat, ref32, label):
        """Each call's kernel logits against the native ones: (errors,
        native bf16 vs f32 compute, bars)."""
        vs, dref, bars = [], [], []
        for i, (k_, n_) in enumerate(zip(kern, nat)):
            rows = torch.ones(k_.shape[:-1], dtype=torch.bool, device=dev)
            if cfg.moe:
                rows = kn[i].view(b, -1)[:, -1]
            err, scale = rel_err(torch, k_[rows], n_[rows])
            d = None
            if ref32 is not None:
                e32, s32 = rel_err(torch, n_, ref32[i])
                d = e32 / s32
            bar = LM_RTOL if d is None else max(LM_RTOL, 2 * d)
            vs.append(err / scale)
            dref.append(d)
            bars.append(bar)
            if not err <= bar * scale:
                what = "forward" if encoder else \
                    "prefill" if i == 0 else f"decode step {i}"
                fail(f"lm_zoo {arch}{label}: {what} logits kernel vs native "
                     f"{err} > {bar} * {scale} (native bf16 vs f32 compute: "
                     f"{d})")
        return vs, dref, bars

    vs_native, d_ref, bars = hold_logits(kern, nat, ref32, "")
    # where the native bf16 run lies farther than ZOO_CHAOTIC from the f32
    # model, that comparison says nothing of the kernel: it is made again
    # on the first repeat of the block pattern, the same weights
    first = None
    if ref32 is not None and max(d_ref) > ZOO_CHAOTIC:
        c1 = cfg.scaled(n_layers=len(cfg.block_pattern))
        runs1 = [teacher_forced(c_)[0] for c_ in (
            c1, c1.scaled(tina_lowering="native"),
            c1.scaled(tina_lowering="native", compute_dtype="float32"))]
        errs, drefs, bars1 = hold_logits(*runs1, " (first layers)")
        first = {"layers": c1.n_layers, "kernel_vs_native_rel_err": errs,
                 "native_bf16_vs_f32_compute_rel_err": drefs, "bars": bars1}
        del runs1
    del kern, nat, ref32

    # MoE: the prefill replays bit for bit (the combine adds each token's
    # contributions in a fixed order: no atomics)
    replay = None
    if cfg.moe:
        r1, _, a1 = model_lib.forward(params, batch, cfg)
        r2, _, a2 = model_lib.forward(params, batch, cfg)
        replay = bool(torch.equal(r1, r2)) and all(
            bool(torch.equal(a1[k], a2[k])) for k in a1)
        if not replay:
            fail(f"lm_zoo {arch}: two forwards of the same batch differ")
        moe["forward_drop_frac"] = float(a1["moe_drop_frac"])
        moe["forward_aux_loss"] = float(a1["moe_aux_loss"])
        del r1, r2

    # decode equals the teacher-forced forward at f32 compute (the
    # 3xTF32 GEMM), the JAX suite's set (recurrentgemma, rwkv6)
    dec_err = None
    if arch in ZOO_DECODE_VS_FORWARD:
        c32 = cfg.scaled(compute_dtype="float32")
        b32, s32 = 2, 64
        t32 = torch.randint(0, cfg.vocab_size, (b32, s32), device=dev,
                            generator=gen, dtype=torch.int32)
        whole, _, _ = model_lib.forward(params, {"tokens": t32}, c32)
        cc = model_lib.init_caches(c32, b32, s32, device=dev)
        _, cc, _ = model_lib.forward(params, {"tokens": t32[:, :s32 - 4]},
                                     c32, caches=cc)
        dec_err = 0.0
        for i in range(s32 - 4, s32):
            lg, cc = model_lib.decode_step(params, t32[:, i], cc, c32)
            d = (lg - whole[:, i]).abs()
            dec_err = max(dec_err, d.max().item())
            if not bool((d <= LM_DECODE_TOL + LM_DECODE_TOL
                         * whole[:, i].abs()).all()):
                fail(f"lm_zoo {arch} f32: decode step {i} differs from the "
                     f"forward by {d.max().item()}")
        del whole, cc

    # every bf16 GEMM shape of the path against the plain version (the
    # model's own K-major weights): within one bf16 ulp; timed beside
    # torch.matmul at bf16 (timed here only), the plain version and the
    # bound
    gemms = []
    for (m, k, n), wt in sorted(shapes.items()):
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        y = wt.t()
        got = mmk.matmul(x, y, yt=wt)
        want_ = mmk.matmul_bf16_plain(x, y)
        ulps = mmk.bf16_ulps(got, want_).max().item()
        if not ulps <= 1.0:
            fail(f"lm_zoo {arch}: matmul_bf16 {(m, k, n)} is {ulps} bf16 "
                 "ulps from its plain version")
        nbytes, flops = bf16_gemm_cost(m, k, n)
        b_ms, b_by = bound_bf16(nbytes, flops)
        kind, route = mmk.bf16_route(m, n, k)
        rec = {"mkn": [m, k, n], "route": kind,
               "splits": route.get("splits"), "max_ulps": ulps,
               "max_abs_err": (got.float() - want_.float()).abs().max().item(),
               "ms": device_ms(torch, lambda: mmk.matmul(x, y, yt=wt)),
               "torch_matmul_ms": device_ms(torch, lambda: torch.matmul(x, y)),
               "plain_ms": device_ms(torch,
                                     lambda: mmk.matmul_bf16_plain(x, y)),
               "bound_ms": b_ms, "bound_by": b_by}
        rec["x_bound"] = rec["ms"] / b_ms
        gemms.append(rec)
        del x, got, want_

    # where a decode step's time goes (torch.profiler over 3 steps), or
    # the encoder's forward
    if encoder:
        prof = profile_device(torch, encode, 1)
        step_ms = prefill_ms
    else:
        c = caches()
        _, c = prefill(params, batch, c)
        tok = gen_toks[:, 0]
        prof = profile_device(torch, lambda: decode(params, tok, c), 3)
        step_ms = decode_ms
        del c
    busy = sum(prof["groups"].values())
    if busy and not prof["groups"].get("bf16_gemm"):
        fail(f"lm_zoo {arch}: the profiler found no bf16 GEMM kernel: "
             f"{sorted(prof['top'])}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit(phase="lm_zoo", case="serve", nvidia_smi=card, arch=arch,
         layers=layers_run, batch=b, prompt=s,
         decode_steps=0 if encoder else steps,
         lowering=cfg.tina_lowering, weights_gb=weights_gb,
         build_seconds=build_s,
         launches_prefill={"got": at_prefill["matmul_bf16"],
                           "want": want_pre},
         launches_per_step={"got": None if encoder else
                            (launches["matmul_bf16"] - want_pre) / steps,
                            "want": None if encoder else want_step},
         prefill_ms=prefill_ms, prefill_host_ms=prefill_host_ms,
         prefill_tokens_per_s=b * s / (prefill_ms / 1e3),
         decode_ms_per_step=decode_ms,
         decode_host_ms_per_step=None if encoder else decode_host_ms / steps,
         decode_tokens_per_s=None if encoder else b / (decode_ms / 1e3),
         kernel_vs_native_rel_err=vs_native,
         native_bf16_vs_f32_compute_rel_err=d_ref, bars=bars,
         first_layers=first,
         moe_routing=flips,
         moe_replay_bit_for_bit=replay, moe=moe or None,
         decode_vs_forward_f32_max_abs=dec_err,
         peak_memory_gb=peak_gb,
         profiled={"what": "forward" if encoder else "decode step",
                   "ms": step_ms, "device_busy_ms": busy or None,
                   "device_idle_share": 1 - busy / step_ms if busy else None,
                   "device_ms_by_group": prof["groups"],
                   "runtime_launches": prof["launches"],
                   "top_kernels_ms": dict(sorted(
                       prof["top"].items(), key=lambda kv: -kv[1])[:6])},
         gemm_shapes=gemms,
         seconds=time.perf_counter() - t_cfg)
    if flips and flips["share_kernel_vs_plain"] > max(
            ZOO_FLIP_SHARE, 1.5 * flips["share_native_vs_plain"]):
        fail(f"lm_zoo {arch}: the kernel lowering routes "
             f"{flips['share_kernel_vs_plain']:.4f} of tokens otherwise than "
             f"the plain GEMM, the native lowering "
             f"{flips['share_native_vs_plain']:.4f}")
    return launches["matmul_bf16"]


def lm_zoo_phase(torch, dev, card, zero_counts, counts) -> dict:
    """The model zoo's other families (phase ``lm_zoo``); returns each
    config's bf16 GEMM launches in its counted run."""
    t_phase = time.perf_counter()
    out = {}
    for arch, layers_run, why in LM_ZOO:
        out[arch] = lm_zoo_config(torch, dev, card, zero_counts, counts,
                                  arch, layers_run, why)
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="lm_zoo", case="done", launches=out,
         seconds=time.perf_counter() - t_phase)
    return out


def train_phase(torch, dev, card, zero_counts, counts) -> dict:
    """The training path at olmo_1b's full width and its checks (phase
    ``train``); returns each kernel's launches in its counted runs."""
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get, get_reduced
    from repro_torch.core import pfb_full, pfb_window
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import step as step_lib
    from repro_torch.kernels import ops
    from repro_torch.kernels import pfb as pfbk
    from repro_torch.models import convert
    from repro_torch.models import model as model_lib
    from repro_torch.optim import constant, make_optimizer, warmup_cosine
    from repro_torch.tree import flatten_with_path, leaves

    t_phase = time.perf_counter()
    cfg = get(LM_ARCH)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
             cfg.vocab_size, cfg.compute_dtype, cfg.param_dtype,
             cfg.tie_embeddings, cfg.tina_lowering, cfg.remat,
             cfg.optimizer, cfg.opt_state_dtype)
    if shape != (16, 2048, 16, 8192, 50304, "bfloat16", "float32", True,
                 "native", True, "adamw", "float32"):
        fail(f"train: {LM_ARCH} is not the config this phase was written "
             f"for: {shape}")
    b, s, n_steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    lr_fn = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, n_steps)
    fn, specs = step_lib.make_train_step(cfg, batch_size=b, seq_len=s,
                                         lr_fn=lr_fn, grad_wire="bf16",
                                         device=dev)
    params = convert.stack_params(model_lib.init_model(
        cfg, seed=TRAIN_SEED, device=dev))
    st = make_optimizer(cfg, lr_fn).init(params)
    n_params = sum(t.numel() for t in leaves(params))
    n_stack = sum(t.numel() for t in leaves(params["stack"]))
    data = SyntheticDataset(cfg, b, s, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data[i].items()}
               for i in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    zero_counts()
    losses, step_ms, gnorms = [], [], []
    for i in range(n_steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, st, m = fn(params, st, batches[i])
        e1.record()
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    for k, v in counts().items():
        launches[k] = launches.get(k, 0) + v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        fail(f"train step: a loss is not finite: {losses}")
    last5 = statistics.mean(losses[-5:])
    if not last5 <= losses[0] - TRAIN_DROP:
        fail(f"train step: the last 5 steps' mean loss {last5} is not "
             f"{TRAIN_DROP} nats below step 1's {losses[0]}")
    ms = statistics.median(step_ms[2:])
    prof = profile_device(torch, lambda: fn(params, st, batches[0]), 1)
    busy = sum(prof["groups"].values())
    tokens = b * s
    flops = 6 * n_params * tokens + 2 * n_stack * tokens
    upd_bytes = TRAIN_UPDATE_BYTES * n_params
    bound_ms = (flops / PEAK_BF16_FLOPS + upd_bytes / PEAK_BYTES_S) * 1e3
    emit(phase="train", case="step", nvidia_smi=card, arch=LM_ARCH,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         params=n_params, stack_params=n_stack,
         param_leaves=len(leaves(params)), compute_dtype=cfg.compute_dtype,
         lowering=cfg.tina_lowering, remat=cfg.remat, grad_wire="bf16",
         optimizer=cfg.optimizer, batch=b, seq=s, steps=n_steps,
         lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, losses=losses,
         grad_norms=gnorms, last5_mean_loss=last5,
         drop_nats=losses[0] - last5, ms_per_step=ms,
         ms_per_step_all=step_ms, first_step_ms=step_ms[0],
         tokens_per_s=tokens / (ms / 1e3), peak_memory_gb=peak_gb,
         device_busy_ms=busy or None,
         device_busy_share=busy / ms if busy else None,
         runtime_launches_per_step=prof["launches"],
         runtime_launches_by_api=prof["by_api"], device_ms_by_group=
         prof["groups"], top_kernels_ms=dict(sorted(
             prof["top"].items(), key=lambda kv: -kv[1])[:8]),
         bound_ms=bound_ms, bound_flops=flops, bound_update_bytes=upd_bytes,
         bound_flops_ms=flops / PEAK_BF16_FLOPS * 1e3,
         bound_bytes_ms=upd_bytes / PEAK_BYTES_S * 1e3,
         launches={k: v for k, v in launches.items() if v})

    # microbatch: the same batch in 2 slices against 1, on copies
    mb = {}
    for k in (1, 2):
        fk, _ = step_lib.make_train_step(cfg, batch_size=b, seq_len=s,
                                         lr_fn=lr_fn, microbatch=k,
                                         donate=False, device=dev)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, _, mk = fk(params, st, batches[0])
        mb[k] = {"loss": float(mk["loss"]), "grad_norm":
                 float(mk["grad_norm"]),
                 "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    d_loss = abs(mb[2]["loss"] - mb[1]["loss"])
    d_norm = abs(mb[2]["grad_norm"] - mb[1]["grad_norm"])
    # the peaks are printed, not held: remat leaves little activation
    # memory to halve, and the f32 accumulator adds a set of gradients
    if not (d_loss <= 1e-2 * mb[1]["loss"]
            and d_norm <= 5e-2 * mb[1]["grad_norm"]):
        fail(f"train microbatch: 2 slices against 1: {mb}")
    emit(phase="train", case="microbatch", batch=b, seq=s, runs=mb,
         loss_abs_diff=d_loss, grad_norm_abs_diff=d_norm,
         grad_norm_rel_diff=d_norm / mb[1]["grad_norm"])

    # the kernel lowering has no gradient: refused
    try:
        step_lib.make_train_step(cfg.scaled(tina_lowering="kernel"),
                                 batch_size=b, seq_len=s, device=dev)
    except ValueError as e:
        refused = str(e)
    else:
        fail("train: make_train_step accepted tina_lowering='kernel'")
    emit(phase="train", case="refuses_kernel", error=refused[:120])
    del params, st, batches, fn
    gc.collect()
    torch.cuda.empty_cache()

    # launch.train --full in a subprocess, then its checkpoint restored;
    # its two checkpoints (14 GB each) go to the checkout's build/, the
    # disk the kernels build on, and are removed after
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        wd = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             LM_ARCH, "--full", "--steps", "4", "--batch-size", str(b),
             "--seq-len", str(s), "--ckpt-every", "2", "--workdir", wd],
            cwd=str(ROOT), env=env, capture_output=True, text=True,
            timeout=600)
        launcher_s = time.perf_counter() - t0
        if run.returncode != 0:
            fail(f"train launcher: exit {run.returncode}: "
                 f"{run.stderr[-2000:]}")
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        mgr = CheckpointManager(os.path.join(wd, "ckpt"))
        if len(lines) != 4 or mgr.steps() != [2, 4]:
            fail(f"train launcher: {len(lines)} metrics lines, checkpoints "
                 f"at {mgr.steps()}; want 4 and [2, 4]")
        t0 = time.perf_counter()
        tree, meta = mgr.restore({"params": specs.params,
                                  "opt_state": specs.opt_state}, step=4,
                                 device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want = {k: tuple(t.shape) for k, t in flatten_with_path(
            {"params": specs.params, "opt_state": specs.opt_state})}
        got = dict(flatten_with_path(tree))
        if {k: tuple(t.shape) for k, t in got.items()} != want or \
                any(not t.is_cuda for t in got.values()):
            fail("train launcher: the restored tree's shapes or devices "
                 "differ from the step's specs")
        key = "params/embed/table"
        on_disk = np.load(os.path.join(mgr.path(4), "params__embed__table"
                                       ".npy"))
        bits = np.array_equal(got[key].cpu().numpy().view(np.int32),
                              on_disk.view(np.int32))
        count = int(got["opt_state/count"])
        if not bits or count != 4 or meta.get("step") != 4:
            fail(f"train launcher: step 4 restored with count {count}, "
                 f"metadata {meta}, {key} bit for bit: {bits}")
        ckpt_gb = sum(os.path.getsize(os.path.join(mgr.path(4), f))
                      for f in os.listdir(mgr.path(4))) / 1e9
        del tree, got
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="train", case="launcher", arch=LM_ARCH, full=True, steps=4,
         batch=b, seq=s, exit=run.returncode, seconds=launcher_s,
         metrics_lines=len(lines), losses=[m["loss"] for m in lines],
         step_s=[m["step_time"] for m in lines], checkpoints=[2, 4],
         checkpoint_gb=ckpt_gb, restore_s=restore_s, leaves=len(want),
         leaf_bits_equal=bits, restored_count=count)

    # kill/resume bit for bit, deterministic, in a subprocess of its own
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", RESUME_SCRIPT, tmp], cwd=str(ROOT),
            env={**env, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
            capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        fail(f"train resume: exit {run.returncode}: {run.stderr[-2000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    if not (res["bitwise"] and res["attempts"] == 2
            and res["final_step"] == 6):
        fail(f"train resume: {res}")
    emit(phase="train", case="resume", arch=LM_ARCH, layers=2,
         reduced=True, steps=6, batch=2, seq=16, ckpt_every=2,
         fail_at_step=3, deterministic=True,
         seconds=time.perf_counter() - t0, **res)

    # the paper's PFB features into a masked-prediction step (the twin of
    # examples/pfb_features.py): the PFB at the kernel lowering
    rng = np.random.default_rng(0)
    p_br, m_taps, bsz, n_frames = 64, 8, 2, 256
    n_samples = p_br * (n_frames + m_taps - 1)
    t = np.arange(n_samples)
    sig = sum(np.sin(2 * np.pi * f * t + ph)
              for f, ph in [(0.031, 0.0), (0.125, 1.0), (0.307, 2.0)])
    sig = torch.as_tensor(sig + 0.1 * rng.standard_normal((bsz, n_samples)),
                          dtype=torch.float32, device=dev)
    taps = torch.as_tensor(pfb_window(p_br, m_taps), dtype=torch.float32,
                           device=dev)
    zero_counts()
    spectra = pfb_full(sig, taps, lowering="kernel")
    torch.cuda.synchronize()
    pfb_launches = {k: v for k, v in counts().items() if v}
    for k, v in pfb_launches.items():
        launches[k] = launches.get(k, 0) + v
    if pfb_launches != {"pfb_fused": 1}:
        fail(f"train pfb_features: the PFB launched {pfb_launches}, want "
             f"pfb_fused once")
    fr, fi = ops._fourier(p_br, str(dev))
    plain = pfbk.pfb_fused_plain(ops._frames(sig, p_br),
                                 taps.flip(0).contiguous(), fr, fi)
    pfb_err = hold(torch, "train pfb_features pfb_fused", spectra,
                   plain.reshape(spectra.shape), PFB_RTOL)
    logmag = torch.log1p(spectra.abs()).float()
    hcfg = get_reduced("hubert_xlarge")
    feat = model_lib.AUDIO_FEAT_DIM
    frames = logmag.repeat(1, 1, -(-feat // p_br))[..., :feat].contiguous()
    targets = torch.as_tensor(rng.integers(0, hcfg.vocab_size,
                                           frames.shape[:2]),
                              dtype=torch.int32, device=dev)
    mask = torch.as_tensor(rng.random(frames.shape[:2]) < 0.3, device=dev)
    hbatch = {"frames": frames, "targets": targets, "mask": mask}
    hfn, _ = step_lib.make_train_step(hcfg, batch_size=bsz,
                                      seq_len=frames.shape[1],
                                      lr_fn=constant(1e-3), grad_wire="none",
                                      device=dev)
    hp = convert.stack_params(model_lib.init_model(hcfg, seed=0,
                                                   device=dev))
    hst = make_optimizer(hcfg, constant(1e-3)).init(hp)
    hp, hst, hm = hfn(hp, hst, hbatch)
    with torch.no_grad():
        loss2, _ = model_lib.loss_fn(convert.unstack_views(hp), hbatch, hcfg)
    loss1, loss2 = float(hm["loss"]), float(loss2)
    if not loss2 < loss1:
        fail(f"train pfb_features: one step took the loss {loss1} to "
             f"{loss2}")
    emit(phase="train", case="pfb_features", x=[bsz, n_samples], p=p_br,
         m=m_taps, spectra=list(spectra.shape), launches=pfb_launches,
         pfb_max_abs_err=pfb_err,
         pfb_max_abs_plain=torch.view_as_real(plain).abs().max().item(),
         features=list(frames.shape), masked_frames=float(hm["tokens"]),
         loss_before=loss1, loss_after=loss2)
    emit(phase="train", case="done", launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


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
        pfbk.LAUNCHES = pfbk.FRONTEND_LAUNCHES = 0
        ew.LAUNCHES = ew.BINARY_LAUNCHES = 0
        dftk.LAUNCHES = unfk.LAUNCHES = unfk.OLA_LAUNCHES = 0
        firk.LAUNCHES = mmk.LAUNCHES = mmk.PLANES_LAUNCHES = 0
        mmk.INT8_LAUNCHES = dftk.INT8_LAUNCHES = mmk.BF16_LAUNCHES = 0
        firk.INT8_LAUNCHES = pfbk.INT8_LAUNCHES = 0

    def counts() -> dict:
        return {"pfb_fused": pfbk.LAUNCHES,
                "pfb_frontend": pfbk.FRONTEND_LAUNCHES,
                "elementwise_chain": ew.LAUNCHES,
                "elementwise_binary": ew.BINARY_LAUNCHES,
                "dft": dftk.LAUNCHES, "unfold": unfk.LAUNCHES,
                "overlap_add": unfk.OLA_LAUNCHES, "fir_valid": firk.LAUNCHES,
                "matmul": mmk.LAUNCHES, "tf32_planes": mmk.PLANES_LAUNCHES,
                "matmul_bf16": mmk.BF16_LAUNCHES,
                "matmul_int8": mmk.INT8_LAUNCHES,
                "dft_int8": dftk.INT8_LAUNCHES,
                "fir_valid_int8": firk.INT8_LAUNCHES,
                "pfb_fused_int8": pfbk.INT8_LAUNCHES}

    def binary_yardstick(x, y, op) -> dict:
        """The binary kernel alone at a path's shapes, beside one torch
        call of the same function (timed here only) and its bytes bound
        (x and out, and y once); launches outside any counted run."""
        fn = ew.elementwise_mult if op == "mul" else ew.elementwise_add
        tfn = torch.mul if op == "mul" else torch.add
        b_ms, b_by = bound(4 * (2 * x.numel() + y.numel()), x.numel())
        off = [t.data_ptr() % 16 for t in (x, y)]   # out: fresh, aligned
        row = tuple(y.shape) != tuple(x.shape)
        vec = (off == [0, 0] and x.shape[-1] % 4 == 0) if row else \
            off[0] == off[1] == 0
        return {"x": list(x.shape), "y": list(y.shape), "op": op,
                "offsets_bytes": off, "threads": 256,
                "route": "float4" if vec else "scalar",
                "ms": device_ms(torch, lambda: fn(x, y)),
                "torch_ms": device_ms(torch, lambda: tfn(x, y)),
                "bound_ms": b_ms, "bound_by": b_by}

    def owned(label, out, *inputs) -> None:
        """A plan output is dense and shares no storage with its inputs
        (the reference returns fresh arrays)."""
        def span(t):
            st = t.untyped_storage()
            return st.data_ptr(), st.data_ptr() + st.nbytes()
        o0, o1 = span(out)
        if not out.is_contiguous() or any(
                o0 < span(t)[1] and span(t)[0] < o1 for t in inputs):
            fail(f"{label}: the plan output is not a dense tensor of its "
                 f"own (strides {out.stride()})")

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

    # -- the tensor-core kernels' SASS holds warpgroup MMAs -----------------
    mma, pfb_idp, pfb_front = wgmma_counts(_build.build())
    for entry, op in TC_ENTRIES.items():
        if not mma[entry] or not all(c.get(op, 0) > 0
                                     for c in mma[entry].values()):
            fail(f"{entry}: a kernel without {op} in its SASS: {mma[entry]}")
    if len(pfb_idp) != 4 or any(pfb_idp.values()):
        fail(f"tina_pfb_int8: want its two frontend and two DFT kernels, none "
             f"with __dp4a (IDP): {pfb_idp}")
    bf16_kinds = {k.split("<")[0] for k in mma["tina_matmul_bf16"]}
    if bf16_kinds != {"bf16_matmul_skinny_kernel", "bf16_matmul_tiled_kernel"}:
        fail(f"tina_matmul_bf16: want its skinny and tiled kernels in the "
             f"SASS: {mma['tina_matmul_bf16']}")
    usage = ptxas_usage(_build.BUILD_INFO.get("ptxas", ""))
    if usage and any(usage.get(k, {}).get("spill_bytes", 1)
                     for k in mma["tina_matmul_bf16"]):
        seen = {k: usage.get(k) for k in mma["tina_matmul_bf16"]}
        fail(f"tina_matmul_bf16: a kernel spills or is missing from the "
             f"build log: {seen}")
    # ptxas's notes that it serialized a kernel's warpgroup MMAs
    serialized = sorted({line.split("function ", 1)[-1].strip(" '")
                         for line in _build.BUILD_INFO.get("ptxas", "")
                         .splitlines() if "Performance Loss" in line})
    # spills are read from this run's build log (none when it reused a
    # build of the same sources)
    if len(pfb_front) != 4 or any(pfb_front.values()) or (usage and any(
            usage.get(k, {}).get("spill_bytes", 1) for k in pfb_front)):
        fail(f"tina_pfb: want its four frontend kernels, without warpgroup "
             f"MMAs or spills: {pfb_front}, "
             f"{ {k: usage.get(k) for k in pfb_front} }")
    # the f32 FIR's ring (dynamic shared memory) at the pipelines' K, for
    # every compiled tile
    fir_smem = {f"{c['bn']}/{c['threads']}": {
        k: firk.smem_bytes(c["bn"], k) for k in (15, 31, 63)}
        for c in firk.TUNE_SPACE.configs({"k": 31})}
    emit(phase="sass", wgmma_instructions=mma, pfb_int8_idp=pfb_idp,
         pfb_frontend_wgmma=pfb_front, ptxas=usage,
         ptxas_serialized_wgmma=serialized,
         fir_smem_bytes=fir_smem, overlap_add_smem_bytes=0)

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, dtype=dtype, generator=gen)

    # -- kernels against their plain versions, ragged shapes -----------------
    # pfb_fused: B Tout never a multiple of the DFT stage's 128 rows; P of
    # one K chunk and of many; 100 and 600 taps; P = 37 (y's stride padded
    # to 40, scalar frontend loads); frames that start 4 bytes past a
    # 16-byte boundary.  The frontend's y rows as the DFT stage reads them
    # (written over NaN) and the frontend alone bit for bit against their
    # twins; the output against the plain version (1e-4 of max) and at
    # P = 1024 also against a float64 product of the same y (1e-5 of max)
    pfb_cases = [(2, 301, 16, 4, True), (1, 203, 32, 8, True),
                 (3, 130, 48, 16, True), (2, 517, 1024, 8, True),
                 (1, 300, 16, 100, True), (1, 700, 16, 600, True),
                 (2, 150, 37, 5, True), (2, 150, 37, 5, False),
                 (2, 120, 64, 8, False)]
    for b, t, p, m, aligned in pfb_cases:
        buf, taps = randn(b * t * p + 1), randn(m, p)
        x = (buf[:-1] if aligned else buf[1:]).view(b, t, p)
        fr, fi = ops._fourier(p, str(dev))
        rows = b * (t - m + 1)
        want = pfbk.pfb_fused_plain(x, taps, fr, fi)
        front = f"pfb_frontend {(b, t, p, m)} aligned={aligned}"
        hold(torch, front, pfbk.pfb_frontend(x, taps),
             pfbk.pfb_frontend_plain(x, taps))
        y = pfbk.pfb_frontend(x, taps, out=torch.full(
            (rows, pfbk.y_stride(p)), float("nan"), device=dev))
        hold(torch, front + " y rows", y,
             pfbk.pfb_frontend_rows_plain(x, taps))
        for (bt, bn), herm in itertools.product(pfbk.TILES, (False, True)):
            label = f"pfb_fused {(b, t, p, m)} tile {(bt, bn)} " \
                f"hermitian={herm} aligned={aligned}"
            got = pfbk.pfb_fused(x, taps, fr, fi, hermitian=herm, bt=bt,
                                 bn=bn)
            err = hold(torch, label, got, want, PFB_RTOL)
            f64 = dft_f64_err(torch, y[:, :p], fr, fi, got.reshape(rows, p))
            if p == 1024 and not f64 <= DFT_F64_RTOL:
                fail(f"{label} vs float64: {f64} > {DFT_F64_RTOL} of max")
            emit(phase="kernel", kernel="pfb_fused", shape=[b, t, p, m],
                 tile=[bt, bn], hermitian=herm, frames_aligned=aligned,
                 y_stride=pfbk.y_stride(p), max_abs_err=err,
                 max_abs_plain=torch.view_as_real(want).abs().max().item(),
                 max_rel_err_vs_float64=f64, frontend_exact=True, ok=True)
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
    # overlap-add: hop % 4 == 0 takes float4 lanes, hops 6, 5 and 3 a
    # sample a thread, and so do frames that start 4 bytes past a 16-byte
    # boundary; every thread count of the tune space
    for shape, hop in (((2, 37, 64), 64), ((2, 37, 64), 32),
                       ((2, 37, 64), 16), ((2, 37, 64), 8),
                       ((2, 8, 64), 8), ((1, 2047, 1024), 512),
                       ((3, 41, 30), 6), ((2, 50, 15), 5), ((2, 33, 12), 3)):
        size = shape[0] * shape[1] * shape[2]
        for off in (0, 1):
            frames = randn(size + 1)[off:off + size].view(shape)
            want = unfk.overlap_add_plain(frames, hop)
            err, ok = 0.0, True
            for cfg in unfk.OLA_TUNE_SPACE.configs({}):
                got = ops.overlap_add(frames, hop, **cfg)
                torch.cuda.synchronize()
                err = max(err, rel_err(torch, got, want)[0])
                ok = ok and torch.equal(got, want)
            emit(phase="kernel", kernel="overlap_add", shape=list(shape),
                 hop=hop, offset_floats=off, max_abs_err=err, exact=ok)
            if not ok:
                fail(f"overlap_add {shape} hop={hop} offset {off}: not equal"
                     " to plain")
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
    # binary at offsets: x, y and out as views that start 0-3 floats past a
    # 16-byte boundary (the same offset: a scalar head, 16-byte vectors and
    # a scalar tail; other offsets: the scalar loop), cols 1 to 1024 (n
    # not a multiple of 4 where cols is odd), and two large cases whose
    # threads each walk several vectors (the row index carried, not
    # divided)
    def at(k, size):
        return randn(size + 4)[k:k + size]

    offsets = ((0, 0, 0), (1, 1, 1), (2, 2, 2), (3, 3, 3), (1, 2, 0),
               (0, 0, 1))
    cases = [(37, cols, row, o) for cols in (1, 3, 4, 64, 1024)
             for row in (False, True) for o in offsets]
    cases += [(40_000, 1000, True, (0, 0, 0)), (40_001, 1001, False, (2, 2, 2))]
    for op, fn in (("mul", ew.elementwise_mult),
                   ("add", ew.elementwise_add)):
        for rows, cols, row, (ox, oy, oo) in cases:
            x = at(ox, rows * cols).view(rows, cols)
            y = (at(oy, cols) if row else
                 at(oy, rows * cols).view(rows, cols))
            out = at(oo, rows * cols).view(rows, cols)
            hold(torch, f"elementwise_{op} {(rows, cols)} row={row} "
                 f"offsets {(ox, oy, oo)}", fn(x, y, out=out),
                 ew.elementwise_binary_plain(x, y, op))
        emit(phase="kernel", kernel="elementwise_binary", op=op,
             cases=[[r, c, w, list(o)] for r, c, w, o in cases], exact=True)
    # DFT: every ragged case, both variants, real and complex, both ways,
    # every compiled tile; rows that do not start 16-byte aligned
    for rows in (1, 37, 8188):
        for n in (7, 64, 1024):
            worst, staged = 0.0, {}
            for cplx in (False, True):
                x = randn(rows, n,
                          dtype=torch.complex64 if cplx else torch.float32)
                staged["complex" if cplx else "real"] = dftk.staging(x)
                for inverse in (False, True):
                    fr, fi = functions._dfm_tensors(n, inverse,
                                                    torch.float32, str(dev))
                    for variant in dftk.VARIANTS:
                        want = dftk.dft_plain(x, fr, fi, variant)
                        herms = (False, True) if not cplx and \
                            variant == "4mult" else (False,)
                        for (bm, bn), herm in itertools.product(dftk.TILES,
                                                                herms):
                            got = dftk.dft(x, fr, fi, variant=variant, bm=bm,
                                           bn=bn, hermitian=herm)
                            torch.cuda.synchronize()
                            err, scale = rel_err(torch, got, want)
                            worst = max(worst, err / scale)
                            if err > DFT_RTOL * scale:
                                fail(f"dft rows={rows} n={n} complex={cplx}"
                                     f" inverse={inverse} {variant} tile "
                                     f"{(bm, bn)} hermitian={herm}: {err} > "
                                     f"{DFT_RTOL} * {scale}")
            emit(phase="kernel", kernel="dft", rows=rows, n=n,
                 cases="real+complex x forward+inverse x 4mult+3mult, "
                       "real x at 4mult also hermitian",
                 tiles=[list(t) for t in dftk.TILES], staging=staged,
                 max_rel_err=worst, ok=True)
    fr, fi = functions._dfm_tensors(1024, False, torch.float32, str(dev))
    for cplx in (False, True):
        dt = torch.complex64 if cplx else torch.float32
        x = randn(300, 1024, dtype=dt)
        buf = torch.empty(300 * 1024 + 1, dtype=dt, device=dev)
        xs = buf[1:].view(300, 1024)
        xs.copy_(x)
        got = ops.dft(xs, fr, fi, variant="4mult")
        want = ops.dft(x, fr, fi, variant="4mult")
        if not torch.equal(got, want):
            fail(f"dft complex={cplx}: an unaligned start ({dftk.staging(xs)})"
                 f" differs from the aligned rows ({dftk.staging(x)})")
    emit(phase="kernel", kernel="dft", rows=300, n=1024,
         cases="rows not 16-byte aligned, real and complex: the padded "
               "copy equals the direct TMA read bit for bit",
         staging=dftk.staging(xs), ok=True)
    # against float64 at L = N = 1024, every variant: 3mult on a complex x
    # is the one kernel that accumulates all of L in the tensor core's
    # truncating f32 accumulator (csrc/dft.cu: no registers to promote)
    for cplx in (False, True):
        x = randn(2048, 1024, dtype=torch.complex64 if cplx
                  else torch.float32)
        for variant in dftk.VARIANTS:
            got = ops.dft(x, fr, fi, variant=variant)
            e64 = dft_f64_err(torch, x, fr, fi, got)
            plain64 = dft_f64_err(torch, x, fr, fi,
                                  dftk.dft_plain(x, fr, fi, variant))
            emit(phase="kernel", kernel="dft", rows=2048, n=1024,
                 complex=cplx, variant=variant,
                 accumulation=("in place" if cplx and variant == "3mult"
                               else "per chunk, f32 adds"),
                 max_rel_err_vs_float64=e64,
                 plain_max_rel_err_vs_float64=plain64,
                 ok=e64 <= DFT_F64_RTOL)
            if not e64 <= DFT_F64_RTOL:
                fail(f"dft complex={cplx} {variant} vs float64: {e64} > "
                     f"{DFT_F64_RTOL} of max")
    # FIR: the plain version's ascending-k sum, bit for bit; K = 1 to more
    # than a tap chunk, ragged rows and lengths, implicit 'same'/'full'
    # pads, taps as given and reversed (flip)
    for rows, n, k in ((3, 1000, 1), (2, 999, 8), (5, 4099, 15),
                       (1, 70001, 31), (7, 3000, 63), (2, 5003, 129),
                       (2, 9001, 4097), (64, 100001, 31), (3, 50, 31)):
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
    # rows that start 1-3 floats past a 16-byte boundary (3001-sample rows
    # move it row by row): every lead of the staged spans, every tile
    for off in (1, 2, 3):
        xs = randn(5 * 3001 + 4)[off:off + 5 * 3001].view(5, 3001)
        want = firk.fir_valid_plain(xs, kern, pad_left=15, pad_right=15,
                                    flip=True)
        for cfg in firk.TUNE_SPACE.configs({"k": 31}):
            got = firk.fir_valid(xs, kern, pad_left=15, pad_right=15,
                                 flip=True, **cfg)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"fir_valid rows {off} floats past 16 bytes, tile "
                     f"{cfg}: not bit-identical")
        emit(phase="kernel", kernel="fir_valid", shape=list(xs.shape),
             offset_floats=off, tiles="every", exact=True)
    # matmul: the JAX suite's shapes (m, l, n), batched, every tile x
    # order; K not a multiple of 4 (the padded copy), odd N, y's planes
    # made per call and passed in; the split pass bit for bit against its
    # plain twin; rows that start unaligned
    for xs_shape, ys_shape in (((1, 1), (1, 1)), ((257, 129), (129, 255)),
                               ((300, 100), (100, 50)),
                               ((3, 5, 40, 24), (24, 17)),
                               ((130, 1027), (1027, 193))):
        x, y = randn(*xs_shape), randn(*ys_shape)
        x2 = x.reshape(-1, xs_shape[-1])
        want = mmk.matmul_plain(x2, y)
        planes = mmk.tf32_planes(y)
        hold(torch, f"tf32_planes {ys_shape}", planes,
             mmk.tf32_planes_plain(y))
        worst = worst64 = 0.0
        for bm, bn, bk in mmk.TILES:
            for order in mmk.ORDERS:
                for yt in (None, planes):
                    got = ops.matmul(x, y, yt_planes=yt, bm=bm, bn=bn, bk=bk,
                                     order=order)
                    torch.cuda.synchronize()
                    err, scale = rel_err(torch, got.reshape(want.shape), want)
                    worst = max(worst, err / scale)
                    if err > MM_RTOL * scale:
                        fail(f"matmul {xs_shape} @ {ys_shape} tile "
                             f"{(bm, bn, bk)} {order}: {err} > {MM_RTOL} * "
                             f"{scale}")
                    worst64 = max(worst64, mm_f64_err(
                        torch, x2, y, got.reshape(want.shape)))
        if not worst64 <= MM_F64_RTOL:
            fail(f"matmul {xs_shape} @ {ys_shape} vs float64: {worst64} > "
                 f"{MM_F64_RTOL} of max")
        emit(phase="kernel", kernel="matmul", x=list(xs_shape),
             y=list(ys_shape),
             cases="every tile x both orders x planes per call and made "
                   "once", staging=mmk.staging(x2), max_rel_err=worst,
             max_rel_err_vs_float64=worst64, ok=True)
    x, y = randn(300, 1024), randn(1024, 96)
    buf = torch.empty(300 * 1024 + 1, device=dev)
    xs = buf[1:].view(300, 1024)
    xs.copy_(x)
    if not torch.equal(ops.matmul(xs, y), ops.matmul(x, y)):
        fail(f"matmul: an unaligned start ({mmk.staging(xs)}) differs from "
             f"the aligned rows ({mmk.staging(x)})")
    emit(phase="kernel", kernel="matmul", x=[300, 1024], y=[1024, 96],
         cases="rows not 16-byte aligned: the padded copy equals the "
               "direct TMA read bit for bit", staging=mmk.staging(xs),
         ok=True)

    def pfb_stages(frames, taps_rev, fr, fi, planes, cfg) -> dict:
        """The f32 PFB's two kernels apart, at a path's shapes (P a
        multiple of 4, so that y's row stride is P): the whole call as the
        plan makes it (Hermitian: half the columns computed), computing
        every column, and on each compiled tile; the frontend alone; the
        DFT stage alone both ways (tina_dft on the frontend's y rows);
        torch.fft.fft over y's last axis as the DFT stage's yardstick
        (timed here only); each stage's bound (the DFT's at TF32 over the
        columns 0 .. P/2 the Hermitian call needs, beside it the bound of
        every column and the 3xTF32 floor); and the call's output against
        a float64 product of the same y (1e-5 of max).  Launches
        pfb_fused, pfb_frontend and dft outside any counted run."""
        b, t, p = frames.shape
        rows = b * (t - taps_rev.shape[0] + 1)
        y = pfbk.pfb_frontend(frames, taps_rev, out=torch.empty(
            (rows, pfbk.y_stride(p)), device=dev))
        z = pfbk.pfb_fused(frames, taps_rev, fr, fi, planes=planes,
                           hermitian=True, **cfg)
        yv = y.view(rows, p)
        dcfg = {"bm": cfg["bt"], "bn": cfg["bn"]}
        out = {
            "call": device_ms(torch, lambda: pfbk.pfb_fused(
                frames, taps_rev, fr, fi, planes=planes, hermitian=True,
                **cfg)),
            "call_all_columns": device_ms(torch, lambda: pfbk.pfb_fused(
                frames, taps_rev, fr, fi, planes=planes, **cfg)),
            "call_per_tile": {f"{bt}x{bn}": device_ms(
                torch, lambda: pfbk.pfb_fused(
                    frames, taps_rev, fr, fi, planes=planes, hermitian=True,
                    bt=bt, bn=bn)) for bt, bn in pfbk.TILES},
            "frontend": device_ms(
                torch, lambda: pfbk.pfb_frontend(frames, taps_rev)),
            "dft_stage": device_ms(torch, lambda: dftk.dft(
                yv, fr, fi, variant="4mult", planes=planes, hermitian=True,
                **dcfg)),
            "dft_stage_all_columns": device_ms(torch, lambda: dftk.dft(
                yv, fr, fi, variant="4mult", planes=planes, **dcfg)),
            "dft_stage_fft": device_ms(
                torch, lambda: torch.fft.fft(yv, dim=-1)),
        }
        dcost = dft_cost(rows, p, p, False, hermitian=True)
        out["frontend_bound"] = bound(
            4 * (frames.numel() + taps_rev.numel() + rows * p),
            2 * taps_rev.shape[0] * rows * p)[0]
        out["dft_stage_bound"] = bound_tf32(*dcost)[0]
        out["dft_stage_bound_all_columns"] = bound_tf32(
            *dft_cost(rows, p, p, False))[0]
        out["dft_stage_bound_3xtf32"] = bound_3xtf32(*dcost)[0]
        out["max_rel_err_vs_float64"] = dft_f64_err(
            torch, yv, fr, fi, z.reshape(rows, p))
        if not out["max_rel_err_vs_float64"] <= DFT_F64_RTOL:
            fail(f"pfb_fused {(b, t, p)} vs float64: "
                 f"{out['max_rel_err_vs_float64']} > {DFT_F64_RTOL} of max")
        return out

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
        owned(label, out, x)
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
        planes = ops._fourier_planes(p, str(dev))
        cfg = ops._resolve(pfbk.TUNE_SPACE, {"m": m, "p": p, "t": t})
        zk = pfbk.pfb_fused(frames, taps_rev, fr, fi, planes=planes,
                            hermitian=True, **cfg)
        before = (pfbk.LAUNCHES, ew.LAUNCHES)
        ms = {
            "plan": median_ms(torch, lambda: plan(x)),
            "plan_native": median_ms(torch, lambda: native(x)),
            "plan_back_to_back": device_ms(torch, lambda: plan(x)),
            "pfb_fused": device_ms(
                torch, lambda: pfbk.pfb_fused(frames, taps_rev, fr, fi,
                                              planes=planes, hermitian=True,
                                              **cfg)),
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
        if grew != (3 * calls, 3 * calls):
            # each plan call (two timings): 1 + 1; each lone kernel: 1
            fail(f"{label}: launches grew by {grew} over {calls} timed "
                 "plan calls and lone kernel calls, want one each per call")
        kerr, kscale = rel_err(torch, zk,
                               pfbk.pfb_fused_plain(frames, taps_rev, fr, fi))
        cerr, _ = rel_err(
            torch, ew.elementwise_chain(zk, (), (), abs2_head=True),
            ew.elementwise_chain_plain(zk, (), (), abs2_head=True))
        pcost = pfb_cost(b, t, p, p, m, hermitian=True)
        n_out = b * tout * p
        chain_cost = (12 * n_out, 3 * n_out)
        emit(phase="main", size=label, x=[b, n], p=p, m=m, tile=cfg,
             launches_per_call=launches, max_abs_err_vs_native=err_native,
             max_abs_native=scale_native, max_abs_err_row0_vs_oracle=err_oracle,
             max_abs_oracle_row0=scale_oracle, ms=ms,
             plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
             pfb_bound_ms={"fir_fp32_dft_tf32": bound_pfb(*pcost)[0],
                           "all_columns": bound_pfb(
                               *pfb_cost(b, t, p, p, m))[0],
                           "3xtf32": bound_3xtf32(pcost[0], pcost[1]
                                                  + pcost[2])[0],
                           "fp32_pipe": fp32_pipe_ms(*pcost)},
             pfb_stages=pfb_stages(frames, taps_rev, fr, fi, planes, cfg),
             plan_bound_ms=bound_pfb(*pcost)[0] + bound(*chain_cost)[0],
             plan_bound_ms_fp32_pipe=fp32_pipe_ms(*pcost)
             + bound(*chain_cost)[0],
             pfb_achieved_tflops=(pcost[1] + pcost[2])
             / (ms["pfb_fused"] * 1e-3) / 1e12,
             chain_achieved_gb_s=12 * n_out / (ms["elementwise_chain"] * 1e-3)
             / 1e9,
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        table[label] = dict(launches=launches, ms=ms, pfb=pcost,
                            chain=chain_cost, pfb_err=kerr, chain_err=cerr)
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
        owned(label, out, x)
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
    # the kernel's TF32 planes of the DFM, made once as the plan makes them
    pf = functions._dfm_tf32_tensors(j, False, "4mult", str(dev))
    pi = functions._dfm_tf32_tensors(j, True, "4mult", str(dev))
    ucfg = ops._resolve(unfk.TUNE_SPACE, {"j": j, "n": n, "rows": b})
    dcfg = ops._resolve(dftk.TUNE_SPACE, {"m": b * t, "n": j, "k": j})
    ocfg = ops._resolve(unfk.OLA_TUNE_SPACE, {"j": j, "hop": hop,
                                             "k": j // hop, "t": t,
                                             "rows": b})
    z = dftk.dft(xr, fr, fi, variant="4mult", planes=pf, **dcfg)
    zinv = dftk.dft(z, ir, ii, variant="4mult", planes=pi, **dcfg)
    f64 = {"forward": dft_f64_err(torch, xr, fr, fi, z),
           "inverse": dft_f64_err(torch, z, ir, ii, zinv)}
    if not max(f64.values()) <= DFT_F64_RTOL:
        fail(f"stft dft vs float64: {f64} > {DFT_F64_RTOL} of max")
    # the fp32 plain version on the same inputs, for scale
    plain_f64 = {
        "forward": dft_f64_err(torch, xr, fr, fi,
                               dftk.dft_plain(xr, fr, fi, "4mult")),
        "inverse": dft_f64_err(torch, z, ir, ii,
                               dftk.dft_plain(z, ir, ii, "4mult"))}
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
            torch, lambda: dftk.dft(xr, fr, fi, variant="4mult", planes=pf,
                                    **dcfg)),
        "dft_inverse": device_ms(
            torch, lambda: dftk.dft(z, ir, ii, variant="4mult", planes=pi,
                                    **dcfg)),
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
    # overlap-add as the plan runs it (its producer, the window multiply,
    # has just written the frames: the pair less the multiply alone) and
    # with L2 emptied before each call; launches outside the counted runs
    ola_in_plan = device_ms(
        torch, lambda: unfk.overlap_add(ew.elementwise_mult(r, win), hop,
                                        **ocfg)) \
        - device_ms(torch, lambda: ew.elementwise_mult(r, win))
    ola_flushed = flushed_ms(
        torch, lambda: unfk.overlap_add(rw, hop, **ocfg))
    stft_binary = [binary_yardstick(fd, win, "mul"),
                   binary_yardstick(r, win, "mul")]
    rows_f = b * t
    nt = t - j // hop + 1
    cost = {
        "unfold": (4 * (b * n + b * (n - j + 1) * j), 0),
        "elementwise_binary": (2 * 4 * (2 * rows_f * j + j), 2 * rows_f * j),
        # the forward's real frames against the J-point DFM need columns
        # 0 .. J/2 (the kernel computes all J: dft_all)
        "dft": add_cost(dft_cost(rows_f, j, j, False, hermitian=True),
                        dft_cost(rows_f, j, j, True)),
        "overlap_add": (4 * (b * t * j + b * nt * hop),
                        b * nt * hop * (j // hop)),
    }
    dft_all = add_cost(dft_cost(rows_f, j, j, False),
                       dft_cost(rows_f, j, j, True))
    emit(phase="main", path="stft_overlap_add", x=list(STFT_X), window=j,
         hop=hop, frames=rows_f, tiles={"unfold": ucfg, "dft": dcfg,
                                        "overlap_add": ocfg},
         overlap_add_ms_in_plan=ola_in_plan,
         overlap_add_ms_l2_flushed=ola_flushed,
         overlap_add_bound_ms=bound(*cost["overlap_add"])[0],
         max_abs_err_vs_plain=errs, ms=ms, plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         plan_bound_ms=sum((bound_tf32 if k == "dft" else bound)(*c)[0]
                           for k, c in cost.items()),
         unfold_gb_s=cost["unfold"][0] / (ms["unfold"] * 1e-3) / 1e9,
         dft_achieved_tflops=dft_all[1] / (ms["dft"] * 1e-3) / 1e12,
         dft_achieved_tf32_tflops=3 * dft_all[1] / (ms["dft"] * 1e-3)
         / 1e12,
         dft_bound_ms={"tf32": bound_tf32(*cost["dft"])[0],
                       "tf32_all_columns": bound_tf32(*dft_all)[0],
                       "3xtf32_method": bound_3xtf32(*dft_all)[0],
                       "fp32_pipe": bound(*cost["dft"])[0]},
         dft_max_rel_err_vs_float64=f64,
         dft_plain_max_rel_err_vs_float64=plain_f64,
         dft_staging={"forward": dftk.staging(xr),
                      "inverse": dftk.staging(z)},
         elementwise_binary=stft_binary,
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
    pf = functions._dfm_tf32_tensors(j, False, "4mult", str(dev))
    dcfg = ops._resolve(dftk.TUNE_SPACE, {"m": xr.shape[0], "n": j, "k": j})
    z = dftk.dft(xr, fr, fi, variant="4mult", planes=pf, **dcfg)
    spec_f64 = dft_f64_err(torch, xr, fr, fi, z)
    if not spec_f64 <= DFT_F64_RTOL:
        fail(f"spectrogram dft vs float64: {spec_f64} > {DFT_F64_RTOL} of "
             "max")
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
            torch, lambda: dftk.dft(xr, fr, fi, variant="4mult", planes=pf,
                                    **dcfg)),
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
         elementwise_binary=binary_yardstick(frames, win, "mul"),
         max_abs_err_vs_plain=spec_errs, ms=ms,
         dft_max_rel_err_vs_float64=spec_f64, dft_staging=dftk.staging(xr),
         dft_bound_ms={
             "tf32": bound_tf32(*dft_cost(nf, j, j, False, True))[0],
             "tf32_all_columns": bound_tf32(*dft_cost(nf, j, j, False))[0],
             "3xtf32_method": bound_3xtf32(*dft_cost(nf, j, j, False))[0],
             "fp32_pipe": bound(*dft_cost(nf, j, j, False, True))[0]},
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         plan_bound_ms=sum(bound(*c)[0] for c in (
             (4 * (b * n + nf * j), 0), (4 * (2 * nf * j + j), nf * j),
             (12 * nf * j, 4 * nf * j)))
         + bound_tf32(*dft_cost(nf, j, j, False, True))[0],
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
        # the plan's output is y2's stride-2 tail made dense (Plan._owned)
        "output_copy": device_ms(torch, lambda: y2[:, ::2].contiguous()),
    })
    with fp32_convs():
        ms["fir_valid_library"] = both(lambda: conv1d(x, h1),
                                       lambda: conv1d(x2, h2))
    ms["fir_valid"] = ms["fir_1"] + ms["fir_2"]
    check_grew("fir_decimate", before, {"fir_valid": 2})
    # both FIRs at every tile of their tune space
    fir_1_tiles = {f"{c['bn']}/{c['threads']}": device_ms(
        torch, lambda c=c: firk.fir_valid(x, t1, flip=True, **c))
        for c in firk.TUNE_SPACE.configs({"k": 31})}
    fir_2_tiles = {f"{c['bn']}/{c['threads']}": device_ms(
        torch, lambda c=c: firk.fir_valid(x2, t2, flip=True, **c))
        for c in firk.TUNE_SPACE.configs({"k": 15})}
    cost1 = fir_cost(b, n, y1.shape[1], 31)
    cost2 = fir_cost(b, x2.shape[1], y2.shape[1], 15)
    emit(phase="main", path="fir_decimate", x=list(FIR_X), taps=[31, 15],
         tiles={"fir_1": c1, "fir_2": c2},
         max_abs_err_vs_plain={"fir_valid": dec_err}, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={"fir_1": bound(*cost1)[0], "fir_2": bound(*cost2)[0]},
         fp32_pipe_floor_ms={"fir_1": fir_floor_ms(cost1[1]),
                             "fir_2": fir_floor_ms(cost2[1])},
         plan_bound_ms=bound(*cost1)[0] + bound(*cost2)[0],
         fir_1_gb_s=cost1[0] / (ms["fir_1"] * 1e-3) / 1e9,
         fir_1_ms_per_tile=fir_1_tiles, fir_2_ms_per_tile=fir_2_tiles,
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
    cor_tiles = {f"{c['bn']}/{c['threads']}": device_ms(
        torch, lambda c=c: firk.fir_valid(x, tmpl, **c))
        for c in firk.TUNE_SPACE.configs({"k": 63})}
    nout = y.numel()
    cor_cost = {"fir_valid": fir_cost(b, n, y.shape[1], 63),
                "elementwise_chain": (8 * nout, 2 * nout)}
    emit(phase="main", path="correlate", x=list(FIR_X), taps=63, tiles=cc,
         max_abs_err_vs_plain=cor_errs, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={k: bound(*c)[0] for k, c in cor_cost.items()},
         plan_bound_ms=sum(bound(*c)[0] for c in cor_cost.values()),
         fir_gb_s=cor_cost["fir_valid"][0] / (ms["fir_valid"] * 1e-3) / 1e9,
         fp32_pipe_floor_ms={"fir_valid": fir_floor_ms(
             cor_cost["fir_valid"][1])},
         fir_ms_per_tile=cor_tiles,
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
    planes = ops._fourier_planes(p, str(dev))
    pcfg = ops._resolve(pfbk.TUNE_SPACE, {"m": m, "p": p, "t": t})
    zk = pfbk.pfb_fused(frames, taps_rev, fr, fi, planes=planes,
                        hermitian=True, **pcfg)
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
            torch, lambda: pfbk.pfb_fused(frames, taps_rev, fr, fi,
                                          planes=planes, hermitian=True,
                                          **pcfg)),
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
                 "pfb_fused": pfb_cost(b, t, p, p, m, hermitian=True),
                 "elementwise_chain": (12 * n_out, 3 * n_out)}
    emit(phase="main", path="cascaded_channelizer", x=list(CHAN_X), taps=31,
         p=p, m=m, tiles={"fir_valid": cc, "pfb_fused": pcfg},
         max_abs_err_vs_plain=chan_errs, ms=ms,
         plan_samples_per_s=b * n / (ms["plan"] * 1e-3),
         bound_ms={k: (bound_pfb if k == "pfb_fused" else bound)(*c)[0]
                   for k, c in chan_cost.items()},
         fp32_pipe_floor_ms={"fir_valid": fir_floor_ms(
             chan_cost["fir_valid"][1])},
         pfb_bound_ms_fp32_pipe=fp32_pipe_ms(*chan_cost["pfb_fused"]),
         pfb_bound_ms_all_columns=bound_pfb(*pfb_cost(b, t, p, p, m))[0],
         pfb_bound_ms_3xtf32=bound_3xtf32(
             chan_cost["pfb_fused"][0], sum(chan_cost["pfb_fused"][1:]))[0],
         pfb_stages=pfb_stages(frames, taps_rev, fr, fi, planes, pcfg),
         plan_bound_ms=sum((bound_pfb if k == "pfb_fused" else bound)(*c)[0]
                           for k, c in chan_cost.items()),
         plan_bound_ms_fp32_pipe=sum(fp32_pipe_ms(*c)
                                     for c in chan_cost.values()),
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
        "matmul": {"matmul": 1, "tf32_planes": 1}, "summation": {},
        "dft": {"dft": 1},
        "idft": {"dft": 1}, "fir": {"fir_valid": 1}, "unfold": {"unfold": 1},
        "overlap_add": {"overlap_add": 1},
        "pfb_frontend": {"pfb_frontend": 1},
        "pfb": {"pfb_fused": 1}}
    # each kernel wrapper the sweep reaches: (module, attribute, plain
    # version, its tune params, hold tolerance: None is bit-exact)
    wrappers = {
        "fir_valid": (firk, "fir_valid", firk.fir_valid_plain,
                      firk.TUNE_SPACE.params, None),
        "matmul": (mmk, "matmul", mmk.matmul_plain,
                   mmk.TUNE_SPACE.params + ("yt_planes",), MM_RTOL),
        "dft": (dftk, "dft", dftk.dft_plain,
                dftk.TUNE_SPACE.params + ("planes",), DFT_RTOL),
        "unfold": (unfk, "unfold", unfk.unfold_plain, unfk.TUNE_SPACE.params,
                   None),
        "overlap_add": (unfk, "overlap_add", unfk.overlap_add_plain,
                        unfk.OLA_TUNE_SPACE.params, None),
        "pfb_fused": (pfbk, "pfb_fused", pfbk.pfb_fused_plain,
                      pfbk.TUNE_SPACE.params + ("planes", "hermitian"),
                      PFB_RTOL),
        "pfb_frontend": (pfbk, "pfb_frontend", pfbk.pfb_frontend_plain, (),
                         None),
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
        f64 = None
        if d.name == "matmul":          # the 3xTF32 GEMM against float64
            f64 = mm_f64_err(torch, targs[0], targs[1], eager)
            if not f64 <= MM_F64_RTOL:
                fail(f"table1 matmul vs float64: {f64} > {MM_F64_RTOL} of "
                     "max")
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
             max_rel_err_vs_float64=f64, ok=True)
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
         x=list(xa.shape), ms=add_ms, max_abs_err_vs_plain=add_err,
         elementwise_binary=binary_yardstick(xa, ya, "add"))
    # the binary kernel's launches in the elementwise_add row's counted run
    table["add"] = dict(
        launches={"elementwise_add": add_launches["elementwise_binary"]},
        ms=add_ms, err=add_err, cost=(12 * xa.numel(), xa.numel()))
    del sweep, xa, ya

    # -- main path: matmul, 4096 x 4096 @ 4096 x 4096, as a one-node plan ---
    g = graph.Graph(f"matmul_{MM_N}")
    y_np = rng.standard_normal((MM_N, MM_N), dtype=np.float32)
    mnode = g.apply("matmul", g.input("x"), g.const(y_np, "y"))
    g.output(mnode)
    y64 = y_np.astype(np.float64)
    # the plan's first call makes y's TF32 planes (its kernel pack)
    plan, native, x, info = drive(
        "matmul", g, (MM_N, MM_N), {"matmul": 1, "tf32_planes": 1},
        lambda x0: x0.astype(np.float64) @ y64, ORACLE_RTOL)
    planes = plan.kconsts[mnode][0]
    if planes is None:
        fail("matmul: the kernel plan ran without making y's TF32 planes")
    zero_counts()
    plan(x)
    torch.cuda.synchronize()
    if counts() != {**dict.fromkeys(counts(), 0), "matmul": 1}:
        fail(f"matmul: a second plan call launched {counts()}, want the "
             "GEMM alone (y's planes made once)")
    yd = plan.consts["y"]
    mcfg = ops._resolve(mmk.TUNE_SPACE, {"m": MM_N, "n": MM_N, "k": MM_N})
    zk = mmk.matmul(x, yd, yt_planes=planes, **mcfg)
    mm_err = hold(torch, "matmul 4096", zk, mmk.matmul_plain(x, yd), MM_RTOL)
    planes_err = hold(torch, "tf32_planes 4096", mmk.tf32_planes(yd),
                      mmk.tf32_planes_plain(yd))
    mm_f64 = mm_f64_err(torch, x, yd, zk)
    if not mm_f64 <= MM_F64_RTOL:
        fail(f"matmul 4096 vs float64: {mm_f64} > {MM_F64_RTOL} of max")
    mm_f64_library = mm_f64_err(torch, x, yd, torch.matmul(x, yd))
    del zk
    ms = {"plan": median_ms(torch, lambda: plan(x)),
          "plan_native": median_ms(torch, lambda: native(x)),
          "plan_back_to_back": device_ms(torch, lambda: plan(x))}
    before = counts()
    ms.update({
        "matmul": device_ms(
            torch, lambda: mmk.matmul(x, yd, yt_planes=planes, **mcfg)),
        "matmul_plain": device_ms(torch, lambda: mmk.matmul_plain(x, yd)),
        "matmul_library": device_ms(torch, lambda: torch.matmul(x, yd)),
        # diagnostics: the split pass alone, and the GEMM splitting y per
        # call (what an eager call with a fresh y pays)
        "tf32_planes": device_ms(torch, lambda: mmk.tf32_planes(yd)),
        "tf32_planes_plain": device_ms(
            torch, lambda: mmk.tf32_planes_plain(yd)),
        "matmul_split_per_call": device_ms(
            torch, lambda: mmk.matmul(x, yd, **mcfg)),
    })
    check_grew("matmul", before, {"matmul": 2, "tf32_planes": 2})
    mm_tiles = {f"{c['bm']}x{c['bn']}x{c['bk']}/{c['order']}": device_ms(
        torch, lambda c=c: mmk.matmul(x, yd, yt_planes=planes, **c),
        repeats=5)
        for c in mmk.TUNE_SPACE.configs({"m": MM_N, "n": MM_N, "k": MM_N})}
    mm_cost = (4 * 3 * MM_N * MM_N, 2 * MM_N ** 3)
    emit(phase="main", path="matmul", x=[MM_N, MM_N], y=[MM_N, MM_N],
         tile=mcfg, staging=mmk.staging(x), max_abs_err_vs_plain=mm_err,
         tf32_planes_max_abs_err_vs_plain=planes_err,
         max_rel_err_vs_float64=mm_f64,
         library_max_rel_err_vs_float64=mm_f64_library, ms=ms,
         bound_ms=bound_tf32(*mm_cost)[0],
         bound_ms_3xtf32_method=bound_3xtf32(*mm_cost)[0],
         bound_ms_fp32_pipe=fp32_pipe_ms(*mm_cost),
         plan_bound_ms=bound_tf32(*mm_cost)[0],
         achieved_tflops=mm_cost[1] / (ms["matmul"] * 1e-3) / 1e12,
         ms_per_tile=mm_tiles,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **info)
    table["matmul"] = dict(launches=info["launches_per_call"], ms=ms,
                           cost=mm_cost, err=mm_err)
    del plan, native, x, yd, planes

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

    def pfb8_stages(args, frt, fit, cfg) -> dict:
        """The int8 PFB's two kernels apart, at a path's shapes (P a
        multiple of 16): the whole call, the DFT stage alone (tina_dft_int8
        runs the same s8_gemm.cuh DFT on the frontend's yq and ys), the
        frontend as the difference, the bytes bound of each, and one
        torch._int_mm of yq against [Fr | Fi] (the DFT stage's
        contraction alone) as its yardstick.  Launches dft_int8 outside
        any counted run."""
        frames, tq, ts, qr, qi, sr, si = args
        b, t, p = frames.shape
        rows = b * (t - tq.shape[0] + 1)
        yq = torch.empty((rows, pfbk.padded_width(p)), dtype=torch.int8,
                         device=dev)
        ys = torch.empty(rows, device=dev)
        pfbk.pfb_fused_int8(*args, frt=frt, fit=fit, scratch=(yq, ys), **cfg)
        dcfg = {"bm": cfg["bt"], "bn": cfg["bn"], "bk": 128}
        qri_cm = col_major(torch.cat([qr, qi], 1))
        out = {
            "call": device_ms(torch, lambda: pfbk.pfb_fused_int8(
                *args, frt=frt, fit=fit, **cfg)),
            "dft_stage": device_ms(torch, lambda: dftk.dft_int8(
                yq, qr, qi, ys, sr, si, frt=frt, fit=fit, **dcfg)),
        }
        try:           # cuBLASLt may refuse a narrow int8 operand
            out["dft_stage_int_mm"] = device_ms(
                torch, lambda: int_mm(yq, qri_cm))
        except RuntimeError as e:
            out["dft_stage_int_mm"] = f"refused: {str(e)[:120]}"
        out["frontend"] = out["call"] - out["dft_stage"]
        n = qr.shape[1]
        out["frontend_bound"] = bound8(
            4 * frames.numel() + tq.numel() + 4 * p + rows * (p + 4),
            2 * tq.shape[0] * rows * p)[0]
        out["dft_stage_bound"] = bound8(*qgemm_cost(rows, p, n, planes=2))[0]
        return out

    int8_floor = min(d.budget("int8").sqnr_db for d in opdefs.OPDEFS.values()
                     if d.budget("int8") is not None)
    eps32 = float(np.finfo(np.float32).eps)

    # -- int8 kernels against their plain versions, bit for bit -------------
    def int8_pair(m, k, n):
        xq, sx = quantize.quantize_symmetric(randn(m, k), axis=-1)
        wq, ws = quantize.quantize_weights(randn(k, n))
        return xq, wq, sx.reshape(-1), ws.reshape(-1)

    # matmul_int8: M, N, K not tile multiples, K below 4 and not a
    # multiple of 4 or 16, every compiled tile, yq's K-major copy made by
    # the wrapper and by the caller; rows that do not start aligned; the
    # saturated headroom case at K = 2048
    for m, k, n in ((1, 1, 1), (257, 129, 255), (300, 100, 50), (70, 3, 33),
                    (130, 4097, 67), (200, 2048, 384)):
        xq, wq, sx, ws = int8_pair(m, k, n)
        wt = wq.t().contiguous()
        want = mmk.matmul_int8_plain(xq, wq, sx, ws)
        for bm, bn, bk in mmk.TILES_INT8:
            for yt in (None, wt):
                hold(torch, f"matmul_int8 {(m, k, n)} tile {(bm, bn, bk)}",
                     mmk.matmul_int8(xq, wq, sx, ws, yt=yt, bm=bm, bn=bn,
                                     bk=bk), want)
        emit(phase="int8_kernels", kernel="matmul_int8", mkn=[m, k, n],
             tiles=[list(t) for t in mmk.TILES_INT8],
             staging=mmk.int8_staging(xq, wt), exact=True)
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
         staging={"unaligned rows": mmk.int8_staging(xs, wq.t()),
                  "headroom": mmk.int8_staging(sat, wsat.t())},
         exact=True)
    # dft_int8: ragged rows and widths, forward and inverse int8 DFM,
    # every compiled tile, the K-major planes made by the wrapper and
    # passed in (as ops.qdft passes them)
    for rows in (1, 37, 8188):
        staged = {}
        for n in (7, 64, 1024):
            for inverse in (False, True):
                xq, sx = quantize.quantize_symmetric(randn(rows, n), axis=-1)
                sx = sx.reshape(-1)
                qr, sr, qi, si = quantize._qdfm_tensors(n, inverse, str(dev))
                qrt, qit = quantize._qdfm_kmajor(n, inverse, str(dev))
                staged[n] = mmk.int8_staging(xq, qrt, qit)
                want = dftk.dft_int8_plain(xq, qr, qi, sx, sr, si)
                for bm, bn, bk in dftk.TILES_INT8:
                    for frt, fit in ((None, None), (qrt, qit)):
                        hold(torch, f"dft_int8 rows={rows} n={n} inverse="
                             f"{inverse} tile {(bm, bn, bk)}",
                             dftk.dft_int8(xq, qr, qi, sx, sr, si, frt=frt,
                                           fit=fit, bm=bm, bn=bn, bk=bk),
                             want)
        emit(phase="int8_kernels", kernel="dft_int8", rows=rows,
             n=[7, 64, 1024], inverse=[False, True],
             tiles=[list(t) for t in dftk.TILES_INT8], staging=staged,
             exact=True)
    # dft_int8 off the square DFM: an odd N at L a multiple of 16, L not a
    # multiple of 16 (the padded copy), rows that start unaligned
    for l, n in ((64, 33), (100, 64), (1000, 257)):
        xq, sx = quantize.quantize_symmetric(randn(300, l), axis=-1)
        sx = sx.reshape(-1)
        fr, sr = quantize.quantize_weights(randn(l, n))
        fi, si = quantize.quantize_weights(randn(l, n))
        sr, si = sr.reshape(-1), si.reshape(-1)
        want = dftk.dft_int8_plain(xq, fr, fi, sx, sr, si)
        buf = torch.empty(300 * l + 1, dtype=torch.int8, device=dev)
        xs = buf[1:].view(300, l)
        xs.copy_(xq)
        for bm, bn, bk in dftk.TILES_INT8:
            for xin in (xq, xs):
                hold(torch, f"dft_int8 L={l} N={n} tile {(bm, bn, bk)} "
                     f"({mmk.int8_staging(xin, fr.t())})",
                     dftk.dft_int8(xin, fr, fi, sx, sr, si, bm=bm, bn=bn,
                                   bk=bk), want)
        emit(phase="int8_kernels", kernel="dft_int8", rows=300, l=l, n=n,
             tiles=[list(t) for t in dftk.TILES_INT8],
             staging={"aligned": mmk.int8_staging(xq, fr.t().contiguous()),
                      "unaligned rows": mmk.int8_staging(xs, fr.t())},
             exact=True)
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
                       (2, 9001, 4097), (64, 100001, 31), (3, 50, 31)):
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
    # csrc/int8.cuh's quantize (a reciprocal per scale, two FMAs, a
    # magic-number add) against the division it replaces, on EVERY float x
    # in [-amax, amax] (csrc/qcheck.cu): amax under the 1e-12 clamp, powers
    # of two and 127 * 2^k, one ulp either side of each, and amax drawn
    # log-uniform from 1e-30 to 1e30
    f32 = np.float32
    fmax = np.finfo(np.float32).max
    base = [f32(2.0) ** k for k in range(-60, 61, 4)] \
        + [f32(127) * f32(2.0) ** k for k in range(-60, 61, 4)] \
        + [f32(1e30), f32(1e38), fmax]
    with np.errstate(over="ignore"):     # FLT_MAX's upper neighbour: inf
        near = [np.nextafter(v, d) for v in base
                for d in (f32(0), f32(np.inf))]
    tiny = f32(1e-12)
    clamp = [f32(0), f32(1e-45), f32(1e-30), f32(1e-13), f32(5e-13),
             np.nextafter(tiny, f32(0)), tiny, np.nextafter(tiny, f32(1))]
    logu = 10.0 ** np.random.default_rng(11).uniform(-30, 30, 120)
    amax = np.array([v for v in base + near + clamp + list(logu)
                     if np.isfinite(f32(v))], dtype=np.float32)
    amax_d = torch.as_tensor(amax, device=dev)
    t0 = time.perf_counter()
    diffs = firk.quantize_check(amax_d).cpu()
    q_seconds = time.perf_counter() - t0
    if int(diffs.sum()) != 0:
        bad = [(float(a), int(d)) for a, d in zip(amax, diffs) if d]
        fail(f"quantize_rcp differs from the division at {bad[:8]}")
    emit(phase="int8_kernels", kernel="quantize_rcp", scales=len(amax),
         pairs_checked=firk.quantize_check_pairs(amax_d),
         ints_that_differ=0, seconds=q_seconds, exact=True)
    # pfb_fused_int8: P = 16, 20, 48, 1000 and 1024 (20, 48 and 1000 pad
    # yq's stride to 16; 37 takes the scalar frontend loads), ragged frame
    # counts, both tiles, frames whose rows start 16-byte aligned and not,
    # the frontend's yq and ys against their plain twin; half-integer
    # quotients in the frontend
    for b, t, p, m in ((2, 301, 16, 4), (1, 203, 48, 8), (3, 130, 16, 16),
                       (1, 75, 1024, 8), (2, 40, 20, 3), (1, 60, 1000, 8),
                       (2, 50, 37, 5)):
        buf = randn(b * t * p + 1)
        tq, ts = quantize.quantize_pfb_taps(randn(m, p))
        ts = ts.reshape(-1)
        qr, sr, qi, si = quantize._qdfm_tensors(p, False, str(dev))
        qrt, qit = quantize._qdfm_kmajor(p, False, str(dev))
        rows = b * (t - m + 1)
        for aligned in (True, False):
            frames = (buf[:-1] if aligned else buf[1:]).view(b, t, p)
            args = (frames, tq, ts, qr, qi, sr, si)
            want = pfbk.pfb_fused_int8_plain(*args)
            wq, ws = pfbk.pfb_frontend_int8_plain(frames, tq, ts)
            for bt, bn in pfbk.TILES_INT8:
                yq = torch.full_like(wq, 99)
                ys = torch.empty_like(ws)
                label = f"pfb_fused_int8 {(b, t, p, m)} tile {(bt, bn)} " \
                    f"aligned={aligned}"
                hold(torch, label, pfbk.pfb_fused_int8(
                    *args, frt=qrt, fit=qit, bt=bt, bn=bn,
                    scratch=(yq, ys)), want)
                hold(torch, label + " yq", yq, wq)
                hold(torch, label + " ys", ys, ws)
        emit(phase="int8_kernels", kernel="pfb_fused_int8",
             shape=[b, t, p, m], p_pad=pfbk.padded_width(p),
             tiles=[list(t) for t in pfbk.TILES_INT8],
             frames_aligned=[True, False], frontend_exact=True, exact=True)
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
    owned("int8 pfb_power", out8, x)
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
    qrt, qit = quantize._qdfm_kmajor(p, False, str(dev))
    args = (frames, tq, ts.reshape(-1), qr, qi, sr, si)
    pcfg = ops._resolve(pfbk.TUNE_SPACE_INT8, {"m": m, "p": p, "t": t})
    zk = pfbk.pfb_fused_int8(*args, frt=qrt, fit=qit, **pcfg)
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
            torch, lambda: pfbk.pfb_fused_int8(*args, frt=qrt, fit=qit,
                                               **pcfg)),
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
        torch, lambda bt=bt, bn=bn: pfbk.pfb_fused_int8(
            *args, frt=qrt, fit=qit, bt=bt, bn=bn))
        for bt, bn in pfbk.TILES_INT8
        if pfbk.TUNE_SPACE_INT8.valid({"bt": bt, "bn": bn},
                                      {"m": m, "p": p, "t": t})}
    pcost = qpfb_cost(b, t, p, p, m)
    emit(phase="int8_main", path="pfb_power", precision="int8", x=[b, n],
         p=p, m=m, tile=pcfg, p_pad=pfbk.padded_width(p),
         frontend_shape=pfbk.frontend_shape(p),
         pfb_int8_stages=pfb8_stages(args, qrt, qit, pcfg),
         launches_per_call=launches,
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
        owned(label, out, x)
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
    qrt, qit = quantize._qdfm_kmajor(j, False, str(dev))
    qr_cm, qi_cm = col_major(qr), col_major(qi)
    qri_cm = col_major(torch.cat([qr, qi], 1))    # [Fr | Fi], one product
    dcfg = ops._resolve(dftk.TUNE_SPACE_INT8,
                        {"m": xq.shape[0], "n": j, "k": j})
    derr = hold(torch, "int8 spectrogram dft_int8",
                dftk.dft_int8(xq, qr, qi, sx, sr, si, frt=qrt, fit=qit,
                              **dcfg),
                dftk.dft_int8_plain(xq, qr, qi, sx, sr, si))
    before = counts()
    ms.update({
        "dft_int8": device_ms(
            torch, lambda: dftk.dft_int8(xq, qr, qi, sx, sr, si, frt=qrt,
                                         fit=qit, **dcfg)),
        "dft_int8_plain": device_ms(
            torch, lambda: dftk.dft_int8_plain(xq, qr, qi, sx, sr, si)),
        "dft_int8_library": device_ms(torch, lambda: int_mm(xq, qri_cm)),
        "dft_int8_library_two_calls": device_ms(
            torch, lambda: (int_mm(xq, qr_cm), int_mm(xq, qi_cm))),
    })
    check_grew("int8 spectrogram", before, {"dft_int8": 1})
    spec_tiles = {f"{c['bm']}x{c['bn']}x{c['bk']}": device_ms(
        torch, lambda c=c: dftk.dft_int8(xq, qr, qi, sx, sr, si, frt=qrt,
                                         fit=qit, **c))
        for c in dftk.TUNE_SPACE_INT8.configs(
            {"m": xq.shape[0], "n": j, "k": j})}
    dcost = qgemm_cost(xq.shape[0], j, j, planes=2)
    emit(phase="int8_paths", path="spectrogram", x=list(SPEC_X), window=j,
         tile=dcfg, dft_int8_staging=mmk.int8_staging(xq, qrt, qit),
         dft_int8_ms_per_tile=spec_tiles,
         max_abs_err_vs_plain={"dft_int8": derr}, ms=ms,
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
    qrt, qit = quantize._qdfm_kmajor(j, False, str(dev))
    qr_cm, qi_cm = col_major(qr), col_major(qi)
    qri_cm = col_major(torch.cat([qr, qi], 1))    # [Fr | Fi], one product
    dcfg = ops._resolve(dftk.TUNE_SPACE_INT8,
                        {"m": xq.shape[0], "n": j, "k": j})
    z = dftk.dft_int8(xq, qr, qi, sx, sr, si, frt=qrt, fit=qit, **dcfg)
    serr = {"dft_int8": hold(torch, "int8 stft dft_int8", z,
                             dftk.dft_int8_plain(xq, qr, qi, sx, sr, si))}
    ir, isr, ii, isi = quantize._qdfm_tensors(j, True, str(dev))
    irt, iit = quantize._qdfm_kmajor(j, True, str(dev))
    zrq, szr = quantize.quantize_symmetric(z.real, axis=-1)
    ziq, szi = quantize.quantize_symmetric(z.imag, axis=-1)
    # the idft's four products, each with the DFM's K-major copy, at a
    # tile of matmul_int8's own space (ops.qdft resolves it there)
    prods = [(zrq, ir, szr.reshape(-1), isr, irt),
             (ziq, ii, szi.reshape(-1), isi, iit),
             (zrq, ii, szr.reshape(-1), isi, iit),
             (ziq, ir, szi.reshape(-1), isr, irt)]
    mcfg = ops._resolve(mmk.TUNE_SPACE_INT8,
                        {"m": zrq.shape[0], "n": j, "k": j})
    serr["matmul_int8"] = max(
        hold(torch, "int8 stft idft matmul_int8",
             mmk.matmul_int8(*pr[:4], yt=pr[4], **mcfg),
             mmk.matmul_int8_plain(*pr[:4]))
        for pr in prods)
    before = counts()
    ms.update({
        "dft_int8": device_ms(
            torch, lambda: dftk.dft_int8(xq, qr, qi, sx, sr, si, frt=qrt,
                                         fit=qit, **dcfg)),
        "dft_int8_plain": device_ms(
            torch, lambda: dftk.dft_int8_plain(xq, qr, qi, sx, sr, si)),
        "dft_int8_library": device_ms(torch, lambda: int_mm(xq, qri_cm)),
        "dft_int8_library_two_calls": device_ms(
            torch, lambda: (int_mm(xq, qr_cm), int_mm(xq, qi_cm))),
        "matmul_int8": sum(device_ms(
            torch, lambda pr=pr: mmk.matmul_int8(*pr[:4], yt=pr[4], **mcfg))
            for pr in prods),
        "matmul_int8_plain": sum(device_ms(
            torch, lambda pr=pr: mmk.matmul_int8_plain(*pr[:4]))
            for pr in prods),
        "matmul_int8_library": sum(device_ms(
            torch, lambda a=pr[0], w=col_major(pr[1]): int_mm(a, w))
            for pr in prods),
    })
    check_grew("int8 stft_overlap_add", before,
               {"dft_int8": 1, "matmul_int8": 4})
    stft_tiles = {f"{c['bm']}x{c['bn']}x{c['bk']}": device_ms(
        torch, lambda c=c: dftk.dft_int8(xq, qr, qi, sx, sr, si, frt=qrt,
                                         fit=qit, **c))
        for c in dftk.TUNE_SPACE_INT8.configs(
            {"m": xq.shape[0], "n": j, "k": j})}
    rows_f = xq.shape[0]
    emit(phase="int8_paths", path="stft_overlap_add", x=list(STFT_X),
         window=j, hop=hop, frames=rows_f,
         tiles={"dft_int8": dcfg, "matmul_int8": mcfg},
         dft_int8_staging=mmk.int8_staging(xq, qrt, qit),
         dft_int8_ms_per_tile=stft_tiles,
         matmul_int8_staging=mmk.int8_staging(zrq, irt),
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
    fir8_tiles_2 = {f"{c['bn']}/{c['threads']}": device_ms(
        torch, lambda c=c: firk.fir_valid_int8(x2, tq2, ts2, **c), repeats=5)
        for c in firk.TUNE_SPACE_INT8.configs({"k": 15})}
    fcost = add_cost(qfir_cost(b, n, y1.shape[1], 31),
                     qfir_cost(b, x2.shape[1], y2.shape[1], 15))
    emit(phase="int8_paths", path="fir_decimate", x=list(FIR_X),
         taps=[31, 15], tiles={"fir_1": c1, "fir_2": c2},
         max_abs_err_vs_plain={"fir_valid_int8": ferr}, ms=ms,
         fir_1_ms_per_tile=fir8_tiles, fir_2_ms_per_tile=fir8_tiles_2,
         quantizes_fir_1=int(y1.numel()) * 31,
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
         fir_ms_per_tile={f"{c['bn']}/{c['threads']}": device_ms(
             torch, lambda c=c: firk.fir_valid_int8(x, tq, ts, **c),
             repeats=5) for c in firk.TUNE_SPACE_INT8.configs({"k": 63})},
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
    qrt, qit = quantize._qdfm_kmajor(p, False, str(dev))
    pargs = (frames, pq, ps.reshape(-1), qr, qi, sr, si)
    pcfg = ops._resolve(pfbk.TUNE_SPACE_INT8, {"m": m, "p": p, "t": t})
    kerr = {"fir_valid_int8": hold(torch, "int8 cascaded fir", y,
                                   firk.fir_valid_int8_plain(x, tq, ts)),
            "pfb_fused_int8": hold(
                torch, "int8 cascaded pfb",
                pfbk.pfb_fused_int8(*pargs, frt=qrt, fit=qit, **pcfg),
                pfbk.pfb_fused_int8_plain(*pargs))}
    before = counts()
    ms.update({
        "fir_valid_int8": device_ms(
            torch, lambda: firk.fir_valid_int8(x, tq, ts, **cc)),
        "pfb_fused_int8": device_ms(
            torch, lambda: pfbk.pfb_fused_int8(*pargs, frt=qrt, fit=qit,
                                               **pcfg)),
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
         p_pad=pfbk.padded_width(p), frontend_shape=pfbk.frontend_shape(p),
         pfb_int8_stages=pfb8_stages(pargs, qrt, qit, pcfg), **info)
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
    # wt: the K-major copy, made at the kernel plan's first launch
    wq, ws, wt = plan.qconsts[mnode]
    if wt is None:
        fail("int8 matmul: the kernel plan ran without its K-major weight")
    xq, sx = quantize.quantize_symmetric(x, axis=-1)
    sx = sx.reshape(-1)
    mcfg = ops._resolve(mmk.TUNE_SPACE_INT8,
                        {"m": MM_N, "n": MM_N, "k": MM_N})
    merr = hold(torch, "int8 matmul 4096", mmk.matmul_int8(
        xq, wq, sx, ws, yt=wt, **mcfg), mmk.matmul_int8_plain(xq, wq, sx, ws))
    before = counts()
    ms.update({
        "matmul_int8": device_ms(
            torch, lambda: mmk.matmul_int8(xq, wq, sx, ws, yt=wt, **mcfg)),
        "matmul_int8_plain": device_ms(
            torch, lambda: mmk.matmul_int8_plain(xq, wq, sx, ws)),
        "matmul_int8_library": device_ms(
            torch, lambda w=col_major(wq): int_mm(xq, w)),
    })
    check_grew("int8 matmul", before, {"matmul_int8": 1})
    mm8_tiles = {f"{c['bm']}x{c['bn']}x{c['bk']}": device_ms(
        torch, lambda c=c: mmk.matmul_int8(xq, wq, sx, ws, yt=wt, **c),
        repeats=5)
        for c in mmk.TUNE_SPACE_INT8.configs(
            {"m": MM_N, "n": MM_N, "k": MM_N})}
    mcost = qgemm_cost(MM_N, MM_N, MM_N)
    emit(phase="int8_paths", path="matmul", x=[MM_N, MM_N],
         y=[MM_N, MM_N], tile=mcfg, max_abs_err_vs_plain=merr, ms=ms,
         staging=mmk.int8_staging(xq, wt),
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

    # ======================================================================
    # stream: every pipeline through ChunkedRunner at lowering="kernel", at
    # f32 and int8, full width, held against its offline plan
    # ======================================================================
    from repro_torch.graph import autotune
    from repro_torch.graph import plan as plan_lib

    def chunks_of(n, size):
        return [(i, min(size, n - i)) for i in range(0, n, size)]

    def stream_run(g, x, pieces, prec, buckets=False, per_push=False):
        """One stream of ``x`` through a fresh runner, pushed as the
        (start, length) ``pieces`` of its last axis, then finalized: the
        concatenated output, the runner, the device ms between two CUDA
        events around the whole stream, each push's (device ms, host ms)
        and the plan calls it made."""
        runner = graph.ChunkedRunner(g, lowering="kernel", precision=prec,
                                     step_buckets=buckets)
        outs, marks = [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            start.record()
            for piece in pieces + [None]:
                if per_push:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    h0 = time.perf_counter()
                if piece is None:
                    o = runner.finalize()
                else:
                    i, size = piece
                    o = runner.push(x[..., i:i + size])
                if per_push:
                    h1 = time.perf_counter()
                    e1 = torch.cuda.Event(enable_timing=True)
                    e1.record()
                    marks.append((e0, e1, (h1 - h0) * 1e3))
                if o is not None:
                    outs.append(o)
            end.record()
        end.synchronize()
        out = torch.cat(outs, dim=runner.spec.concat_axis)
        return (out, runner, start.elapsed_time(end),
                [(a.elapsed_time(b), h) for a, b, h in marks], len(outs))

    def hold_stream(label, got, want, prec) -> dict:
        """int8: bit for bit; f32: max|diff| <= 1e-6 of max|offline|, the
        count of differing elements printed either way."""
        if got.shape != want.shape:
            fail(f"{label}: streamed {tuple(got.shape)} vs offline "
                 f"{tuple(want.shape)}")
        diff = (got - want).abs()
        n_diff = int((diff != 0).sum().item())
        err, scale = diff.max().item(), want.abs().max().item()
        if prec == "int8" and n_diff:
            fail(f"{label}: int8 stream differs from offline in {n_diff} "
                 f"elements (max |diff| {err})")
        if not err <= STREAM_RTOL * scale:
            fail(f"{label}: streamed vs offline {err} > {STREAM_RTOL} * "
                 f"{scale} ({n_diff} elements differ)")
        return {"differing_elements": n_diff, "elements": want.numel(),
                "max_abs_diff": err, "max_abs_offline": scale}

    stream_paths = (
        ("pfb_power", graph.build_pfb_power(1024, 8), (16, 2 ** 22),
         2 ** 18, {"pfb_fused": 1, "elementwise_chain": 1},
         {"pfb_fused_int8": 1, "elementwise_chain": 1}),
        ("stft_overlap_add", graph.build_stft_overlap_add(STFT_J, STFT_HOP),
         STFT_X, 2 ** 18,
         {"unfold": 1, "elementwise_binary": 2, "dft": 2, "overlap_add": 1},
         {"unfold": 1, "elementwise_binary": 2, "dft_int8": 1,
          "matmul_int8": 4, "overlap_add": 1}),
        ("spectrogram", graph.build_spectrogram(SPEC_J), SPEC_X, 2 ** 14,
         {"unfold": 1, "elementwise_binary": 1, "dft": 1,
          "elementwise_chain": 1},
         {"unfold": 1, "elementwise_binary": 1, "dft_int8": 1,
          "elementwise_chain": 1}),
        ("fir_decimate", graph.build_fir_decimate(31, 15), FIR_X, 2 ** 18,
         {"fir_valid": 2}, {"fir_valid_int8": 2}),
        ("correlate", graph.build_correlate(63), FIR_X, 2 ** 18,
         {"fir_valid": 1, "elementwise_chain": 1},
         {"fir_valid_int8": 1, "elementwise_chain": 1}),
        ("cascaded_channelizer", graph.build_cascaded_channelizer(31, 16, 4),
         CHAN_X, 2 ** 18,
         {"fir_valid": 1, "pfb_fused": 1, "elementwise_chain": 1},
         {"fir_valid_int8": 1, "pfb_fused_int8": 1,
          "elementwise_chain": 1}))
    for name, g, shape, chunk, want32, want8 in stream_paths:
        x = torch.randn(*shape, device=dev, generator=gen)
        for prec, per_call in (("f32", want32), ("int8", want8)):
            label = f"stream {name} {prec}"
            offline = compile_quiet(g, shape, lowering="kernel",
                                    precision=prec)
            want = offline(x)
            offline_ms = device_ms(torch, lambda: offline(x))
            pieces = chunks_of(shape[-1], chunk)
            torch.cuda.synchronize()
            base_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            misses = graph.cache_stats()["misses"]
            # the counted run: counts set to 0 just before, read just after
            zero_counts()
            out, runner, cold_ms, _, calls = stream_run(g, x, pieces, prec)
            launches = counts()
            plans = graph.cache_stats()["misses"] - misses
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            full_want = dict.fromkeys(launches, 0)
            full_want.update({k: v * calls for k, v in per_call.items()})
            if launches != full_want:
                fail(f"{label}: launches over {calls} plan calls {launches}, "
                     f"want {full_want}")
            held = hold_stream(label, out, want, prec)
            owned(label, out, x)
            del out
            # warm: every window's plan is compiled; the stream's own time,
            # and the host's share of a push: the whole push on the host
            # clock, and the plan-cache hit of its compile alone
            _, _, warm_ms, push_ms, _ = stream_run(g, x, pieces, prec,
                                                   per_push=True)
            steady = {g.inputs[0]: (shape[0], max(runner.window_lens))}
            hits = []
            for _ in range(REPEATS):
                h0 = time.perf_counter()
                graph.compile(g, steady, lowering="kernel", precision=prec)
                hits.append((time.perf_counter() - h0) * 1e3)
            emit(phase="stream", path=name, precision=prec, x=list(shape),
                 chunk=[shape[0], chunk], pushes=len(pieces),
                 plan_calls=calls, plans_compiled=plans,
                 window_lens=sorted(runner.window_lens),
                 receptive=runner.spec.receptive, block=runner.spec.block,
                 launches=launches, **held,
                 ms={"stream": warm_ms, "stream_cold": cold_ms,
                     "offline_back_to_back": offline_ms,
                     "push_median": statistics.median(d for d, _ in push_ms),
                     "push_max": max(d for d, _ in push_ms),
                     "push_host_median": statistics.median(
                         h for _, h in push_ms),
                     "compile_hit_median": statistics.median(hits)},
                 samples_per_s=shape[0] * shape[1] / (warm_ms * 1e-3),
                 offline_samples_per_s=shape[0] * shape[1]
                 / (offline_ms * 1e-3),
                 peak_memory_gb=peak_gb, memory_before_gb=base_gb)
            del want, offline
        if name in ("pfb_power", "fir_decimate"):
            # an irregular schedule from a seeded generator, free-running
            # and bucketed: the bucketed runner compiles fewer windows
            sched = np.random.default_rng(2026)
            pieces, i = [], 0
            while i < shape[-1]:
                size = min(int(sched.integers(2 ** 16, 2 ** 19)),
                           shape[-1] - i)
                pieces.append((i, size))
                i += size
            want = compile_quiet(g, shape, lowering="kernel")(x)
            lens = {}
            for buckets in (False, True):
                label = f"stream {name} f32 irregular buckets={buckets}"
                torch.cuda.reset_peak_memory_stats()
                misses = graph.cache_stats()["misses"]
                zero_counts()
                out, runner, ms_run, _, calls = stream_run(
                    g, x, pieces, "f32", buckets=buckets)
                launches = counts()
                full_want = dict.fromkeys(launches, 0)
                full_want.update({k: v * calls for k, v in want32.items()})
                if launches != full_want:
                    fail(f"{label}: launches {launches}, want {full_want}")
                held = hold_stream(label, out, want, "f32")
                lens[buckets] = sorted(runner.window_lens)
                emit(phase="stream", path=name, precision="f32",
                     schedule="irregular", step_buckets=buckets,
                     pushes=len(pieces), plan_calls=calls,
                     plans_compiled=graph.cache_stats()["misses"] - misses,
                     window_lens=lens[buckets], launches=launches, **held,
                     ms={"stream_cold": ms_run},
                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
                del out
            if not len(lens[True]) < len(lens[False]):
                fail(f"stream {name}: bucketed windows {lens[True]} not fewer "
                     f"than free-running {lens[False]}")
            del want
        del x

    # ======================================================================
    # autotune: measure, persist, replay from "cached" with no measurement
    # ======================================================================
    tune_dir = tempfile.TemporaryDirectory(prefix="tina_autotune_")
    tune_path = str(Path(tune_dir.name) / "autotune_torch.json")
    os.environ["TINA_AUTOTUNE"] = "on"
    os.environ["TINA_AUTOTUNE_CACHE"] = tune_path
    autotune._MEM.clear()
    mm_g = graph.Graph(f"matmul_{MM_N}_tune")
    mm_g.output(mm_g.apply("matmul", mm_g.input("x"), mm_g.const(
        np.random.default_rng(20).standard_normal((MM_N, MM_N),
                                                  dtype=np.float32), "y")))
    pfb_g = graph.build_pfb_power(1024, 8)
    fir_g = graph.build_fir_decimate(31, 15)
    # (label, graph, shape, options, kernels the tuning must launch)
    tune_cases = (
        ("pfb_power lowering=auto", pfb_g, (16, 2 ** 22),
         {"lowering": "auto"}, ("pfb_fused", "elementwise_chain")),
        ("pfb_power precision=auto", pfb_g, (16, 2 ** 22),
         {"lowering": "kernel", "precision": "auto"},
         ("pfb_fused", "pfb_fused_int8", "elementwise_chain")),
        ("fir_decimate block_configs=auto", fir_g, FIR_X,
         {"lowering": "kernel", "block_configs": "auto"}, ("fir_valid",)),
        ("fir_decimate int8 block_configs=auto", fir_g, FIR_X,
         {"lowering": "kernel", "block_configs": "auto",
          "precision": "int8"}, ("fir_valid_int8",)),
        ("matmul block_configs=auto", mm_g, (MM_N, MM_N),
         {"lowering": "kernel", "block_configs": "auto"}, ("matmul",)))

    def full_cfg(plan, node, cfg):
        """A node's block config with the kernel defaults filled in (a
        tuned default tile computes what {} computes)."""
        av = plan_lib.infer(plan.graph, plan.input_specs)
        sp = autotune.space_for(node.op, plan.precisions[node.name])
        ctx = autotune.tune_ctx(node, [av[i] for i in node.inputs])
        if sp is None or ctx is None or plan.lowerings[node.name] != "kernel":
            return dict(cfg)
        return sp.check(dict(cfg), ctx)

    def winners(plan):
        return {nd: {"lowering": plan.lowerings[nd],
                     "config": plan.configs.get(nd, {}),
                     "precision": plan.precisions[nd]}
                for nd in plan.lowerings}

    tuned_out = {}
    for label, g, shape, opts, tuned_kernels in tune_cases:
        x = torch.randn(*shape, device=dev, generator=gen)
        st0 = autotune.stats()
        zero_counts()
        t0 = time.perf_counter()
        tuned = compile_quiet(g, shape, **opts)
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        tuning_launches = counts()
        st1 = autotune.stats()
        if st1["measured"] == st0["measured"] or not all(
                tuning_launches[k] for k in tuned_kernels):
            fail(f"autotune {label}: measured "
                 f"{st1['measured'] - st0['measured']} nodes, launches "
                 f"{tuning_launches}; want each of {tuned_kernels}")
        # the kernel plan at the tiers the tuned plan runs
        kplan = compile_quiet(g, shape, lowering="kernel",
                              precision=dict(tuned.precisions))
        ref = kplan(x)
        zero_counts()
        out = tuned(x)
        torch.cuda.synchronize()
        call_launches = counts()
        same = all(tuned.lowerings[nd.name] == kplan.lowerings[nd.name]
                   and full_cfg(tuned, nd, tuned.configs.get(nd.name, {}))
                   == full_cfg(kplan, nd, {})
                   for nd in tuned.graph.topo()
                   if nd.op not in ("input", "const"))
        if same and not torch.equal(out, ref):
            fail(f"autotune {label}: the winner is the kernel plan's "
                 "lowering/config but its output is not bit-identical")
        err, scale = rel_err(torch, out, ref)
        if not same and not err <= NATIVE_RTOL * scale:
            fail(f"autotune {label}: tuned vs kernel plan {err} > "
                 f"{NATIVE_RTOL} * {scale}")
        # a reduced tier that won: its stored verdict passed, and the plan
        # output's row 0 meets the op's budget against the f32 kernel plan
        entries = autotune._load(tune_path)
        reduced = {}
        for nd in tuned.graph.topo():
            prec = tuned.precisions.get(nd.name, "f32")
            if prec == "f32":
                continue
            f32_row0 = compile_quiet(g, shape, lowering="kernel")(x)[0]
            b = opdefs.OPDEFS[nd.op].budget(prec)
            sq = opdefs.sqnr_db(f32_row0.cpu(), out[0].cpu())
            stored = [v.get("accuracy", {}).get(prec)
                      for k, v in entries.items()
                      if k.startswith(nd.op + "|")
                      and k.endswith("|prec=auto")]
            if opts.get("precision") == "auto" and not (
                    stored and all(s and s.get("ok") for s in stored)):
                fail(f"autotune {label}: {nd.name} won at {prec} without a "
                     f"passing budget verdict: {stored}")
            if b is not None and not sq >= b.sqnr_db:
                fail(f"autotune {label}: {nd.name} at {prec}: row 0 at {sq} "
                     f"dB < its op's {b.sqnr_db} dB budget")
            reduced[nd.name] = {"precision": prec,
                                "budget_db": b.sqnr_db if b else None,
                                "row0_sqnr_db_vs_f32_plan": sq,
                                "stored_verdicts": stored}
            del f32_row0
        # why pick_joint chose what it chose: the times and SQNR it stored
        why = ({k: {f: v.get(f) for f in ("precision", "lowering", "config",
                                           "accuracy", "times_us")}
                for k, v in entries.items() if k.endswith("|prec=auto")}
               if opts.get("precision") == "auto" else None)
        emit(phase="autotune", case=label, x=list(shape), options=opts,
             winners=winners(tuned), same_as_kernel_plan=same,
             max_abs_err_vs_kernel_plan=err, max_abs_kernel_plan=scale,
             tune_seconds=tune_s,
             measured=st1["measured"] - st0["measured"],
             pruned=st1["pruned"] - st0["pruned"],
             tuning_launches=tuning_launches, launches_per_call=call_launches,
             reduced_tiers=reduced or None, pick_joint=why,
             ms={"tuned_back_to_back": device_ms(torch, lambda: tuned(x)),
                 "kernel_plan_back_to_back": device_ms(torch,
                                                       lambda: kplan(x))},
             stats=autotune.stats())
        tuned_out[label] = (out, winners(tuned), x)
        del ref, kplan, tuned
    # replay: TINA_AUTOTUNE=cached, a cleared plan cache and file mirror
    os.environ["TINA_AUTOTUNE"] = "cached"
    graph.clear_cache()
    autotune._MEM.clear()
    m0 = autotune.stats()["measured"]
    for label, g, shape, opts, _ in tune_cases:
        out0, win0, x = tuned_out[label]
        again = compile_quiet(g, shape, **opts)
        if autotune.stats()["measured"] != m0:
            fail(f"autotune {label}: cached mode measured "
                 f"{autotune.stats()['measured'] - m0} candidates")
        if winners(again) != win0:
            fail(f"autotune {label}: cached winners {winners(again)} vs "
                 f"tuned {win0}")
        if not torch.equal(again(x), out0):
            fail(f"autotune {label}: cached plan's output differs")
    emit(phase="autotune", case="cached replay", cases=len(tune_cases),
         new_measurements=autotune.stats()["measured"] - m0,
         stats=autotune.stats(), cache_entries=len(autotune._load(tune_path)))
    del tuned_out
    os.environ.pop("TINA_AUTOTUNE")
    os.environ.pop("TINA_AUTOTUNE_CACHE")
    tune_dir.cleanup()

    # ======================================================================
    # serve: PipelineService at full width on the card, the fault path,
    # and the launcher
    # ======================================================================
    from repro_torch import obs
    from repro_torch.core.registry import PIPELINES as SERVE_PIPES
    from repro_torch.graph import service as service_lib
    from repro_torch.launch import dsp_serve
    from repro_torch.obs import faults

    serve_n, serve_p, serve_m, serve_b = 2 ** 22, 1024, 8, 16
    pfb_oracle = graph.pfb_power_oracle(serve_p, serve_m)
    req_rng = np.random.default_rng(2021)
    # the first request alone, then 256 f32 and 128 int8 requests: 64
    # and 32 distinct signals, each sent four times (a window of 16 and 8
    # full batches, so the buffers a service makes at its first batches
    # do not set the medians)
    f32_reqs = [req_rng.standard_normal(serve_n, dtype=np.float32)
                for _ in range(65)]
    i8_reqs = [req_rng.standard_normal(serve_n, dtype=np.float32)
               for _ in range(33)]
    f32_reqs = f32_reqs[:1] + f32_reqs[1:] * 4
    i8_reqs = i8_reqs[:1] + i8_reqs[1:] * 4

    def fresh_histograms(s) -> None:
        """Start a service's latency and per-part histograms anew (after
        its first batch, which is reported apart)."""
        for book in (s._lat, s._host, s._card):
            for k, h in book.items():
                book[k] = obs.Histogram(h.name, unit=h.unit)

    def drive_threads(s, reqs, tenant=None, keep=True):
        """Submit ``reqs`` from 4 threads, half rt and half batch; the
        futures in request order and each request's latency (ms).  With
        ``keep=False`` a client drops each result once it has checked its
        shape and finiteness, but for the three the oracle reads."""
        futs = [None] * len(reqs)
        lat = [None] * len(reqs)
        errs = []
        kept = {0, len(reqs) // 2, len(reqs) - 1}

        def producer(k):
            try:
                mine = []
                for i in range(k, len(reqs), 4):
                    t_sub = time.perf_counter()
                    f = s.submit(reqs[i], tenant=tenant,
                                 priority="rt" if i % 2 else "batch")
                    futs[i] = f
                    mine.append((i, f, t_sub))
                for i, f, t_sub in mine:
                    row = f.result(timeout=600)
                    lat[i] = (time.perf_counter() - t_sub) * 1e3
                    if not keep and i not in kept:
                        if row.ndim != 2 or not np.isfinite(row).all():
                            raise AssertionError(
                                f"response {i}: {row.shape}, not finite")
                        futs[i] = None
            except Exception as e:   # noqa: BLE001 — reported below
                errs.append(e)

        threads = [threading.Thread(target=producer, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errs or any(t.is_alive() for t in threads):
            fail(f"serve: a producer failed or hung: {errs!r}")
        return futs, lat

    def pct(values, q):
        return float(np.percentile(np.asarray(values, dtype=np.float64), q))

    def summary(book):
        return {k: {"p50": v["p50"], "p99": v["p99"], "count": v["count"]}
                for k, v in book.items()}

    def serve_window(s, reqs, tenant, keep=True):
        """The first request alone (its batch's latency reported apart),
        then the rest from 4 threads: rates, latencies, parts, busy
        share, the futures."""
        t0 = time.perf_counter()
        first_fut = s.submit(reqs[0], tenant=tenant)
        first = first_fut.result(timeout=600)
        first_ms = (time.perf_counter() - t0) * 1e3
        kept = first.copy()
        fresh_histograms(s)
        b0 = s.stats()["tenants"][tenant or "default"]["batches"]
        ev0 = len(obs.events())
        w0 = time.perf_counter()
        futs, lat = drive_threads(s, reqs[1:], tenant, keep)
        window_s = time.perf_counter() - w0
        st = s.stats()
        runs = [e for e in obs.events()[ev0:]
                if e["name"] == "service.device_run"]
        busy_ms = sum(e["dur"] for e in runs) / 1e3
        card_busy_ms = st["card_ms"]["batch"]["mean"] * \
            st["card_ms"]["batch"]["count"] \
            if st["card_ms"]["batch"]["count"] else 0.0
        n = len(reqs) - 1
        return first_fut, kept, futs, {
            "first_batch_ms": first_ms,
            "requests": n, "window_s": window_s,
            "batches": st["tenants"][tenant or "default"]["batches"] - b0,
            "requests_per_s": n / window_s,
            "samples_per_s": n * serve_n / window_s,
            "latency_ms": {"total": {"p50": pct(lat, 50),
                                     "p99": pct(lat, 99)},
                           **summary(st["latency_ms"])},
            "host_ms_per_batch": summary(st["host_ms"]),
            "card_ms_per_batch": summary(st["card_ms"]),
            "device_track_busy_share": busy_ms / (window_s * 1e3),
            "card_busy_share": card_busy_ms / (window_s * 1e3),
            "device_track_spans": len(runs)}

    def hold_oracle(label, reqs, futs, prec):
        worst = []
        for i in (0, len(reqs) // 2, len(reqs) - 1):
            want = pfb_oracle(reqs[i])
            got = futs[i].result(timeout=0)
            if got.shape != want.shape:
                fail(f"{label}: response {i} {got.shape} vs oracle "
                     f"{want.shape}")
            if prec == "f32":
                err = float(np.abs(got - want).max() / np.abs(want).max())
                if not err <= ORACLE_RTOL:
                    fail(f"{label}: response {i} {err} of max > "
                         f"{ORACLE_RTOL} against the oracle")
            else:
                err = opdefs.sqnr_db(want, got)
                if not err >= 26.0:
                    fail(f"{label}: response {i} at {err} dB < the pfb "
                         "budget's 26 dB")
            worst.append(err)
        return worst

    pfb_g = graph.build_pfb_power(serve_p, serve_m)
    offline_ms = {}
    for prec in ("f32", "int8"):
        xd = torch.randn(serve_b, serve_n, device=dev, generator=gen)
        plan = compile_quiet(pfb_g, (serve_b, serve_n), lowering="kernel",
                             precision=prec)
        offline_ms[prec] = device_ms(torch, lambda: plan(xd))
        del xd, plan
    obs.enable()
    # each run starts from an empty page-locked host cache (a run that
    # reused the blocks an earlier one freed would skip the cudaHostAlloc
    # of every batch's results), in the order on, off, off, on
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    for run, overlap in enumerate((True, False, False, True)):
        label = f"serve pfb_power overlap={overlap} run {run}"
        # the first-call cost shows: plans compiled and the lazily made
        # device state (the PFB's DFT planes, the int8 DFM) made anew
        graph.clear_cache()
        ops._fourier_planes.cache_clear()
        quantize._qdfm_kmajor.cache_clear()
        gc.collect()
        torch.cuda.synchronize()
        if empty_host is not None:
            empty_host()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        # the counted run: counts set to 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        s = graph.PipelineService(pfb_g, serve_n, batch_size=serve_b,
                                  batching="continuous", lowering="kernel",
                                  record_batches=True, overlap=overlap)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            s.add_tenant("pfb_int8", pfb_g, serve_n, lowering="kernel",
                         precision="int8")
        construct_s = time.perf_counter() - t0
        # the bucket plans are the offline plans' cache entries
        if s.plan is not compile_quiet(pfb_g, (serve_b, serve_n),
                                       lowering="kernel") \
                or s.stream() is None:
            fail(f"{label}: the service's plan is not the offline plan, or "
                 f"stream {s.stream()}")
        s.start()
        f_first, f_kept, f_futs, f_res = serve_window(s, f32_reqs, None)
        i_first, i_kept, i_futs, i_res = serve_window(s, i8_reqs,
                                                      "pfb_int8")
        s.close()
        launches = counts()
        st = s.stats()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        f_batches = st["tenants"]["default"]["batches"]
        i_batches = st["tenants"]["pfb_int8"]["batches"]
        want = dict.fromkeys(launches, 0)
        want.update(pfb_fused=f_batches, pfb_frontend=0,
                    elementwise_chain=f_batches + i_batches,
                    pfb_fused_int8=i_batches)
        if launches != want:
            fail(f"{label}: launches {launches} over {f_batches} f32 and "
                 f"{i_batches} int8 batches, want {want}")
        if st["degraded"] or st["quarantined"] or any(
                t.downgrades for t in s.tenants.values()):
            fail(f"{label}: degraded {st['degraded']}, quarantined "
                 f"{st['quarantined']}, downgrades "
                 f"{ {n: t.downgrades for n, t in s.tenants.items()} }")
        # a result taken at delivery is unchanged after every later batch
        for lab, fut, kept in (("f32", f_first, f_kept),
                               ("int8", i_first, i_kept)):
            if not np.array_equal(fut.result(timeout=0), kept):
                fail(f"{label}: the first {lab} result changed after "
                     "later batches")
        errs = {"f32_max_abs_err_of_max": hold_oracle(
            label, f32_reqs[1:], f_futs, "f32"),
                "int8_sqnr_db": hold_oracle(label, i8_reqs[1:], i_futs,
                                            "int8")}
        replayed = service_lib.replay_batches(s)
        if replayed != len(f32_reqs) + len(i8_reqs):
            fail(f"{label}: replay checked {replayed} of "
                 f"{len(f32_reqs) + len(i8_reqs)} requests")
        # page-locked output buffers are reused, not made per batch
        out_buffers = {f"{n}/{b}": len(v) for n, t in s.tenants.items()
                       for b, v in t._free_outs.items()}
        if not all(1 <= v <= 2 for v in out_buffers.values()):
            fail(f"{label}: page-locked output buffers {out_buffers}")
        emit(phase="serve", case="pfb_power", overlap=overlap, run=run,
             host_cache_emptied=empty_host is not None,
             x=[serve_n], p=serve_p, m=serve_m, batch_size=serve_b,
             buckets=list(s.buckets), construct_s=construct_s,
             launches=launches, f32_batches=f_batches,
             int8_batches=i_batches, bucket_batches=st["bucket_batches"],
             replayed_bit_for_bit=replayed, **errs,
             f32=f_res, int8=i_res,
             offline_back_to_back_ms=offline_ms,
             offline_samples_per_s={k: serve_b * serve_n / (v * 1e-3)
                                    for k, v in offline_ms.items()},
             peak_memory_gb=peak_gb, memory_before_gb=base_gb,
             out_buffers=out_buffers,
             degraded=st["degraded"], quarantined=st["quarantined"])
        del s, f_futs, i_futs, f_first, i_first, f_kept, i_kept
    # the rate users see: no replay log, and clients drop their results
    label = "serve pfb_power results dropped"
    gc.collect()
    zero_counts()
    s = graph.PipelineService(pfb_g, serve_n, batch_size=serve_b,
                              batching="continuous", lowering="kernel")
    s.start()
    f_first, f_kept, f_futs, f_res = serve_window(s, f32_reqs, None,
                                                  keep=False)
    s.close()
    launches = counts()
    st = s.stats()
    want = dict.fromkeys(launches, 0)
    want.update(pfb_fused=st["batches"], elementwise_chain=st["batches"])
    if launches != want or st["degraded"] or st["quarantined"] \
            or s.downgrades or not np.array_equal(
                f_first.result(timeout=0), f_kept):
        fail(f"{label}: launches {launches}, want {want}; degraded "
             f"{st['degraded']}, quarantined {st['quarantined']}")
    emit(phase="serve", case="pfb_power results dropped", overlap=True,
         record_batches=False, x=[serve_n], batch_size=serve_b,
         launches=launches, f32_batches=st["batches"],
         f32_max_abs_err_of_max=hold_oracle(label, f32_reqs[1:], f_futs,
                                            "f32"),
         f32=f_res, offline_back_to_back_ms=offline_ms["f32"])
    del s, f_futs, f_first, f_kept
    obs.disable()
    del f32_reqs, i8_reqs

    # faults on the card: poison rows and a transient fault, then a
    # bucket forced past degrade_after
    fault_rng = np.random.default_rng(2022)
    reqs = [fault_rng.standard_normal(serve_n, dtype=np.float32)
            for _ in range(serve_b)]
    poison = {3, 11}
    for i in poison:
        reqs[i][serve_n // 3] = np.nan
    # the transient entry first: the first check fires it (one retry),
    # then the poison entry fails the batch and bisection isolates rows
    os.environ["TINA_FAULTS"] = "device_run:once,device_run:nan"
    faults.reset()
    try:
        s = graph.PipelineService(pfb_g, serve_n, batch_size=serve_b,
                                  batching="continuous", lowering="kernel",
                                  record_batches=True, retry_backoff_ms=0.0)
        futs = [s.submit(x) for x in reqs]
        s.flush()
        s.close()
        injected = faults.stats()
    finally:
        os.environ.pop("TINA_FAULTS")
        faults.reset()
    failed = {i for i, f in enumerate(futs) if f.exception(timeout=0)}
    st = s.stats()
    if failed != poison or not all(isinstance(futs[i].exception(timeout=0),
                                              faults.InjectedFault)
                                   for i in poison):
        fail(f"serve faults: failed requests {sorted(failed)}, want exactly "
             f"the poisoned {sorted(poison)}")
    if st["quarantined"] != len(poison) or st["retries"] != 1:
        fail(f"serve faults: quarantined {st['quarantined']}, retries "
             f"{st['retries']}; want {len(poison)} and 1")
    replayed = service_lib.replay_batches(s)
    if replayed != serve_b - len(poison):
        fail(f"serve faults: replay checked {replayed} healthy rows, want "
             f"{serve_b - len(poison)}")
    del s, futs, reqs
    # a failing f32 kernel bucket: the request gets the fault, and no
    # plain version is compiled in the kernel's place
    x_deg = fault_rng.standard_normal(serve_n, dtype=np.float32)
    x_pair = torch.from_numpy(np.stack([x_deg, np.zeros_like(x_deg)]))
    os.environ["TINA_FAULTS"] = "device_run@kernel:always"
    faults.reset()
    try:
        s = graph.PipelineService(pfb_g, serve_n, batch_size=2,
                                  lowering="kernel", max_retries=0,
                                  degrade_after=1, record_batches=True)
        kernel_plan = s.plans[2]
        fut = s.submit(x_deg)
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            s.flush()
        s.close()
    finally:
        os.environ.pop("TINA_FAULTS")
        faults.reset()
    err = fut.exception(timeout=0)
    if not isinstance(err, faults.InjectedFault) or s.downgrades \
            or s.stats()["degraded"] or s.plans[2] is not kernel_plan \
            or any("recompiled" in str(w.message) for w in warned):
        fail(f"serve f32 kernel failure: error {err!r}, downgrades "
             f"{s.downgrades}, plan replaced {s.plans[2] is not kernel_plan}"
             f", warnings {[str(w.message) for w in warned]}")
    f32_failure = {"error": type(err).__name__, "downgrades": s.downgrades,
                   "degraded": s.stats()["degraded"]}
    del s, kernel_plan
    # a failing int8 kernel bucket degrades to the f32 kernel plan
    f32_plan = compile_quiet(pfb_g, (2, serve_n), lowering="kernel")
    want_k = f32_plan(x_pair.to(dev))[0].cpu().numpy()
    os.environ["TINA_FAULTS"] = "device_run@kernel:once"
    faults.reset()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            s = graph.PipelineService(pfb_g, serve_n, batch_size=2,
                                      lowering="kernel", precision="int8",
                                      max_retries=0, degrade_after=1,
                                      record_batches=True)
        fut = s.submit(x_deg)
        zero_counts()
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            s.flush()
        deg_launches = counts()
        s.close()
    finally:
        os.environ.pop("TINA_FAULTS")
        faults.reset()
    deg_plan = s.plans[2]
    got = fut.result(timeout=0)
    if s.downgrades != {2: "precision:int8"} or deg_plan is not f32_plan \
            or deg_plan.device.type != "cuda" \
            or deg_launches["pfb_fused"] != 1 \
            or deg_launches["pfb_fused_int8"] != 0 \
            or not any("f32 at its own lowering" in str(w.message)
                       for w in warned):
        fail(f"serve int8 degrade: downgrades {s.downgrades}, plan on "
             f"{deg_plan.device}, launches {deg_launches}")
    if not np.array_equal(got, want_k):
        fail("serve int8 degrade: the degraded request differs from the f32 "
             "kernel plan's row")
    if service_lib.replay_batches(s) != 1:
        fail("serve int8 degrade: the degraded batch does not replay")
    emit(phase="serve", case="faults", x=[serve_n], batch_size=serve_b,
         poisoned=sorted(poison), failed=sorted(failed),
         quarantined=st["quarantined"], retries=st["retries"],
         failed_batches=st["failed_batches"], injected=injected,
         healthy_replayed_bit_for_bit=replayed,
         f32_kernel_failure=f32_failure,
         int8_degrade={"downgrades": s.downgrades,
                       "plan_device": str(deg_plan.device),
                       "lowerings": deg_plan.lowerings,
                       "precisions": deg_plan.precisions,
                       "launches": {k: v for k, v in deg_launches.items()
                                    if v},
                       "equal_to_f32_kernel_plan": True})
    del s, deg_plan, f32_plan, want_k, x_pair

    # the launcher, in process: the spectrogram cell at the kernel
    # lowering, then lowering=auto with --prewarm in a temporary cache,
    # then a short run under torch.profiler
    spec_args = ["--pipeline", "spectrogram", "--batching", "continuous",
                 "--batch", "8", "--signal-len", str(SPEC_X[1])]
    zero_counts()
    out = dsp_serve.main(spec_args + ["--lowering", "kernel", "--requests",
                                      "32", "--check", "4"])
    launches = counts()
    batches = out["stats"]["batches"]
    want = dict.fromkeys(launches, 0)
    want.update(unfold=batches, elementwise_binary=batches, dft=batches,
                elementwise_chain=batches)
    if out["served"] != 32 or out["checked"] != 4 or launches != want:
        fail(f"serve launcher: served {out['served']}, checked "
             f"{out['checked']}, launches {launches}; want {want}")
    emit(phase="serve", case="dsp_serve kernel", args=spec_args,
         served=out["served"], checked=out["checked"],
         seconds=out["seconds"], launches=launches, batches=batches,
         compiled_while_serving=out["compiled_while_serving"],
         requests_per_s=out["served"] / out["seconds"],
         latency_ms={k: {"p50": v["p50"], "p99": v["p99"]}
                     for k, v in out["stats"]["latency_ms"].items()},
         host_ms_per_batch=summary(out["stats"]["host_ms"]),
         card_ms_per_batch=summary(out["stats"]["card_ms"]))
    with tempfile.TemporaryDirectory(prefix="tina_serve_") as tmp:
        os.environ["TINA_AUTOTUNE_CACHE"] = str(Path(tmp) / "tune.json")
        autotune._MEM.clear()
        m0 = autotune.stats()["measured"]
        zero_counts()
        out = dsp_serve.main(spec_args + ["--lowering", "auto", "--prewarm",
                                          "--tune-repeats", "1",
                                          "--requests", "16", "--check",
                                          "4"])
        tuned = counts()
        os.environ.pop("TINA_AUTOTUNE_CACHE")
        if out["served"] != 16 or out["checked"] != 4 \
                or autotune.stats()["measured"] == m0:
            fail(f"serve launcher auto: served {out['served']}, checked "
                 f"{out['checked']}, measured "
                 f"{autotune.stats()['measured'] - m0}")
        emit(phase="serve", case="dsp_serve auto prewarm",
             served=out["served"], checked=out["checked"],
             measured=autotune.stats()["measured"] - m0,
             seconds=out["seconds"], launches_incl_tuning=tuned)
        out = dsp_serve.main(spec_args + ["--lowering", "kernel",
                                          "--requests", "64", "--check",
                                          "2", "--torch-profiler",
                                          str(Path(tmp) / "prof")])
        prof = out["profile"]
        if out["served"] != 64 or not prof["top_host_ops"]:
            fail(f"serve launcher profiler: served {out['served']}, "
                 f"profile {prof}")
        emit(phase="serve", case="dsp_serve torch.profiler",
             served=out["served"], batches=prof["batches"],
             top_host_ops_per_batch=prof["top_host_ops"],
             device_self_us=prof["device_self_us"],
             device_self_us_per_batch=prof["device_self_us"]
             / max(1, prof["batches"]),
             trace_bytes=os.path.getsize(prof["trace"]))

    # ======================================================================
    # mesh: every pipeline batch-sharded (graph.compile(..., mesh=)) over a
    # 1-device mesh and over 4 logical shards of the card (and over every
    # card where there are more), f32 and int8, at full width; pfb full
    # streamed on 4 shards; a serving window on each mesh
    # ======================================================================
    from repro_torch.launch.mesh import BatchMesh, make_batch_mesh

    n_cards = torch.cuda.device_count()
    meshes = [("1 device", make_batch_mesh(1)),
              ("4 logical shards", BatchMesh((dev,) * 4))]
    if n_cards > 1:
        meshes.append((f"{n_cards} cards", make_batch_mesh(n_cards)))
    mesh_launches: dict = {}

    def host_us(fn) -> float:
        """Host microseconds to enqueue one call: ``REPEATS`` back-to-back
        calls on the host clock, after two warm-up calls, while a spin
        kernel keeps the card busy (so no call waits for the card)."""
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / REPEATS
        torch.cuda.synchronize()
        return us

    def host_pair(sharded, unsharded, rounds: int = 3) -> dict:
        """``host_us`` of both, in turns (s, u, u, s, ...): each one's
        median over the rounds, and every reading."""
        got = {"sharded": [], "unsharded": []}
        for r in range(rounds):
            pair = (("sharded", sharded), ("unsharded", unsharded))
            for k, fn in (pair if r % 2 == 0 else pair[::-1]):
                got[k].append(host_us(fn))
        return {**{k: statistics.median(v) for k, v in got.items()},
                "readings": got}

    def per_shard_want(g, x, mesh, prec):
        """The per-shard single-device plan of each mesh device run on its
        slice, one after another, concatenated on the first device."""
        k = x.shape[0] // mesh.size
        parts = []
        for i, d in enumerate(mesh.devices):
            with torch.cuda.device(d):
                one = compile_quiet(g, (k, x.shape[1]), lowering="kernel",
                                    precision=prec, device=str(d))
                parts.append(one(x[i * k:(i + 1) * k].to(d)).to(x.device))
        return torch.cat(parts)

    def mesh_run(label, g, x, mesh, prec, per_call):
        """One counted call of the sharded plan (counts at 0 just before,
        read just after), held bit for bit against the per-shard plans."""
        plan = compile_quiet(g, tuple(x.shape), lowering="kernel",
                             precision=prec, mesh=mesh)
        want = per_shard_want(g, x, mesh, prec)
        torch.cuda.synchronize()
        zero_counts()
        got = plan(x)
        torch.cuda.synchronize()
        launches = counts()
        full = dict.fromkeys(launches, 0)
        full.update({k: mesh.size * v for k, v in per_call.items()})
        if launches != full:
            fail(f"{label}: launches {launches}, want {full} (the shard "
                 "count times the unsharded plan's)")
        for k, v in launches.items():
            mesh_launches[k] = mesh_launches.get(k, 0) + v
        n_diff = int((got != want).sum().item())
        if got.shape != want.shape or n_diff:
            fail(f"{label}: {tuple(got.shape)} vs the per-shard plans' "
                 f"{tuple(want.shape)}, {n_diff} elements differ")
        owned(label, got, x)
        if not bool(torch.isfinite(got).all()):
            fail(f"{label}: output not finite")
        return plan, launches

    t_mesh = time.perf_counter()
    side = torch.cuda.Stream(dev)
    for name, g, shape, _chunk, want32, want8 in stream_paths:
        x = torch.randn(*shape, device=dev, generator=gen)
        for prec, per_call in (("f32", want32), ("int8", want8)):
            base = compile_quiet(g, shape, lowering="kernel", precision=prec)
            base_ms = device_ms(torch, lambda: base(x))
            # the unsharded plan on a stream other than the default one
            # (a shard's stream is one): what the stream alone changes
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                side_ms = device_ms(torch, lambda: base(x))
            torch.cuda.current_stream(dev).wait_stream(side)
            for mlabel, mesh in meshes:
                label = f"mesh {name} {prec} {mlabel}"
                plan, launches = mesh_run(label, g, x, mesh, prec, per_call)
                ms = device_ms(torch, lambda: plan(x))
                emit(phase="mesh", path=name, precision=prec, mesh=mlabel,
                     shards=mesh.size,
                     devices=[str(d) for d in mesh.distinct], x=list(shape),
                     launches=launches, bit_for_bit=True,
                     ms={"sharded": ms, "unsharded": base_ms,
                         "unsharded_side_stream": side_ms},
                     sharded_over_unsharded=ms / base_ms,
                     host_us=host_pair(lambda: plan(x), lambda: base(x)))
                del plan
            del base
            torch.cuda.empty_cache()
        del x

    # the fig3 point (host-bound): a 1-device mesh at batch 1, 4 logical
    # shards at batch 4, each beside its unsharded plan
    fig3_g = graph.build_pfb_power(32, 8)
    for mlabel, mesh, b in (("1 device", meshes[0][1], 1),
                            ("4 logical shards", meshes[1][1], 4)):
        x = torch.randn(b, 2 ** 18, device=dev, generator=gen)
        label = f"mesh fig3 {mlabel}"
        plan, launches = mesh_run(label, fig3_g, x, mesh, "f32",
                                  {"pfb_fused": 1, "elementwise_chain": 1})
        base = compile_quiet(fig3_g, (b, 2 ** 18), lowering="kernel")
        emit(phase="mesh", path="pfb_power fig3", precision="f32",
             mesh=mlabel, shards=mesh.size, x=[b, 2 ** 18], p=32, m=8,
             launches=launches, bit_for_bit=True,
             ms={"sharded": device_ms(torch, lambda: plan(x)),
                 "unsharded": device_ms(torch, lambda: base(x)),
                 "sharded_median_call": median_ms(torch, lambda: plan(x)),
                 "unsharded_median_call": median_ms(torch, lambda: base(x))},
             host_us=host_pair(lambda: plan(x), lambda: base(x), 5))
        del x, plan, base

    # pfb full streamed over 4 logical shards: equal to offline
    name, g, shape, chunk, want32, want8 = stream_paths[0]
    x = torch.randn(*shape, device=dev, generator=gen)
    mesh4 = meshes[1][1]
    for prec, per_call in (("f32", want32), ("int8", want8)):
        label = f"mesh stream {name} {prec}"
        want = compile_quiet(g, shape, lowering="kernel", precision=prec)(x)
        runner = graph.ChunkedRunner(g, lowering="kernel", precision=prec,
                                     mesh=mesh4)
        outs = []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for i, size in chunks_of(shape[-1], chunk):
                o = runner.push(x[..., i:i + size])
                if o is not None:
                    outs.append(o)
            o = runner.finalize()
            if o is not None:
                outs.append(o)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counts()
        full = dict.fromkeys(launches, 0)
        full.update({k: 4 * v * len(outs) for k, v in per_call.items()})
        if launches != full:
            fail(f"{label}: launches {launches} over {len(outs)} pushes, "
                 f"want {full}")
        for k, v in launches.items():
            mesh_launches[k] = mesh_launches.get(k, 0) + v
        out = torch.cat(outs, dim=runner.spec.concat_axis)
        held = hold_stream(label, out, want, prec)
        emit(phase="mesh", path=f"stream {name}", precision=prec,
             mesh="4 logical shards", x=list(shape), chunk=[shape[0], chunk],
             plan_calls=len(outs), window_lens=sorted(runner.window_lens),
             launches=launches, wall_s=wall_s, **held)
        del want, out, outs, runner
    del x
    torch.cuda.empty_cache()

    # a serving window on an unsharded, a 1-device and a 4-shard service
    # (in the order u, 1, 4, 4, 1, u): pfb_power full width, f32 with an
    # int8 tenant, replay bit for bit; the first request alone, then 128
    # f32 and 64 int8 requests (32 and 16 signals, four times each: 8 and
    # 4 full batches) from 4 client threads
    obs.enable()
    mesh_rng = np.random.default_rng(2024)
    m_f32 = [mesh_rng.standard_normal(serve_n, dtype=np.float32)
             for _ in range(33)]
    m_i8 = [mesh_rng.standard_normal(serve_n, dtype=np.float32)
            for _ in range(17)]
    m_f32 = m_f32[:1] + m_f32[1:] * 4
    m_i8 = m_i8[:1] + m_i8[1:] * 4
    order = [("unsharded", None)] + meshes[:2]
    for run, (mlabel, mesh) in enumerate(order + order[::-1]):
        label = f"mesh serve {mlabel} run {run}"
        shards = 1 if mesh is None else mesh.size
        zero_counts()
        s = graph.PipelineService(pfb_g, serve_n, batch_size=serve_b,
                                  batching="continuous", lowering="kernel",
                                  record_batches=True, mesh=mesh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            s.add_tenant("pfb_int8", pfb_g, serve_n, lowering="kernel",
                         precision="int8", mesh=mesh)
        if s.buckets[0] != shards:
            fail(f"{label}: ladder {s.buckets} does not start at {shards}")
        s.start()
        _, _, f_futs, f_res = serve_window(s, m_f32, None)
        _, _, i_futs, i_res = serve_window(s, m_i8, "pfb_int8")
        s.close()
        launches = counts()
        st = s.stats()
        f_batches = st["tenants"]["default"]["batches"]
        i_batches = st["tenants"]["pfb_int8"]["batches"]
        want = dict.fromkeys(launches, 0)
        want.update(pfb_fused=shards * f_batches,
                    elementwise_chain=shards * (f_batches + i_batches),
                    pfb_fused_int8=shards * i_batches)
        if launches != want:
            fail(f"{label}: launches {launches}, want {want}")
        if mesh is not None:
            for k, v in launches.items():
                mesh_launches[k] = mesh_launches.get(k, 0) + v
        if st["degraded"] or st["quarantined"]:
            fail(f"{label}: degraded {st['degraded']}, quarantined "
                 f"{st['quarantined']}")
        errs = {"f32_max_abs_err_of_max": hold_oracle(
            label, m_f32[1:], f_futs, "f32"),
                "int8_sqnr_db": hold_oracle(label, m_i8[1:], i_futs,
                                            "int8")}
        replayed = service_lib.replay_batches(s)
        if replayed != len(m_f32) + len(m_i8):
            fail(f"{label}: replay checked {replayed} of "
                 f"{len(m_f32) + len(m_i8)} requests")
        emit(phase="mesh", case="serve", mesh=mlabel, run=run,
             shards=shards, buckets=list(s.buckets), x=[serve_n],
             batch_size=serve_b, launches=launches, replayed_bit_for_bit=replayed, **errs,
             f32=f_res, int8=i_res)
        del s, f_futs, i_futs
    obs.disable()
    del m_f32, m_i8
    emit(phase="mesh", case="done", seconds=time.perf_counter() - t_mesh,
         launches=mesh_launches)

    # -- lm: the model zoo's serving path at olmo_1b full width ------------
    lm_row = lm_phase(torch, dev, card, zero_counts, counts)
    gc.collect()
    torch.cuda.empty_cache()

    # -- lm_zoo: the zoo's MoE, recurrent, vlm and audio families ----------
    zoo_launches = lm_zoo_phase(torch, dev, card, zero_counts, counts)
    gc.collect()
    torch.cuda.empty_cache()

    # -- train: the training path at olmo_1b full width ---------------------
    train_launches = train_phase(torch, dev, card, zero_counts, counts)

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
        # f32 products at the TF32 tensor-core peak; the PFB's FIR at the
        # fp32 pipe beside its DFT at TF32
        b_ms, b_by = (bound_tf32 if name in ("dft", "matmul") else
                      bound_pfb if name == "pfb_fused" else bound)(*cost)
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
    rows.append(lm_row)
    for row in rows:
        # the kernel's launches in the mesh phase's counted runs, in each
        # lm_zoo config's (the bf16 GEMM alone runs there) and in the
        # train phase's (the native lowering; the PFB of pfb_features)
        row["mesh_launches"] = mesh_launches.get(row["name"], 0)
        row["lm_zoo_launches"] = (zoo_launches if row["name"] == "matmul_bf16"
                                  else dict.fromkeys(zoo_launches, 0))
        row["train_launches"] = train_launches.get(row["name"], 0)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
