"""Pipeline-graph quickstart on PyTorch: build, compile, stream, and
serve a DSP pipeline through the port's graph subsystem, the twin of
``examples/pipeline_quickstart.py``.

    PYTHONPATH=src python examples/torch_pipeline_quickstart.py        # card
    PYTHONPATH=src python examples/torch_pipeline_quickstart.py --device cpu

Walks the four layers: (1) declare a graph of TINA ops, (2) compile it
into a cached shape-specialized plan (and tune the kernels' tiles for
it), (3) stream a long signal through in chunks with overlap carry, (4)
serve batched requests through cached plans.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import graph, resolve_device
from repro_torch.core.opdefs import OPDEFS
from repro_torch.core.registry import PIPELINES


def main(argv=None):
    ap = argparse.ArgumentParser(prog="torch_pipeline_quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # keep the example self-contained: tune into a temp cache, not the
    # user's ~/.cache/tina/autotune_torch.json (respects an explicit env)
    os.environ.setdefault(
        "TINA_AUTOTUNE_CACHE",
        os.path.join(tempfile.gettempdir(),
                     "tina-quickstart-autotune-torch.json"))
    rng = np.random.default_rng(0)

    # -- 1. declare a pipeline as a graph of TINA ops -----------------------
    J = 64
    win = np.hanning(J).astype(np.float32)
    g = graph.Graph("my_spectrogram")
    x = g.input("x")
    w = g.const(win, "win")
    frames = g.apply("unfold", x, window=J)          # §4.4 standard conv
    windowed = g.apply("window", frames, w)          # §3.1 depthwise conv
    spec = g.apply("dft", windowed)                  # §4.1 pointwise conv
    power = g.apply("abs2", spec)
    out = g.apply("scale", power, factor=1.0 / J)
    g.output(out)
    print("graph:", g)

    # -- 2. compile: shape-specialized, fused, memoized ---------------------
    sig = rng.standard_normal(4096).astype(np.float32)
    xs = torch.as_tensor(sig, device=dev)
    plan = graph.compile(g, {"x": sig.shape}, device=dev)
    offline = plan(xs).cpu().numpy()
    plan2 = graph.compile(g, {"x": sig.shape}, device=dev)
    if plan2 is not plan:
        raise SystemExit("second compile must be a cache hit")
    print(f"plan: out {offline.shape}, cache {graph.cache_stats()}, "
          f"fused graph {plan.graph}")

    # -- 2b. autotune the kernels' tiling for these exact shapes ------------
    # block_configs="auto" searches each kernel's TuneSpace on the
    # pipeline's real shapes; winners persist to the on-disk cache
    tuned = graph.compile(g, {"x": sig.shape}, device=dev,
                          options=graph.CompileOptions(
                              lowering="kernel", block_configs="auto",
                              autotune_kwargs={"repeats": 1}))
    np.testing.assert_allclose(tuned(xs).cpu().numpy(), offline,
                               rtol=2e-3, atol=2e-3)
    print("tuned:", {k: v for k, v in tuned.configs.items() if v})

    # -- 3. stream it chunk-by-chunk: identical to offline ------------------
    chunked = graph.stream_execute(g, sig, chunk_len=1000,
                                   device=dev).cpu().numpy()
    np.testing.assert_allclose(chunked, offline, rtol=1e-6, atol=1e-6)
    print(f"stream: {sig.shape[-1]} samples in chunks of 1000 -> "
          f"{chunked.shape}, equals offline")

    # -- 4. serve batched requests through cached plans ----------------------
    # continuous batching over a ladder of pre-compiled bucket plans
    # (1/2/4): no fill deadline, padding only to the next bucket
    builtin = PIPELINES["pfb_power"]
    pg = builtin.build()
    with graph.PipelineService(pg, signal_len=1024, batch_size=4,
                               batching="continuous", device=dev) as svc:
        futs = [svc.submit(rng.standard_normal(1024).astype(np.float32))
                for _ in range(10)]
        outs = [f.result(timeout=60) for f in futs]
    print(f"service: {svc.stats()}, buckets {list(svc.buckets)}")
    xs0 = np.asarray(outs[0])

    # -- 5. every op above is ONE OpDef declaration --------------------------
    used = sorted({n.op for n in g.topo() if n.op not in ("input", "const")})
    print("ops used:", {op: (f"§{OPDEFS[op].section}" if OPDEFS[op].section
                             else "glue") for op in used})
    print("pipeline quickstart: all stages verified" if xs0.shape else "")


if __name__ == "__main__":
    main()
