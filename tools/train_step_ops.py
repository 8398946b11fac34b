"""Where a train step's card time goes, by aten op, on an NVIDIA card.

Builds ``make_train_step`` for olmo_1b's full config as chip_smoke's
``train`` phase does (f32 params, bf16 compute, AdamW, remat, the bf16
wire; batch 8 x 512 from ``SyntheticDataset(seed=0)``), runs 3 warm-up
steps, then profiles ``--steps`` steps with ``torch.profiler`` and
prints one JSON line: the card's name and power limit as ``nvidia-smi``
gives them, the steps' CUDA-event ms, the card's busy ms a step, and
the self device ms a step of the ``--top`` aten ops (the kernels an op
launches itself; an op's share of the step, and its call count).

    python3 tools/train_step_ops.py [--steps 2] [--top 25]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_step_ops: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.distributed import step as step_lib
    from repro_torch.models import convert
    from repro_torch.models import model as model_lib
    from repro_torch.optim import make_optimizer, warmup_cosine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = get("olmo_1b")
    lr_fn = warmup_cosine(1e-3, 5, 30)
    fn, _ = step_lib.make_train_step(cfg, batch_size=8, seq_len=512,
                                     lr_fn=lr_fn, device=dev)
    params = convert.stack_params(model_lib.init_model(cfg, seed=0,
                                                       device=dev))
    st = make_optimizer(cfg, lr_fn).init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticDataset(cfg, 8, 512, seed=0)[0].items()}
    for _ in range(3):
        params, st, _ = fn(params, st, batch)
    torch.cuda.synchronize()
    step_ms = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                params, st, _ = fn(params, st, batch)
                e1.record()
                e1.synchronize()
                step_ms.append(e0.elapsed_time(e1))
        events = prof.key_averages()
    n = args.steps

    def dev_ms(ev) -> float:
        return (getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0)) or 0.0) \
            / n / 1e3

    kernels = [ev for ev in events
               if "CUDA" in str(getattr(ev, "device_type", ""))]
    busy = sum(dev_ms(ev) for ev in kernels)
    ops = sorted((ev for ev in events if ev.key.startswith("aten::")),
                 key=lambda ev: -dev_ms(ev))[:args.top]
    print(json.dumps({
        "tool": "train_step_ops", "nvidia_smi": card,
        "torch": torch.__version__, "arch": "olmo_1b", "batch": 8,
        "seq": 512, "steps_profiled": n, "step_ms": step_ms,
        "device_busy_ms_per_step": busy,
        "aten_ops": [{"op": ev.key, "device_ms_per_step": dev_ms(ev),
                      "share_of_busy": dev_ms(ev) / busy if busy else None,
                      "calls_per_step": ev.count / n} for ev in ops]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
