"""Readings the limits of ``correct`` are set from, on the card, in one
process: the program's sound runs over many seeds, the control (the
reference one precision step down: its DFT in one TF32 pass) on the same
kept calls, and the program at its own bf16 tier.

    python3 tina_bench/calibrate.py --workload lofar_station.stream_max \
        --seeds 12 --seed0 500000 --seconds 2 --bf16-seeds 3

One JSON line a run on standard output: the seed, what ran, the widest
gap read and the verdict.  The benchmark's own runs never run this.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seed0", type=int, default=900_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--bf16-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(REPO / "src"))
    import torch
    from harness import cell as cell_lib
    from harness import session
    cell = cell_lib.load(REPO, BENCH, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: limits are read on the card only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    control = {"tf32": lambda x, call, out: cell.pipeline.control(
        x, cell.config)}
    bf16 = dataclasses.replace(cell, config=dict(cell.config,
                                                 precision="bf16"))
    for i in range(args.seeds + args.bf16_seeds):
        seed = args.seed0 + 7919 * i
        tier = "f32" if i < args.seeds else "bf16"
        run_cell = cell if tier == "f32" else bf16
        t0 = time.perf_counter()
        r, _ = session.run(run_cell, seed, args.seconds, False, dev, t0,
                           controls=control if tier == "f32" else None)
        line = {"workload": args.workload, "seed": seed, "tier": tier,
                "power_gap": r["checks"]["power_gap"]["value"],
                "correct": r["correct"], "attempted": r["attempted"],
                "checks": r["checks"], "s": time.perf_counter() - t0}
        if "controls" in r:
            line["control_tf32_gap"] = r["controls"]["tf32"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
