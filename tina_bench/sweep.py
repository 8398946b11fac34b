"""The highest rate the program sustains for an open-loop cell's chunks,
found once on the card: the closed-loop capacity at the cell's chunk
size (``in_flight`` 3), then the open loop at fractions of it.

    python3 tina_bench/sweep.py --workload lofar_station.stream_realtime \
        --fractions 0.6,0.7,0.8,0.9,1.0 --seconds 6

One JSON line a rate: latency p50 / p95 / max, the generator's lateness,
and the mean latency of the window's last fifth over its first fifth (a
backlog that grows reads well above 1).  The benchmark's own runs never
run this; the rate a traffic file states comes from it.
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
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.9,1.0")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=424242)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(REPO / "src"))
    import torch
    from harness import cell as cell_lib
    from harness import drive, session
    cell = cell_lib.load(REPO, BENCH, args.workload)
    dev = torch.device("cuda", 0)
    closed = dataclasses.replace(cell, traffic=dict(
        cell.traffic, mode="closed", in_flight=3))
    r, w = session.run(closed, args.seed, args.seconds, False, dev,
                       time.perf_counter())
    cap = len(w.calls) / w.window_s
    print(json.dumps({"capacity_chunks_per_s": cap,
                      "correct": r["correct"]}), flush=True)
    for f in map(float, args.fractions.split(",")):
        rate = f * cap
        share = rate / drive.chunk_rate(cell.config, dict(
            cell.traffic, real_time_share=1.0))
        opened = dataclasses.replace(cell, traffic=dict(
            cell.traffic, real_time_share=share))
        r, w = session.run(opened, args.seed, args.seconds, False, dev,
                           time.perf_counter())
        lat = [c.ready - c.due for c in w.calls]
        late = sorted(c.issued - c.due for c in w.calls)
        s = sorted(lat)
        fifth = max(1, len(lat) // 5)
        q = lambda v, p: v[min(len(v) - 1, int(p * len(v)))] * 1e3
        print(json.dumps({
            "fraction": f, "chunks_per_s": rate, "real_time_share": share,
            "calls": len(lat),
            "p50_ms": q(s, 0.5), "p95_ms": q(s, 0.95), "max_ms": s[-1] * 1e3,
            "late_p99_ms": q(late, 0.99), "late_max_ms": late[-1] * 1e3,
            "growth": (sum(lat[-fifth:]) / sum(lat[:fifth])),
            "stalls": [[round(c.issued, 4), round((c.issued - c.due) * 1e3, 3)]
                       for c in w.calls if c.issued - c.due > 5e-3][:40],
            "correct": r["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
