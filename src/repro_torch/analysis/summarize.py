"""Render the dry-run JSON cells (:mod:`repro_torch.launch.dryrun`) into
the roofline table, the port of the reference's ``repro.analysis.summarize``.

    python -m repro_torch.analysis.summarize experiments/dryrun_torch [--md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

COLS = ["arch", "shape", "mesh", "status", "bottleneck",
        "t_compute_ms", "t_memory_refined_ms", "t_collective_ms",
        "useful_ratio", "roofline_fraction", "hbm_gb", "hbm_ok"]


def load(outdir: str) -> list[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        m = r.get("memory") or {}
        r["hbm_gb"] = round(sum(m.get(k, 0) for k in
                                ("argument_size_in_bytes",
                                 "output_size_in_bytes",
                                 "temp_size_in_bytes")) / 1e9, 2)
        rows.append(r)
    return rows


def fmt(rows: list[dict], md: bool = False) -> str:
    def cell(r, c):
        v = r.get(c, "")
        if isinstance(v, float):
            return f"{v:.3f}" if abs(v) < 100 else f"{v:.0f}"
        if v is None:
            return ""
        return str(v)

    table = [[cell(r, c) for c in COLS] for r in rows]
    if md:
        out = ["| " + " | ".join(COLS) + " |",
               "|" + "|".join("---" for _ in COLS) + "|"]
        out += ["| " + " | ".join(t) + " |" for t in table]
        return "\n".join(out)
    w = [max(len(c), *(len(t[i]) for t in table)) for i, c in enumerate(COLS)]
    out = ["  ".join(c.ljust(x) for c, x in zip(COLS, w))]
    out += ["  ".join(c.ljust(x) for c, x in zip(t, w)) for t in table]
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args()
    rows = load(args.outdir)
    print(fmt(rows, args.md))
    ok = sum(r["status"] == "ok" for r in rows)
    skip = sum(r["status"] == "skip" for r in rows)
    err = sum(r["status"] == "error" for r in rows)
    print(f"\n{ok} ok / {skip} skip / {err} error of {len(rows)} cells")


if __name__ == "__main__":
    main()
