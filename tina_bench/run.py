"""Run one cell of the benchmark once, on the card this process finds.

    python3 tina_bench/run.py --workload lofar_station.stream_max \
        --seed 12345 --seconds 10 --trace 0

From the root of a checkout: the cell, its configuration and its traffic
mix are looked up by name (``BENCHMARK.json``, ``tina_bench/configs``,
``tina_bench/traffic``), the inputs made on the card from ``--seed``, the
program (``src/repro_torch``) set up and warmed, then driven for
``--seconds``.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.  Without a card (or with fewer cards than the cell asks for)
the run exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH))
    from harness import cell as cell_lib
    cell = cell_lib.load(REPO, BENCH, args.workload)

    os.environ.setdefault("USE_FLAX", "0")
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA card(s), found "
              f"{cards}; no result", file=sys.stderr)
        return 2
    src = REPO / "src"
    if not (src / "repro_torch").is_dir():
        print(f"no program at {src / 'repro_torch'}; no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from harness import session

    result, _ = session.run(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    result["device"]["card"] = _power_limit()
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}; "
              "no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
