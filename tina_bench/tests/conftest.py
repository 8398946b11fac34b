"""Fixtures of the benchmark's own tests (CPU, tiny sizes).

``tiny_repo`` is a temporary checkout: a copy of ``tina_bench`` beside a
``BENCHMARK.json`` whose cells run a small PFB on the CPU, with the
program's kernels' plain versions."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "name": "tiny_pfb", "pipeline": "pfb_power", "n_branches": 16,
    "n_taps": 4, "window": "hamming", "signals": 4,
    "sample_rate_hz": 102400, "lowering": "kernel",
    "precision": "f32", "limits": {"power_gap": 1e-5},
}
TINY_TRAFFIC = {
    "stream_closed": {"entry": "stream", "mode": "closed", "chunk_len": 1024,
                      "in_flight": 2, "preroll_s": 0.02, "pool_chunks": 3,
                      "warmup_calls": 3,
                      "check_runs": 2, "check_run_len": 2},
    "stream_open": {"entry": "stream", "mode": "open", "chunk_len": 512,
                    "real_time_share": 1.0, "max_in_flight": 4,
                    "preroll_s": 0.02,
                    "pool_chunks": 3, "warmup_calls": 3, "check_runs": 2,
                    "check_run_len": 2},
    "offline_closed": {"entry": "offline", "mode": "closed",
                       "chunk_len": 2048, "in_flight": 2, "preroll_s": 0.02,
                       "pool_chunks": 2,
                       "warmup_calls": 2, "check_runs": 2,
                       "check_run_len": 1},
}


def tiny_spec() -> dict:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny_pfb", "source": "a test",
                        "file": "tina_bench/configs/tiny_pfb.json",
                        "reduced": [], "why": "a test"}]
    spec["workloads"] = [
        {"name": f"tiny.{t}", "config": "tiny_pfb", "traffic": t,
         "chips": 1, "why": "a test"} for t in TINY_TRAFFIC]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return spec


@pytest.fixture
def tiny_repo(tmp_path) -> Path:
    shutil.copytree(BENCH, tmp_path / "tina_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "tina_bench"
    (bench / "configs" / "tiny_pfb.json").write_text(json.dumps(TINY_CONFIG))
    for name, t in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(t))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(tiny_spec()))
    return tmp_path


def run_cpu(repo: Path, workload: str, seed: int = 7, seconds: float = 0.3,
            traced: bool = False, **kw) -> dict:
    """One run of ``workload`` on the CPU, past the harness's look for a
    card; returns the result line's fields."""
    import time

    import torch
    from harness import cell as cell_lib
    from harness import session
    cell = cell_lib.load(repo, repo / "tina_bench", workload)
    result, _ = session.run(cell, seed, seconds, traced,
                            torch.device("cpu"), time.perf_counter(), **kw)
    return result
