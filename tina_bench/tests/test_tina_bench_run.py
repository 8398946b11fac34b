"""run.py without a card: it exits non-zero and prints no result, never
falling back to the CPU; in a directory with only the benchmark's files
it finds no program and does the same."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def _run(root: Path, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "tina_bench/run.py", "--workload",
         "lofar_station.stream_max", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(REPO)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "tina_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_json_names_existing_files():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg.get("reduced", {}))
        assert (BENCH / "pipelines" / f"{cfg['pipeline']}.py").is_file()
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3])
def test_large_seeds_make_the_same_pool(seed):
    import torch
    from harness import drive
    cfg, traffic = {"signals": 2}, {"pool_chunks": 2, "chunk_len": 64}
    a = drive.make_pool(cfg, traffic, seed, torch.device("cpu"))
    b = drive.make_pool(cfg, traffic, seed, torch.device("cpu"))
    assert torch.equal(a, b) and a.shape == (2, 2, 64)


def test_open_loop_rate_is_the_configurations_real_time():
    from harness import drive
    cfg = {"sample_rate_hz": 200_000_000}
    traffic = {"real_time_share": 1.0, "chunk_len": 2 ** 18}
    assert drive.chunk_rate(cfg, traffic) == 200e6 / 2 ** 18
    assert drive.chunk_rate(cfg, dict(traffic, real_time_share=0.5)) == \
        100e6 / 2 ** 18


def test_keeper_counts_the_bytes_it_holds():
    import torch
    from harness import drive
    keeper = drive.Keeper(seed=3, runs=2, run_len=2)
    size = 5 * 7 * 4
    for i in range(40):
        keeper.offer(i, None, torch.zeros(5, 7))
        held = sum(out.numel() * 4 for run in keeper.slots for _, out in run)
        assert keeper.bytes == held
    assert keeper.most_bytes == 2 * 2 * size


def test_peak_mem_reads_the_programs_share():
    import types
    from harness import cell as cell_lib
    reader = cell_lib._module(BENCH / "metrics" / "peak_mem_gib.py", "m")
    w = types.SimpleNamespace(peak_mem_bytes=5 * 2 ** 30,
                              harness_bytes=2 * 2 ** 30)
    assert reader.read(w) == 3.0
