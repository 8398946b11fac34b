"""A configuration, a traffic mix or a metric is added by adding a file:
dropped into a copy of the harness, each is found by name and runs."""
import json

import pytest
from conftest import TINY_CONFIG, run_cpu


def _add_cell(repo, name, config, traffic, metric=None):
    spec = json.loads((repo / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1, "why": "x"})
    if metric is not None:
        spec["per_layer"].append(metric)
    (repo / "BENCHMARK.json").write_text(json.dumps(spec))


def test_new_traffic_file_found(tiny_repo):
    t = {"entry": "stream", "mode": "closed", "chunk_len": 768,
         "in_flight": 1, "pool_chunks": 2, "warmup_calls": 2,
         "check_runs": 1, "check_run_len": 3}
    (tiny_repo / "tina_bench/traffic/short_bursts.json").write_text(
        json.dumps(t))
    _add_cell(tiny_repo, "tiny.short_bursts", "tiny_pfb", "short_bursts")
    r = run_cpu(tiny_repo, "tiny.short_bursts")
    assert r["correct"] and r["attempted"] > 0


def test_new_config_file_found(tiny_repo):
    cfg = dict(TINY_CONFIG, name="tiny_wide", n_branches=32, n_taps=3,
               window="hann", signals=2)
    (tiny_repo / "tina_bench/configs/tiny_wide.json").write_text(
        json.dumps(cfg))
    spec = json.loads((tiny_repo / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_wide", "source": "x",
                            "file": "tina_bench/configs/tiny_wide.json",
                            "reduced": [], "why": "x"})
    (tiny_repo / "BENCHMARK.json").write_text(json.dumps(spec))
    _add_cell(tiny_repo, "tiny_wide.stream", "tiny_wide", "stream_closed")
    r = run_cpu(tiny_repo, "tiny_wide.stream")
    assert r["correct"]
    assert r["checks"]["power_gap"]["value"] < 1e-5


def test_new_metric_file_found(tiny_repo):
    (tiny_repo / "tina_bench/metrics/calls_seen.py").write_text(
        "def read(w):\n    return float(len(w.calls))\n")
    _add_cell(tiny_repo, "tiny.counted", "tiny_pfb", "stream_closed",
              {"name": "calls_seen", "unit": "calls", "better": "higher",
               "source": "program_counter", "layer": "graph.stream",
               "moves": "throughput", "workloads": ["tiny.counted"]})
    r = run_cpu(tiny_repo, "tiny.counted", traced=True)
    assert r["metrics"]["calls_seen"]["value"] == r["attempted"]


def test_unknown_workload_is_refused(tiny_repo):
    with pytest.raises(KeyError):
        run_cpu(tiny_repo, "tiny.none")
