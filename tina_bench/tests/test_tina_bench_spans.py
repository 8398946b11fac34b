"""The readers of the program's push-path spans: a traced CPU run of a
tiny stream cell that lists them reads each, and the plan's self time and
its nodes' time add up to no more than the plan's run."""
import json
import time

import torch
from harness import cell as cell_lib
from harness import session

SPAN_METRICS = ("carry_host_us", "plan_lookup_us", "plan_run_self_us",
                "kernels_host_us")


def test_push_path_span_metrics_read(tiny_repo):
    spec = json.loads((tiny_repo / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.spans", "config": "tiny_pfb",
                              "traffic": "stream_open", "chips": 1,
                              "why": "x"})
    for m in spec["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m["workloads"] = ["tiny.spans"]
    (tiny_repo / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cell_lib.load(tiny_repo, tiny_repo / "tina_bench", "tiny.spans")
    assert set(SPAN_METRICS) <= {m["name"] for m in cell.per_layer}
    r, w = session.run(cell, 11, 0.3, True, torch.device("cpu"),
                       time.perf_counter())
    got = {name: r["metrics"][name]["value"]
           for name in SPAN_METRICS + ("push_host_us",)}
    assert all(v is not None and v > 0 for v in got.values()), got
    runs = [e["dur"] for e in w.spans if e["name"] == "plan.run"]
    assert len(runs) == r["attempted"]
    mean_run = sum(runs) / len(runs)
    assert (got["plan_run_self_us"] + got["kernels_host_us"]
            <= mean_run * (1 + 1e-9))
    # the push's own time holds the lookup and the run
    assert got["plan_lookup_us"] + mean_run <= got["push_host_us"]
