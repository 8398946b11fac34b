"""A cell as ``BENCHMARK.json`` names it, with every file found by name:

* ``configs[].file``               the configuration (sizes, tier, limits)
* ``<bench>/traffic/<traffic>.json`` the traffic mix's parameters
* ``<bench>/pipelines/<pipeline>.py`` the graph, reference and counts of
  the configuration's ``"pipeline"``
* ``<bench>/metrics/<metric>.py``  one reader a metric, ``read(window)``

Adding a configuration, a traffic mix or a metric is adding its file and
its entry in ``BENCHMARK.json``; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]      # BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    pipeline: ModuleType
    readers: dict[str, ModuleType]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(repo: Path, bench: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``repo/BENCHMARK.json``; ``bench`` is the
    harness folder its data files sit in."""
    spec = json.loads((repo / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(known: {sorted(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((repo / cfg_entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    layer = [m for m in spec["per_layer"] if _reports(m, workload)]
    name = config["pipeline"]
    pipeline = _module(bench / "pipelines" / f"{name}.py",
                       f"tina_pipeline_{name}")
    readers = {m["name"]: _module(bench / "metrics" / f"{m['name']}.py",
                                  "tina_metric_" + m["name"].replace(".", "_"))
               for m in e2e + layer}
    return Cell(workload, config, traffic, int(w["chips"]), e2e, layer,
                pipeline, readers)
