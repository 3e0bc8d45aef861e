"""The benchmark's manifest and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that BENCHMARK.json
gives it:

  configs/<config>.json        the configuration as it is run
  traffic/<traffic>.json       the mix: a generator's name and its parameters
  generators/<generator>.py    make_pool(params, seed) -> screenshots
  metrics/<metric>.py          read(run) -> number, or None where there is
                               nothing to read
  flops/<network>.py           flops(**shape) -> the work a call needs
  captioners/<backend>.py      a captioner backend: its reference network,
                               the port's dims, warm-up, readings
                               (the interface: captioners/florence.py)
  kernels/<kernel>.py          a hand-written kernel: the port's function
                               that launches it, what a call keeps, its work
                               and trace names (the interface:
                               kernels/nms_keep.py)
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(*parts: str) -> Dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(*parts: str):
    """A module of the benchmark by its file, whatever the file's name (a
    metric's name may hold dots)."""
    path = os.path.join(BENCH_DIR, *parts)
    name = "bench_" + "_".join(parts).replace(".", "_").replace("-", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no such file of the benchmark")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads`, with its configuration, traffic and metrics."""

    def __init__(self, manifest: Dict, name: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(ROOT, self.config_entry["file"])) as f:
            self.config = json.load(f)
        self.traffic_name = self.entry["traffic"]
        self.traffic = read_json("traffic", self.traffic_name + ".json")
        self.end_to_end = self._metrics(manifest["end_to_end"])
        self.per_layer = self._metrics(manifest["per_layer"])

    def _metrics(self, entries: List[Dict]) -> List[Dict]:
        return [m for m in entries if "workloads" not in m or self.name in m["workloads"]]

    def generator(self):
        return load_module("generators", self.traffic["generator"] + ".py")


def metric_reader(name: str):
    return load_module("metrics", name + ".py").read


def flops_of(network: str):
    return load_module("flops", network + ".py").flops


def captioner(cfg: Dict):
    """The configuration's captioner backend, by its file."""
    backend = cfg["pipeline"]["captioner"]["backend"]
    if not os.path.isfile(os.path.join(BENCH_DIR, "captioners", backend + ".py")):
        raise FileNotFoundError(f"captioner backend {backend!r} has no file "
                                f"benchmark/captioners/{backend}.py")
    return load_module("captioners", backend + ".py")


def kernels() -> Dict:
    """Every kernel of benchmark/kernels/, by its file's name."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "kernels"))
                   if f.endswith(".py") and not f.startswith("_"))
    return {n: load_module("kernels", n + ".py") for n in names}
