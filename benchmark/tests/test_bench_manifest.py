"""BENCHMARK.json holds to the contract's shape, and every cell,
configuration, traffic mix, generator, metric and work formula it names
resolves to its file by name."""

import ast
import json
import os
import re

import pytest

from benchmark.harness import manifest as mf
from benchmark.tests.helpers import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len(json.dumps(m)) < 64 * 1024
    cells = len(m["workloads"])
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(cells // 4, 1)
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    m = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert x["source"] in ("host_clock", "device_trace") and UNIT.match(x["unit"])
        assert 0.01 <= x["bound"] <= 0.25 and x["better"] in ("lower", "higher")
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert x["source"] in SOURCES and UNIT.match(x["unit"]) and x["moves"] in e2e
        assert "\n" not in x["layer"] and 1 <= len(x["layer"]) <= 200
        assert set(x.get("workloads", cells)) <= cells
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/")


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_resolves_by_name(cell):
    m = manifest()
    c = mf.Cell(m, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.generator().make_pool
    for metric in c.per_layer:
        assert callable(mf.metric_reader(metric["name"]))
    work = c.config["work"]
    for net in work["per_screenshot"] + [work["per_line"], work["per_caption"]]:
        assert mf.flops_of(net)(c.config) > 0
    # every end-to-end metric the cell reports exists for it, and each
    # per-layer metric it lists moves one of them
    reported = {x["name"] for x in c.end_to_end}
    assert {"setup_s", "screenshots_per_s"} <= reported
    assert all(x["moves"] in reported for x in c.per_layer)
    # every configuration file states its limits for the comparison
    assert c.config["limits"] and all(v >= 0 for v in c.config["limits"].values())


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(*sub):
    base = os.path.join(ROOT, "benchmark", *sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "omniparser_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "omniparser_tpu_torch" not in set(_imports(path)), path
