"""A --device cpu rehearsal of each cell at the small sizes of tiny.json
prints a line of the contract's shape, judged correct; a traced rehearsal
prints the cell's per-layer metrics; the control (float8 products) and
each planted fault make `correct` false; and a new traffic file with its
entry runs without any file being edited."""

import json
import os
import shutil

import pytest

from benchmark.harness import manifest as mf
from benchmark.tests.helpers import ROOT, manifest, rehearse

CELLS = [w["name"] for w in manifest()["workloads"]]


def _contract_shape(line, cell, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    c = mf.Cell(manifest(), cell)
    want = {m["name"]: m["unit"] for m in (c.per_layer if trace else c.end_to_end)}
    for name, v in line["metrics"].items():
        assert want[name] == v["unit"] and isinstance(v["value"], float)
    assert line["device"]["platform"] == "cpu"
    for name, chk in line["checks"].items():
        assert set(chk) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_correct_contract_line(cell):
    rc, line, err = rehearse(cell)
    assert rc == 0, err[-3000:]
    _contract_shape(line, cell, trace=False)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert {"screenshots_per_s", "parse_p50_ms", "setup_s"} <= set(line["metrics"])
    # the checks are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_traced_rehearsal_reads_the_per_layer_metrics():
    cell = CELLS[0]
    rc, line, err = rehearse(cell, trace=1)
    assert rc == 0, err[-3000:]
    _contract_shape(line, cell, trace=True)
    # on the CPU there is no device trace: the program's spans and counters only
    assert {"shots_per_batch", "host_dispatch_ms_per_shot", "fused_step_ms_per_shot",
            "mfu"} <= set(line["metrics"])
    assert "device_idle_share" not in line["metrics"]


def test_control_fails_a_limit():
    rc, line, err = rehearse(CELLS[0], "--control")
    assert rc == 0, err[-3000:]
    limits = line["checks"]
    over = [n for n, v in line["control"].items() if v > limits[n]["limit"]]
    assert over, line["control"]
    assert line["control_correct"] is False and line["correct"] is True


@pytest.mark.parametrize("fault", ["token", "half_batch", "detector", "components", "captions"])
def test_a_planted_fault_makes_correct_false(fault):
    rc, line, err = rehearse(CELLS[0], "--fault", fault)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, (fault, line["checks"])


def test_a_new_traffic_file_runs_without_editing_any_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".build", ".cache"))
    for name in ("omniparser_tpu_torch", "omniparser_tpu"):
        os.symlink(os.path.join(ROOT, name), root / name)
    m = manifest()
    src = mf.read_json("traffic", m["workloads"][0]["traffic"] + ".json")
    src["clients"] = 3
    with open(root / "benchmark" / "traffic" / "three-agents.json", "w") as f:
        json.dump(src, f)
    m["workloads"].append({"name": "florence2-three-agents", "config": m["workloads"][0]["config"],
                           "traffic": "three-agents", "chips": 1, "why": "added by data alone"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(m, f)
    rc, line, err = rehearse("florence2-three-agents", root=str(root))
    assert rc == 0, err[-3000:]
    assert line["correct"] is True


def test_a_checkout_without_the_program_fails_without_a_result(tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".build", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    rc, line, err = rehearse(CELLS[0], root=str(root))
    assert rc != 0 and line is None


@pytest.mark.card
def test_on_the_card_the_program_passes_and_the_control_fails(card):
    """The dense cell at its own size on the card: the program's numbers
    within their limits, the control's over at least one."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                           "--workload", CELLS[0], "--seed", "3141592653", "--seconds", "20",
                           "--trace", "0", "--control"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert any(v > line["checks"][n]["limit"] for n, v in line["control"].items())
    assert line["control_correct"] is False
