"""Each captioner backend and each hand-written kernel is found by its own
file: every file of benchmark/captioners/ and benchmark/kernels/ exposes
its interface, a file placed in a copy of the directory is found by name,
an unknown backend names the file it lacks, and the tiny rehearsals read
what they read before the harness found them by file."""

import importlib
import inspect
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import manifest as mf
from benchmark.tests.helpers import ROOT, manifest, rehearse

BENCH = os.path.join(ROOT, "benchmark")


def _files(sub):
    return sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, sub))
                  if f.endswith(".py") and not f.startswith("_"))


def _config_of(backend):
    for c in manifest()["configs"]:
        cfg = mf.Cell(manifest(), next(w["name"] for w in manifest()["workloads"]
                                       if w["config"] == c["name"])).config
        if cfg["pipeline"]["captioner"]["backend"] == backend:
            return cfg
    return None


@pytest.mark.parametrize("backend", _files("captioners"))
def test_every_captioner_file_exposes_the_interface(backend):
    cap = mf.load_module("captioners", backend + ".py")
    for name in ("reference", "port_dims", "warm", "fused", "readings", "served_text"):
        assert callable(getattr(cap, name)), (backend, name)
    assert list(inspect.signature(cap.readings).parameters) == [
        "judge", "crops", "tokens", "scores", "overflow", "lower"]
    cfg = _config_of(backend)
    if cfg is not None:  # a backend that a configuration of the manifest runs
        dims, make_module, keep_f32 = cap.reference(cfg)
        assert callable(make_module) and isinstance(keep_f32, tuple)
        assert isinstance(cap.fused(cfg), bool)
        assert type(cap.port_dims(cfg)).__name__ == type(dims).__name__


@pytest.mark.parametrize("kernel", _files("kernels"))
def test_every_kernel_file_exposes_the_interface(kernel):
    k = mf.load_module("kernels", kernel + ".py")
    launch = getattr(importlib.import_module(k.MODULE), k.ATTR)
    # keep takes the call's arguments by the port function's own names
    assert list(inspect.signature(k.keep).parameters) == list(
        inspect.signature(launch).parameters)
    assert callable(k.work) and os.path.isfile(os.path.join(BENCH, "flops", kernel + ".py"))
    assert k.KERNELS and all(isinstance(s, str) and s for s in k.KERNELS)
    assert any(k.COUNT_BY in s or s in k.COUNT_BY for s in k.KERNELS)
    assert kernel in mf.kernels()


def test_the_beam_attention_work_counts_the_rows_read():
    """128 crops x 5 beams, 32 heads of 80 in bfloat16, a prefix of 48, at
    step 49: the keys and values of the prefix once a crop and of each
    beam's 50 own positions, the ancestry table, the query and output."""
    k = mf.load_module("kernels", "beam_attention.py")
    ops, nbytes = k.work((128, 5, 32, 48, 80, 2, 49))
    assert nbytes == 2 * 32 * 80 * 2 * (128 * 48 + 128 * 5 * 50) + 4 * 128 * 5 * 50 \
        + 2 * 128 * 5 * 32 * 80 * 2
    assert ops == 128 * 5 * 32 * 98 * (4 * 80 + 4)
    # bytes bound it on the H100: 0.1186 ms at 3.35 TB/s
    assert nbytes / 3.35e12 > ops / 67e12
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.11858990, rel=1e-4)


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".build", ".cache"))
    return root


def test_a_file_placed_in_a_copy_is_found_by_name(tmp_path):
    root = _copy(tmp_path)
    shutil.copy(root / "benchmark" / "captioners" / "florence.py",
                root / "benchmark" / "captioners" / "echo.py")
    shutil.copy(root / "benchmark" / "kernels" / "crop_resize.py",
                root / "benchmark" / "kernels" / "crop_echo.py")
    shutil.copy(root / "benchmark" / "flops" / "crop_resize.py",
                root / "benchmark" / "flops" / "crop_echo.py")
    code = ("from benchmark.harness import manifest as mf; "
            "print(mf.captioner({'pipeline': {'captioner': {'backend': 'echo'}}}).__file__); "
            "print(sorted(mf.kernels()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-2000:]
    path, names = out.stdout.strip().splitlines()
    assert path == str(root / "benchmark" / "captioners" / "echo.py")
    assert "crop_echo" in names and "nms_keep" in names


def test_an_unknown_backend_names_its_missing_file():
    with pytest.raises(FileNotFoundError, match=r"benchmark/captioners/nowhere\.py"):
        mf.captioner({"pipeline": {"captioner": {"backend": "nowhere"}}})


# What the tiny rehearsals (seed 4242) read while the harness still named
# each captioner and kernel in its code: the comparison's numbers, and the
# per-layer metrics that a traced rehearsal reports.
GAP_ROUNDING = 1e-6  # float32 sums in another order on another host
PARENT = {
    "florence2-dense-agents16": {
        "caption_score_rms_gap": 3.3717478231665154e-07, "components_mismatch": 0.0,
        "crop_gap": 0.0, "det_head_gap": 0.0, "det_score_gap": 0.0, "merge_mismatch": 0.0,
        "nms_mismatch": 0.0, "ocr_map_rms_gap": 0.0, "rec_logit_gap": 0.0,
        "results_mismatch": 0.0},
    "blip2-agent1": {
        "caption_score_gap": 0.0, "components_mismatch": 0.0, "crop_gap": 0.0,
        "det_head_gap": 0.0, "det_score_gap": 0.0, "merge_mismatch": 0.0, "nms_mismatch": 0.0,
        "ocr_map_rms_gap": 0.0, "rec_logit_gap": 0.0, "results_mismatch": 0.0},
}
PARENT_TRACED = {
    "florence2-dense-agents16": [
        "assemble_ms_per_shot", "batcher_wait_ms.p90.hostpaced", "caption_dispatch_ms_per_shot",
        "caption_slots_per_caption", "fused_step_ms_per_shot", "host_dispatch_ms_per_shot",
        "host_finish_ms_per_shot", "mfu", "ocr_detect_ms_per_shot", "overlay_ms_per_shot",
        "parse_p90_ms.hostpaced", "queue_wait_ms.p90.hostpaced", "shots_per_batch"],
    "blip2-agent1": [
        "assemble_ms_per_shot", "beam_cache_gb_per_step", "caption_slots_per_caption",
        "fused_step_ms_per_shot", "host_dispatch_ms_per_shot", "host_finish_ms_per_shot", "mfu",
        "ocr_detect_ms_per_shot", "overlay_ms_per_shot", "shots_per_batch"],
}


@pytest.mark.parametrize("cell", sorted(PARENT))
def test_tiny_rehearsals_read_what_they_read_before(cell):
    rc, line, err = rehearse(cell, seed=4242, seconds=3.0)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and line["failed"] == 0
    got = {n: c["value"] for n, c in line["checks"].items()}
    assert set(got) == set(PARENT[cell])
    for name, want in PARENT[cell].items():
        if name.endswith("_mismatch"):
            assert got[name] == want, name
        else:
            assert got[name] == pytest.approx(want, abs=GAP_ROUNDING), name


@pytest.mark.parametrize("cell", sorted(PARENT_TRACED))
def test_traced_tiny_rehearsals_report_what_they_reported_before(cell):
    rc, line, err = rehearse(cell, seed=4242, seconds=3.0, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert sorted(line["metrics"]) == PARENT_TRACED[cell]
