"""The port's benchmark script (bench_torch.py) and demo (examples/demo_torch.py)
on the CPU: bench.py's configuration, one tiny run of the whole script with
every device field null, its FLOP count against the JAX package's XLA cost
analysis, and its refusals (no export, no card)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from omniparser_tpu import config as jcfg
from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import ocr as jocr
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models import yolov8 as tyolo
from omniparser_tpu_torch.weights.init import build_module

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

import bench_torch  # noqa: E402
import demo_torch  # noqa: E402

torch.set_num_threads(2)

TINY_DIMS = tflo.FlorenceDims(
    embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
    depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=1, decoder_layers=2,
    attn_heads=4, ffn_dim=64, vocab_size=160, max_positions=64)  # 160 holds the prompt ids


def tiny(cfg):
    """Narrow widths for the CPU: detector and OCR at 128, short crops and decode."""
    r = dataclasses.replace
    return r(cfg,
             detector=r(cfg.detector, default_imgsz=128, max_detections=16, dtype="float32"),
             ocr=r(cfg.ocr, det_imgsz=128, rec_max_width=128, max_text_boxes=32,
                   dtype="float32"),
             captioner=r(cfg.captioner, batch_size=8, crop_size=32, max_new_tokens=4,
                         dtype="float32"))


def test_bench_config_is_bench_py_configuration():
    """bench_config() is bench.py:68-87's PipelineConfig field by field; the
    trained OCR that bench.py names as the orbax directory is 'auto' here,
    the export that scripts/export_torch_weights.py writes from it."""
    base = jcfg.PipelineConfig()
    want = dataclasses.replace(
        base, max_upload_side=1920, max_som_side=1920,
        captioner=dataclasses.replace(base.captioner, quant="int8"))
    ocr_ckpt = os.path.join(ROOT, "omniparser_tpu", "weights", "ocr_en_synth")
    if os.path.isdir(ocr_ckpt):
        want = dataclasses.replace(want, ocr_weights=ocr_ckpt)
        assert os.path.samefile(jocr.default_ocr_weights(want.ocr), ocr_ckpt)
    want = dataclasses.asdict(dataclasses.replace(want, captioner_weights=None))
    got = dataclasses.asdict(bench_torch.bench_config())
    assert want.pop("ocr_weights") in ("auto", ocr_ckpt)
    assert got.pop("ocr_weights") == "auto"
    assert got == want
    assert got["captioner_weights"] is None and got["captioner"]["quant"] == "int8"
    assert got["captioner"]["split_decode"] and got["detector_weights"] == "auto"
    seeded = dataclasses.asdict(bench_torch.bench_config("seeded"))
    assert seeded.pop("detector_weights") is None and seeded.pop("ocr_weights") is None
    got.pop("detector_weights")
    assert seeded == got


def test_bench_runs_on_the_cpu_with_device_fields_null(capsys):
    out = bench_torch.main(["--device", "cpu", "--weights", "seeded", "--inputs", "synthetic",
                            "--size", "256", "--count", "2", "--rounds", "1", "--calls", "3"],
                           reduce=tiny, captioner_dims=TINY_DIMS)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    keys = {"metric", "value", "unit", "vs_baseline", "best_round_shots_per_sec",
            "p50_latency_s", "mfu", "device_flops_per_parse", "device_flops_split",
            "device_time_share", "captioner_quant", "ocr_weights", "stage_timings_s", "device",
            "weights", "inputs", "p90_latency_s", "n_calls", "launches_per_parse", "peak_bytes",
            "device_stage_ms", "decode_device_ms", "top_kernels", "kernel_launches", "correct",
            "flops_note"}
    assert keys <= set(out) and "ocr_det_step_s" not in out
    assert all(out[k] is None for k in bench_torch.DEVICE_FIELDS)
    assert out["device"] == "cpu" and out["weights"] == "seeded"
    assert out["inputs"] == {"kind": "synthetic", "seed": 0, "size": [144, 256], "count": 2}
    assert out["correct"] is True and out["n_calls"] == 3 and len(out["rounds_s"]) == 1
    assert out["device_flops_per_parse"] > 0
    split = out["device_flops_split"]
    assert sum(split.values()) == out["device_flops_per_parse"]
    assert min(split.values()) > 0  # OCR detect, fused step, decode (kb >= 8)
    assert out["counts"]["kb"] >= 8 and out["value"] > 0
    assert out["p90_latency_s"] >= out["p50_latency_s"] > 0


def test_nearest_rank_and_greedy_recall_match():
    assert bench_torch.nearest_rank(range(1, 101), 0.9) == 90.0
    assert bench_torch.nearest_rank([3.0], 0.9) == 3.0
    gt = np.float32([[0, 0, 10, 10], [20, 20, 30, 30], [50, 50, 60, 60]])
    pred = np.float32([[0, 0, 10, 9], [21, 21, 30, 30], [0, 0, 10, 10], [80, 80, 90, 90]])
    assert bench_torch._iou_matches(gt, pred, 0.5) == 2   # one prediction per box
    assert bench_torch._iou_matches(gt, pred[:0], 0.5) == 0


def _xla_flops(fn, *args) -> float:
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"])


def _torch_flops(call) -> int:
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        call()
    return fc.get_total_flops()


def test_flop_counts_against_the_jax_cost_analysis():
    """FlopCounterMode (the script's counter) against XLA's cost analysis of
    the same JAX modules on the CPU (the JAX package's flops_per_parse).
    They count different things, measured before the bounds were set:
    - the detector forward at 256: torch 1.0412x XLA.  Torch counts every tap
      of a padded convolution window, XLA only the taps inside the input;
      XLA also counts the elementwise ops torch leaves out.  Bound [1, 1.06].
    - one decode step (d_model 256, 8 rows, the last of 8 cached positions,
      14 encoder tokens): torch 0.9667x XLA, the elementwise ops (layer
      norms, softmax, GELU, residuals) that XLA counts and torch does not.
      Bound [0.95, 1]; torch's count is the matmuls' exactly."""
    s = 256
    jm = jyolo.YOLOv8(variant="n", num_classes=1, dtype=jnp.float32)
    x = jax.ShapeDtypeStruct((1, s, s, 3), jnp.float32)
    want = _xla_flops(lambda v, a: jm.apply(v, a),
                      jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), x)
    det = tyolo.Detector(imgsz=s)
    mod = build_module(det.make_module(), None, torch.Generator().manual_seed(0),
                       torch.float32, "cpu")
    got = _torch_flops(lambda: mod(torch.zeros(1, 3, s, s)))
    assert 1.0 <= got / want <= 1.06, (got, want)

    d, ff, vocab, heads, layers = 256, 1024, 2000, 4, 2
    b, t, e = 8, 8, 14
    kw = dict(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
              depths=(1, 1, 1, 1), window_size=4, d_model=d, encoder_layers=1,
              decoder_layers=layers, attn_heads=heads, ffn_dim=ff, vocab_size=vocab,
              max_positions=64)
    model = jflo.Florence2(dims=jflo.FlorenceDims(**kw), dtype=jnp.float32)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 96, 96, 3)), jnp.zeros((1, 5), jnp.int32),
                               jnp.zeros((1, 3), jnp.int32))
    hd = d // heads
    kv = lambda n: (jnp.zeros((b, n, heads, hd)), jnp.zeros((b, n, heads, hd)))
    want = _xla_flops(
        lambda v, tok, st, m, c, k: model.apply(v, tok, st, m, c, k,
                                                method=jflo.Florence2.decode_one),
        variables, jnp.zeros((b, 1), jnp.int32), jnp.int32(t - 1), jnp.ones((b, e), bool),
        [kv(t) for _ in range(layers)], [kv(e) for _ in range(layers)])
    lm = build_module(tflo.Florence2(tflo.FlorenceDims(**kw)), None,
                      torch.Generator().manual_seed(0), torch.float32, "cpu").language_model
    tkv = lambda n: (torch.zeros(b, n, heads, hd), torch.zeros(b, n, heads, hd))
    got = _torch_flops(lambda: lm.decode_step(
        torch.zeros(b, 1, dtype=torch.long), t - 1, torch.ones(b, e, dtype=torch.bool),
        [tkv(t) for _ in range(layers)], [tkv(e) for _ in range(layers)]))
    # per token and layer: q, k, v, o and the cross q, o projections, the FFN,
    # scores and values over t cached and e encoder positions; then the head
    macs = layers * (6 * d * d + 2 * d * ff + 2 * (t + e) * d) + d * vocab
    assert got == 2 * b * macs
    assert 0.95 <= got / want <= 1.0, (got, want)


def test_exported_weights_missing_raise(tmp_path, monkeypatch):
    """The default weights are the committed trees: where they are missing
    the benchmark raises naming the tree, before any work."""
    from omniparser_tpu_torch import pipeline

    assert bench_torch.parse_args([]).weights == "trained"
    assert bench_torch.require_trees() == {
        "detector_weights": os.path.join("omniparser_tpu", "weights", "det_synth"),
        "ocr_weights": os.path.join("omniparser_tpu", "weights", "ocr_en_synth")}
    monkeypatch.setattr(pipeline, "TRAINED_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "det_synth")):
        bench_torch.main(["--device", "cpu"])


def test_rendered_inputs_need_the_faces(monkeypatch):
    """Rendered scenes need a TTF face (here, or the carried set): without
    one the benchmark raises naming where it looked, before any work."""
    from omniparser_tpu_torch.train import synth_text

    monkeypatch.setattr(synth_text, "_FONT_FILES", [])
    with pytest.raises(RuntimeError, match="fonts.json"):
        bench_torch.main(["--device", "cpu", "--weights", "seeded"])


def test_bench_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"), "--weights",
                          "seeded", "--inputs", "synthetic"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"metric"' not in out.stdout


def test_demo_writes_overlays_and_element_tables(tmp_path):
    from PIL import Image

    from omniparser_tpu_torch.pipeline import SOMPipeline

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo_torch.main([str(tmp_path / "none.png")])  # --device defaults to cuda
    img = bench_torch.synthetic_screenshot(np.random.default_rng(3), 144, 256)
    Image.fromarray(img).save(tmp_path / "shot.png")
    cfg = tiny(bench_torch.bench_config("seeded"))
    pipe = SOMPipeline(cfg, device="cpu", captioner_dims=TINY_DIMS)
    results = demo_torch.main([str(tmp_path / "shot.png"), "--out", str(tmp_path / "out")],
                              pipeline=pipe)
    with open(tmp_path / "out" / "shot_elements.json") as f:
        elements = json.load(f)
    assert elements == json.loads(json.dumps(results[0][2]))
    assert elements == json.loads(json.dumps(pipe.parse_image(img)[2])) and elements
    som = np.asarray(Image.open(tmp_path / "out" / "shot_som.png"))
    assert som.shape == img.shape
