#!/usr/bin/env python3
"""The trained path on the card: rendered screens, the trained weights,
the synthetic grounding benchmark and the three trainers.

    python scripts/export_torch_weights.py            # where JAX is: the carried fonts
    python3 scripts/trained_on_card.py check          # one chip call
    python3 scripts/trained_on_card.py train --trainer det|ocr|cap   # one chip call each
    python3 scripts/trained_on_card.py bench          # after the three trainers

The trained weights are the orbax trees committed under
``omniparser_tpu/weights/`` (``det_synth``, ``ocr_en_synth``, ``cap_synth``),
which the pipeline's ``'auto'`` fields read without JAX.  Every step needs
the carried TTF faces (``fonts/fonts.json`` in the git-ignored
``omniparser_tpu_torch/weights/exported/``): run it from a disk copy that
carries them.  Where they are missing it raises, naming
``scripts/export_torch_weights.py``; it never skips.  It needs one CUDA
device and imports no JAX.

``check``:
  scenes  the renderers' hashes at three seeds against the ones written
          below (taken on a machine with the globbed faces), with Pillow's
          and FreeType's versions, and seed 0's renders for ``scenes-diff``;
  a.      ``parse_image`` of four 1280x1280 ``render_gui_scene`` screens
          with ``PipelineConfig()`` and the trained weights in float32 (TF32
          off), the card against this machine's CPU: elements, texts,
          captions and counts equal, boxes within ``BOX_ATOL``; then the
          same screens in bfloat16 on the card: wall, synchronised stage
          times, launches, peak bytes and the profiler's idle share;
  b.      ``ShardedParse`` at (1, 1) against ``parse_image`` on those
          screens, elements matched by box, in bfloat16 and in float32;
  c.      ``eval/synth_bench`` on 2 scenes of seed 777555, card against CPU
          in float32 (every row's correctness equal, click points within
          ``BOX_ATOL``); in bfloat16 on the card those 2 scenes row by row
          against ``CPU_BF16_ROWS_777555`` and 24 scenes of seed 777100.
``train``: one trainer's CLI (``main``) at its defaults with ``--out`` in
  ``weights/exported/card/``: render and train seconds apart, the loss
  curve, peak bytes, its ``evaluate_*`` report beside the report of the
  committed (JAX-trained) weights on the same held-out seeds.
``bench``: the synthetic benchmark of the card-trained weights beside the
  committed ones on the same 24 scenes, in bfloat16.
``scenes-diff NPZ`` (any machine, no card): this machine's seed-0 renders
  against the ones a card run wrote (``chiprun_out/trained_on_card/
  scenes_seed0.npz``), with Pillow's default and basic text layouts.

Each step prints one JSON line with the card's name and power limit
(``nvidia-smi``); the lines also go to ``chiprun_out/trained_on_card/``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import parses_equal, tf32_off, with_dtype  # noqa: E402
from omniparser_tpu_torch.pipeline import EXPORT_DIR  # noqa: E402

EXPORTS = ("det_synth.npz", "ocr_en_synth.npz", "cap_synth.npz")
CARD_DIR = os.path.join(EXPORT_DIR, "card")
OUT_DIR = os.path.join(ROOT, "chiprun_out", "trained_on_card")
BOX_ATOL = 1e-4
PARSE_SEEDS = (101, 102, 103, 104)   # the four 1280x1280 screens of steps a and b
PARSE_SIZE = 1280                    # DetectorConfig().default_imgsz
BENCH_PARITY = (2, 777555)           # scenes, seed: card against CPU
BENCH_SCENES = (24, 777100)          # scenes, seed: eval/synth_bench's default seed
HASH_SEEDS = (0, 5, 777100)

# sha256 of render_gui_scene(rng(seed), size=640, return_kinds=True) and
# render_screenshot(rng(seed), 640) (pixels, then the JSON of the rest),
# taken with the globbed faces and with the carried ones (equal), Pillow
# 12.1.0 with FreeType 2.14.1 and libraqm 0.10.3 (a Pillow without raqm lays
# text out otherwise: ROADMAP C.19)
SCENE_HASHES = {
    "render_gui_scene": {
        "0": "18140c9bdbf1a4b578059fa63faf342b75fdfe370da076985a15ebd1eee26d29",
        "5": "09cbd1bffb409720bbbdc9c234b10e2492ce09261999a4b9a16b6cd51f639661",
        "777100": "10f38b5905d405992ce6d0b201c3d45d087e19351fd8493ce528e2e8df2f721a"},
    "render_screenshot": {
        "0": "a658a19fb340608e6850fde8999e18c6e12f7697519811f47af9066b1771500c",
        "5": "a487aff05758cc057e857dfd2c45378f969e3b377114b92f6700faced97febea",
        "777100": "8646c3a550beab725703e15b92b07defd7e86b67230f6b002061eeeb58a6aaee"},
}

# the port's synth bench on a CPU in bfloat16, scenes 2, seed 777555 (38
# of 39 rows correct, 0.97436): each row's correctness, in order
CPU_BF16_ROWS_777555 = tuple(c == "1" for c in "111111111111111111111111111111111111101")


def require_inputs(export_dir: str = EXPORT_DIR) -> None:
    """Raise where the carried faces are missing (the trained weights are
    the committed trees, which 'auto' reads and names where missing)."""
    from omniparser_tpu_torch.train import synth_text

    manifest = os.path.join(export_dir, "fonts", synth_text.FONT_MANIFEST)
    if not synth_text.carried_fonts(os.path.dirname(manifest)):
        raise FileNotFoundError(
            f"missing {manifest}: write it with `python scripts/export_torch_weights.py` on a "
            "machine with TTF faces, and run this script from a copy of the repository that "
            "carries it")
    synth_text.require_fonts()


# ------------------------------------------------------------------ #
# output
# ------------------------------------------------------------------ #

_CARD = {"line": None, "log": None}


def emit(step: str, **fields) -> None:
    line = json.dumps({"step": step, "card": _CARD["line"], **fields})
    print(line, flush=True)
    if _CARD["log"] is not None:
        with open(_CARD["log"], "a") as f:
            f.write(line + "\n")


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------ #
# scenes and configurations
# ------------------------------------------------------------------ #


def scene_hashes(seeds=HASH_SEEDS):
    from omniparser_tpu_torch.train.synth_gui import render_gui_scene
    from omniparser_tpu_torch.train.synth_text import render_screenshot

    def digest(out):
        h = hashlib.sha256(np.ascontiguousarray(out[0]).tobytes())
        h.update(json.dumps(out[1:], default=str).encode())
        return h.hexdigest()

    return {
        "render_gui_scene": {str(s): digest(render_gui_scene(
            np.random.default_rng(s), size=640, return_kinds=True)) for s in seeds},
        "render_screenshot": {str(s): digest(render_screenshot(
            np.random.default_rng(s), 640)) for s in seeds},
    }


def renderer_versions():
    import importlib.util

    import PIL
    from PIL import features

    out = {"pillow": PIL.__version__, "freetype": features.version("freetype2"),
           "raqm": features.version("raqm"), "numpy": np.__version__}
    if importlib.util.find_spec("cv2") is not None:
        import cv2

        out["cv2"] = cv2.__version__
    return out


def parse_screens(seeds=PARSE_SEEDS, size=PARSE_SIZE):
    from omniparser_tpu_torch.train.synth_gui import render_gui_scene

    return [render_gui_scene(np.random.default_rng(s), size=size)[0] for s in seeds]


def bench_config(cfg):
    """eval/synth_bench's pipeline: the detector at the scenes' 640."""
    return dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector,
                                                                 default_imgsz=640))


def card_weights(cfg, directory: str = CARD_DIR):
    return dataclasses.replace(
        cfg, detector_weights=os.path.join(directory, "det_synth.npz"),
        ocr_weights=os.path.join(directory, "ocr_en_synth.npz"),
        captioner_weights=os.path.join(directory, "cap_synth.npz"))


# ------------------------------------------------------------------ #
# comparisons (CPU-testable: each takes its pipelines)
# ------------------------------------------------------------------ #


def parse_all(pipe, images):
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for img in images:
            _, _, elements = pipe.parse_image(img)
            out.append((elements, dict(pipe.last_counts)))
    return out


def stage_profile(pipe, images, dev, profile: bool = True):
    """Per screen: the parse's wall, synchronised stage times, host stage
    times, launches, counts, peak bytes, and one profiled parse's device
    time and idle share."""
    from chip_smoke import all_counts, profile_pass, reset_counts

    def wall(img):
        sync(dev)
        t0 = time.perf_counter()
        pipe.parse_elements(img)
        sync(dev)
        return (time.perf_counter() - t0) * 1e3

    rows = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for img in images:
            pipe.parse_elements(img)  # warm-up of this screen's shapes
            if torch.device(dev).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            walls = [wall(img)]
            launches = all_counts()
            counts = dict(pipe.last_counts)
            host = {k: round(v * 1e3, 3) for k, v in pipe.last_timings.items()}
            peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else None
            pipe.stage_ms = {}
            pipe.parse_elements(img)
            stages = {k: round(v, 3) for k, v in pipe.stage_ms.items()}
            pipe.stage_ms = None
            walls += [wall(img) for _ in range(2)]
            row = {"wall_ms": [round(w, 2) for w in walls], "device_stage_ms": stages,
                   "host_stage_ms": host, "launches": launches, "counts": counts,
                   "max_memory_allocated": peak}
            if profile:
                row["profile"] = profile_pass(lambda: wall(img), walls)
            rows.append(row)
    return rows


def sharded_against_single(pipe, images, mesh):
    """ShardedParse of `images` against parse_image of each, matched by box."""
    from chip_smoke import element_diffs
    from omniparser_tpu_torch.parallel.sharded_parse import ShardedParse

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single = [pipe.parse_image(img)[2] for img in images]
        got = ShardedParse(pipe, mesh).parse_images(images)
    return [element_diffs(g[2], s) for g, s in zip(got, single)]


def bench(pipe, scenes: int, seed: int, log: str):
    from omniparser_tpu_torch.eval import synth_bench

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scores = synth_bench.run(scenes, seed, pipeline=pipe, log_path=log)
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    return scores, rows, time.perf_counter() - t0


def bench_rows_equal(got, want, atol: float = BOX_ATOL):
    """Rows whose instruction or correctness differ, or whose click points
    are apart by more than atol (ratio coordinates)."""
    differ, far = [], 0.0
    if len(got) != len(want):
        return [{"rows": [len(got), len(want)]}], far
    for i, (a, b) in enumerate(zip(got, want)):
        same = a["instruction"] == b["instruction"] and a["correctness"] == b["correctness"] \
            and (a["pred"] is None) == (b["pred"] is None)
        if same and a["pred"] is not None:
            d = max(abs(x - y) for x, y in zip(a["pred"], b["pred"]))
            far = max(far, d)
            same = d <= atol
        if not same:
            differ.append({"row": i, "instruction": a["instruction"],
                           "got": [a["correctness"], a["pred"]],
                           "want": [b["correctness"], b["pred"]]})
    return differ, far


def row_flips(rows, want_correct):
    """Rows whose correctness differs from a recorded run's."""
    got = tuple(r["correctness"] == "correct" for r in rows)
    if len(got) != len(want_correct):
        return [f"{len(got)} rows against {len(want_correct)}"]
    return [i for i, (a, b) in enumerate(zip(got, want_correct)) if a != b]


# ------------------------------------------------------------------ #
# check
# ------------------------------------------------------------------ #


def fail(msg: str) -> None:
    print(f"trained_on_card: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check() -> None:
    from chip_smoke import mesh_of
    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline

    scenes()

    # a. trained parity, float32 with TF32 off, card against CPU
    images = parse_screens()
    cfg32 = with_dtype(PipelineConfig(), "float32")
    t0 = time.perf_counter()
    with tf32_off():
        gpu32 = SOMPipeline(cfg32, device="cuda")
        got = parse_all(gpu32, images)
        card_s = time.perf_counter() - t0
        cpu32 = SOMPipeline(cfg32, device="cpu")
        t1 = time.perf_counter()
        want = parse_all(cpu32, images)
        cpu_s = time.perf_counter() - t1
        ok, rows = parses_equal(got, want)
        sharded32 = sharded_against_single(gpu32, images, mesh_of(1, 1))
    emit("a_trained_parity", dtype="float32, TF32 off", seeds=PARSE_SEEDS,
         size=PARSE_SIZE, equal=ok, per_image=rows, card_seconds=round(card_s, 2),
         cpu_seconds=round(cpu_s, 2))
    del gpu32
    torch.cuda.empty_cache()
    if not ok:
        fail(f"trained float32 parses differ card against CPU: {rows}")

    pipe = SOMPipeline(PipelineConfig(), device="cuda")
    emit("a_trained_stages", dtype="bfloat16", seeds=PARSE_SEEDS,
         per_image=stage_profile(pipe, images, "cuda"))

    # b. ShardedParse (1, 1) against parse_image on trained weights
    diffs = sharded_against_single(pipe, images, mesh_of(1, 1))
    emit("b_sharded_parse", mesh=[1, 1], bfloat16=diffs, float32_tf32_off=sharded32)

    # c. synth bench: float32 card against CPU, then bfloat16 on the card
    os.makedirs(OUT_DIR, exist_ok=True)
    n, seed = BENCH_PARITY
    with tf32_off():
        bcfg32 = bench_config(cfg32)
        s_gpu, r_gpu, t_gpu = bench(SOMPipeline(bcfg32, device="cuda"), n, seed,
                                    os.path.join(OUT_DIR, "bench_f32_cuda.jsonl"))
        s_cpu, r_cpu, t_cpu = bench(SOMPipeline(bcfg32, device="cpu"), n, seed,
                                    os.path.join(OUT_DIR, "bench_f32_cpu.jsonl"))
    differ, far = bench_rows_equal(r_gpu, r_cpu)
    emit("c_bench_parity", dtype="float32, TF32 off", scenes=n, seed=seed, rows=len(r_gpu),
         card_score=s_gpu["overall"], cpu_score=s_cpu["overall"], rows_differing=differ,
         max_click_diff=far, card_seconds=round(t_gpu, 1), cpu_seconds=round(t_cpu, 1))
    if differ:
        fail(f"synth bench rows differ card against CPU in float32: {differ}")

    bpipe = SOMPipeline(bench_config(PipelineConfig()), device="cuda")
    s2, r2, t2 = bench(bpipe, n, seed, os.path.join(OUT_DIR, "bench_bf16_777555.jsonl"))
    emit("c_bench_bf16", scenes=n, seed=seed, scores=s2, seconds=round(t2, 1),
         rows_flipped_against_cpu_bf16=row_flips(r2, CPU_BF16_ROWS_777555),
         cpu_bf16_overall=round(float(np.mean(CPU_BF16_ROWS_777555)), 5))
    n, seed = BENCH_SCENES
    s24, r24, t24 = bench(bpipe, n, seed, os.path.join(OUT_DIR, "bench_bf16_exported.jsonl"))
    emit("c_bench_bf16", scenes=n, seed=seed, rows=len(r24), scores=s24,
         seconds=round(t24, 1), seconds_per_row=round(t24 / max(len(r24), 1), 4))


def scenes() -> None:
    """The renderers' hashes against SCENE_HASHES, and seed 0's scene and
    screenshot written to OUT_DIR for a pixel comparison elsewhere."""
    from omniparser_tpu_torch.train.synth_gui import render_gui_scene
    from omniparser_tpu_torch.train.synth_text import render_screenshot

    hashes = scene_hashes()
    same = {k: {s: hashes[k][s] == SCENE_HASHES[k].get(s) for s in hashes[k]} for k in hashes}
    os.makedirs(OUT_DIR, exist_ok=True)
    scene = render_gui_scene(np.random.default_rng(0), size=640, return_kinds=True)
    shot = render_screenshot(np.random.default_rng(0), 640)
    np.savez_compressed(os.path.join(OUT_DIR, "scenes_seed0.npz"), gui=scene[0], shot=shot[0],
                        gui_rest=json.dumps(scene[1:], default=str),
                        shot_rest=json.dumps(shot[1:], default=str))
    emit("scenes", hashes_equal=same, hashes=hashes, versions=renderer_versions(),
         carried_fonts=_font_source())


@contextlib.contextmanager
def basic_layout():
    """The renderers with Pillow's basic text layout, as a Pillow built
    without libraqm lays text out."""
    from functools import lru_cache

    from PIL import ImageFont

    from omniparser_tpu_torch.train import synth_gui, synth_text

    @lru_cache(maxsize=256)
    def font(path: str, size: int):
        return ImageFont.truetype(path, size, layout_engine=ImageFont.Layout.BASIC)

    saved = synth_text._font
    synth_text._font = synth_gui._font = font
    try:
        yield
    finally:
        synth_text._font = synth_gui._font = saved


def compare_scenes(path: str):
    """Seed 0's scene and screenshot as another machine rendered them
    (``scenes``' npz) against this machine's, with Pillow's default text
    layout and with its basic one."""
    from omniparser_tpu_torch.train.synth_gui import render_gui_scene
    from omniparser_tpu_torch.train.synth_text import render_screenshot

    z = np.load(path)
    out = {}
    for layout, ctx in (("default", contextlib.nullcontext), ("basic", basic_layout)):
        with ctx():
            here = {"gui": render_gui_scene(np.random.default_rng(0), size=640,
                                            return_kinds=True),
                    "shot": render_screenshot(np.random.default_rng(0), 640)}
        out[layout] = {}
        for name, mine in here.items():
            diff = np.abs(z[name].astype(np.int32) - mine[0])
            out[layout][name] = {
                "pixels_differing": int(diff.any(-1).sum()), "pixels": int(diff[..., 0].size),
                "max_abs": int(diff.max()),
                "boxes_and_texts_equal": str(z[f"{name}_rest"]) == json.dumps(mine[1:],
                                                                               default=str)}
    return {"versions": renderer_versions(), "against": path, **out}


def _font_source():
    from omniparser_tpu_torch.train import synth_text

    return {"faces": len(synth_text._FONT_FILES),
            "carried": all(f.startswith(synth_text.CARRIED_FONT_DIR)
                           for f in synth_text._FONT_FILES)}


# ------------------------------------------------------------------ #
# train
# ------------------------------------------------------------------ #

TRAINERS = {
    # trainer: (module, export file, {function: role})
    "det": ("train_detector", "det_synth.npz",
            {"build_det_dataset": "render", "train_detector": "train",
             "evaluate_detector": "evaluate", "detector_step": "step"}),
    "ocr": ("train_ocr", "ocr_en_synth.npz",
            {"build_rec_dataset": "render", "build_det_dataset": "render",
             "train_recognizer": "train", "train_detector": "train",
             "evaluate_recognizer": "evaluate", "evaluate_detector": "evaluate",
             "ocr_step": "step"}),
    "cap": ("train_captioner", "cap_synth.npz",
            {"build_dataset": "render", "train_captioner": "train",
             "evaluate_captioner": "evaluate", "captioner_step": "step"}),
}


class Phases:
    """Wraps a trainer module's dataset builders, train and evaluate
    functions and step to time them apart and keep each step's loss: a
    render inside a train or evaluate call counts to that call's render
    seconds, not its own."""

    def __init__(self, module, roles, dev):
        self.module, self.roles, self.dev = module, roles, dev
        self.stack, self.phases, self.saved = [], [], {}

    def _wrap(self, name, role):
        fn = getattr(self.module, name)

        def wrapped(*a, **k):
            if role == "step":
                loss = fn(*a, **k)
                if self.stack:
                    self.stack[-1]["losses"].append(loss.detach())
                return loss
            if role == "render" and self.stack:
                sync(self.dev)
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.stack[-1]["render_seconds"] += time.perf_counter() - t0
                return out
            sync(self.dev)
            if torch.device(self.dev).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            rec = {"function": name, "role": role, "render_seconds": 0.0, "losses": []}
            self.stack.append(rec)
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                sync(self.dev)
            finally:
                self.stack.pop()
            rec["seconds"] = time.perf_counter() - t0
            rec["peak_bytes"] = (torch.cuda.max_memory_allocated()
                                 if torch.device(self.dev).type == "cuda" else None)
            if role == "evaluate":
                rec["report"] = out
            self.phases.append(rec)
            return out

        return wrapped

    def __enter__(self):
        for name, role in self.roles.items():
            self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, self._wrap(name, role))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def summary(self, chunk: int = 100):
        out = []
        for rec in self.phases:
            row = {k: (round(v, 2) if isinstance(v, float) else v)
                   for k, v in rec.items() if k != "losses"}
            if rec["losses"]:
                losses = torch.stack(rec["losses"]).float().cpu().numpy()
                row["steps"] = len(losses)
                row["train_seconds"] = round(rec["seconds"] - rec["render_seconds"], 2)
                row["loss_first"] = float(losses[0])
                row["loss_last"] = float(losses[-1])
                row["loss_curve"] = [round(float(losses[i:i + chunk].mean()), 5)
                                     for i in range(0, len(losses), chunk)]
                row["loss_chunk"] = chunk
            out.append(row)
        return out


def run_trainer(trainer: str, out_dir: str, argv=(), dev="cuda"):
    """The trainer's CLI at its defaults (plus `argv`) with --out in
    `out_dir`; returns (its phases, the export's path, wall seconds)."""
    import importlib

    mod_name, export, roles = TRAINERS[trainer]
    module = importlib.import_module(f"omniparser_tpu_torch.train.{mod_name}")
    out = os.path.join(out_dir, export)
    t0 = time.perf_counter()
    with Phases(module, roles, dev) as ph:
        module.main(["--out", out, *argv])
    return ph.summary(), out, time.perf_counter() - t0


def evaluate_export(trainer: str, path: str, dev="cuda", eval_kw=None):
    """The trainer's ``evaluate_*`` reports of the networks in a checkpoint
    (``'auto'``: the committed JAX-trained tree), on the default held-out
    seeds; `eval_kw` ({'det'|'rec'|'cap': kwargs}) shrinks them."""
    from omniparser_tpu_torch.config import CaptionerConfig, OcrConfig
    from omniparser_tpu_torch.models.ocr import TorchOCR
    from omniparser_tpu_torch.models.yolov8 import Detector
    from omniparser_tpu_torch.pipeline import (detector_state_from_field, florence_from_field,
                                               ocr_states_from_field)
    from omniparser_tpu_torch.train import train_captioner, train_detector, train_ocr
    from omniparser_tpu_torch.weights.init import build_module

    kw = eval_kw or {}
    if trainer == "det":
        det = Detector(variant="n", num_classes=1, imgsz=train_detector.IMGSZ)
        module = build_module(det.make_module(), detector_state_from_field(path, det), None,
                              torch.float32, dev)
        return {"det": train_detector.evaluate_detector(module, device=dev, **kw.get("det", {}))}
    if trainer == "ocr":
        cfg = OcrConfig(dtype="float32")
        ocr = TorchOCR(cfg, dev, *ocr_states_from_field(path, cfg))
        return {"rec": train_ocr.evaluate_recognizer(ocr.rec, device=dev, **kw.get("rec", {})),
                "det": train_ocr.evaluate_detector(ocr.det, device=dev, **kw.get("det", {}))}
    cap = florence_from_field(path, CaptionerConfig(dtype="float32"), None, None, dev)
    return {"cap": train_captioner.evaluate_captioner(cap.model, device=dev,
                                                      **kw.get("cap", {}))}


def train(trainer: str, argv=()) -> None:
    scenes()
    phases, path, wall = run_trainer(trainer, CARD_DIR, argv)
    emit("train", trainer=trainer, argv=["--out", path, *argv], wall_seconds=round(wall, 1),
         phases=phases)
    t0 = time.perf_counter()
    exported = evaluate_export(trainer, "auto")
    emit("train_exported_eval", trainer=trainer, weights="exported (JAX-trained)",
         report=exported, seconds=round(time.perf_counter() - t0, 1))


def bench_trained() -> None:
    from omniparser_tpu_torch.config import PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline

    missing = [n for n in EXPORTS if not os.path.exists(os.path.join(CARD_DIR, n))]
    if missing:
        raise FileNotFoundError(f"bench needs the card-trained {missing} in {CARD_DIR}: run "
                                "`scripts/trained_on_card.py train` for each trainer first")
    os.makedirs(OUT_DIR, exist_ok=True)
    n, seed = BENCH_SCENES
    out = {}
    for name, cfg in (("exported", bench_config(PipelineConfig())),
                      ("card_trained", card_weights(bench_config(PipelineConfig())))):
        pipe = SOMPipeline(cfg, device="cuda")
        scores, rows, secs = bench(pipe, n, seed, os.path.join(OUT_DIR, f"bench_{name}.jsonl"))
        out[name] = {"scores": scores, "rows": len(rows), "seconds": round(secs, 1)}
        del pipe
        torch.cuda.empty_cache()
    emit("bench", scenes=n, seed=seed, dtype="bfloat16", **out,
         gap_points=round(100 * (out["exported"]["scores"]["overall"]
                                 - out["card_trained"]["scores"]["overall"]), 3))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    sub.add_parser("check")
    tr = sub.add_parser("train")
    tr.add_argument("--trainer", choices=sorted(TRAINERS), required=True)
    tr.add_argument("trainer_args", nargs="*",
                    help="more arguments for the trainer's CLI (after --)")
    sub.add_parser("bench")
    sd = sub.add_parser("scenes-diff", help="on any machine: its renders against a "
                        "scenes_seed0.npz that a card run wrote")
    sd.add_argument("npz")
    args = ap.parse_args()
    if args.mode == "scenes-diff":
        print(json.dumps(compare_scenes(args.npz)))
        return
    require_inputs()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs one CUDA "
                           "device")
    from chip_smoke import phase_device

    _CARD["line"] = phase_device()  # prints the card's name, power limit and versions
    os.makedirs(OUT_DIR, exist_ok=True)
    _CARD["log"] = os.path.join(OUT_DIR, f"{args.mode}.jsonl")
    t0 = time.perf_counter()
    if args.mode == "check":
        check()
    elif args.mode == "train":
        train(args.trainer, args.trainer_args)
    else:
        bench_trained()
    emit("done", mode=args.mode, seconds=round(time.perf_counter() - t0, 1))


if __name__ == "__main__":
    main()
