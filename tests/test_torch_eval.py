"""The port's eval harnesses (``eval/``) and their jax-free renderer copies
(``train/synth_text.py``, ``train/synth_gui.py``, ``train/train_captioner.py``)
against the JAX package's, on the CPU.  Scenes are bit-equal; scores,
records and predicted ids of the synthetic grounding benchmark through the
two pipelines are tests/test_torch_pipeline.py's
(``test_synth_bench_run_matches_jax``)."""

import json

import numpy as np
import pytest
import torch

from omniparser_tpu.agent.llm import MockLLM as JMockLLM
from omniparser_tpu.eval import screenspot as jss
from omniparser_tpu.eval import synth_bench as jsb
from omniparser_tpu.train import synth_gui as jgui
from omniparser_tpu_torch.eval import screenspot as tss
from omniparser_tpu_torch.eval import synth_bench as tsb
from omniparser_tpu_torch.eval.llm import MockLLM
from omniparser_tpu_torch.train import synth_gui as tgui

torch.set_num_threads(2)


class FakePipeline:
    def parse_image(self, image_rgb):
        elements = [
            {"type": "text", "bbox": [0.1, 0.1, 0.3, 0.15], "interactivity": False,
             "content": "File", "source": "box_ocr_content_ocr"},
            {"type": "icon", "bbox": [0.5, 0.5, 0.7, 0.7], "interactivity": True,
             "content": "save", "source": "box_yolo_content_yolo"},
        ]
        coords = {"0": [0.1, 0.1, 0.2, 0.05], "1": [0.5, 0.5, 0.2, 0.2]}
        return image_rgb, coords, elements


# ------------------- twins of tests/test_eval.py ------------------- #


def test_reformat_messages():
    elems = FakePipeline().parse_image(None)[2]
    html = tss.reformat_messages(elems)
    assert '<p id=0 class="text" alt="File">' in html
    assert '<img id=1 class="icon" alt="save">' in html
    assert html == jss.reformat_messages(elems)
    assert tss.GROUNDING_PROMPT == jss.GROUNDING_PROMPT


def test_extract_bbox_id():
    for text, want in (("reasons...\nClick BBox ID: 7", 7), ("```Click BBox ID: `12```", 12),
                       ("Click BBox ID: 3 ... Click BBox ID: 5", 5), ("no id here", None)):
        assert tss.extract_bbox_id(text) == jss.extract_bbox_id(text) == want


def test_ground_only_positive(rng, tmp_path):
    import cv2

    img = rng.integers(0, 255, (100, 200, 3), dtype=np.uint8)
    path = str(tmp_path / "shot.png")
    cv2.imwrite(path, img)
    llm = MockLLM(["the save icon matches.\nClick BBox ID: 1"])
    res = tss.ScreenSpotModel(FakePipeline(), llm).ground_only_positive("save the file", path)
    assert res["point"] == pytest.approx([0.6, 0.6])
    assert res["bbox"] == pytest.approx([0.5, 0.5, 0.7, 0.7])
    content = llm.calls[0]["messages"][0]["content"]
    assert sum(1 for b in content if b["type"] == "image") == 2
    jllm = JMockLLM(["the save icon matches.\nClick BBox ID: 1"])
    assert res == jss.ScreenSpotModel(FakePipeline(), jllm).ground_only_positive(
        "save the file", path)
    assert llm.calls == jllm.calls


def test_ground_invalid_id(rng):
    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    res = tss.ScreenSpotModel(FakePipeline(), MockLLM(["Click BBox ID: 99"])
                              ).ground_only_positive("x", img)
    assert res["point"] is None


def test_score_records():
    records = [
        {"pred": [0.5, 0.5], "gt_bbox": [0.4, 0.4, 0.6, 0.6], "group": "Dev", "size_px": 30.0},
        {"pred": [0.1, 0.1], "gt_bbox": [0.4, 0.4, 0.6, 0.6], "group": "Dev", "size_px": 10.0},
        {"pred": None, "gt_bbox": [0, 0, 1, 1], "group": "OS"},
    ]
    s = tss.score_records(records)
    assert s["Dev"] == 0.5 and s["OS"] == 0.0
    assert s["overall"] == pytest.approx(1 / 3)
    assert s["n"] == 3
    assert s == jss.score_records(records)
    assert tss.wilson_ci(3, 7) == jss.wilson_ci(3, 7)


def test_run_eval_log(rng, tmp_path):
    import cv2

    img = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    data = [
        {"img_path": path, "instruction": "save", "gt_bbox": [0.5, 0.5, 0.7, 0.7], "group": "Dev"},
        {"img_path": path, "instruction": "open", "gt_bbox": [0.5, 0.5, 0.7, 0.7], "group": "Dev"},
    ]
    log = str(tmp_path / "log.jsonl")
    model = tss.ScreenSpotModel(FakePipeline(), MockLLM(["Click BBox ID: 1", "Click BBox ID: 0"]))
    scores = tss.run_eval(model, data, log_path=log)
    assert scores["overall"] == 0.5
    lines = [json.loads(line) for line in open(log)]
    assert lines[0]["correctness"] == "correct" and lines[1]["correctness"] == "wrong"


# ------------------------- the renderer copies ------------------------- #


@pytest.mark.parametrize("seed", [0, 5, 777100])
def test_render_gui_scene_is_bit_equal(seed):
    got = tgui.render_gui_scene(np.random.default_rng(seed), size=640, return_kinds=True)
    want = jgui.render_gui_scene(np.random.default_rng(seed), size=640, return_kinds=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]  # icon boxes, text boxes, texts, kinds
    assert got[1] and got[2] and got[3]


def test_render_icon_tile_and_tables_match():
    from omniparser_tpu.train import train_captioner as jtc
    from omniparser_tpu_torch.train import train_captioner as ttc

    assert ttc.CAPTIONS == jtc.CAPTIONS and set(ttc.CAPTIONS) == set(tgui.ICON_KINDS)
    assert (tgui.ICON_KINDS, tgui.DATA_VERSION) == (jgui.ICON_KINDS, jgui.DATA_VERSION)
    for seed in (1, 2):
        got = tgui.render_icon_tile(np.random.default_rng(seed))
        want = jgui.render_icon_tile(np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_no_fonts_raises_at_the_first_render(monkeypatch):
    """Where no TTF face was found the modules import, and the first render
    raises naming the directories searched (the JAX package fails with an
    IndexError there)."""
    from omniparser_tpu_torch.train import synth_text

    monkeypatch.setattr(synth_text, "_FONT_FILES", [])
    with pytest.raises(RuntimeError, match="/usr/share/fonts"):
        tgui.render_gui_scene(np.random.default_rng(0), size=64)
    with pytest.raises(RuntimeError, match="no TTF font"):
        synth_text.render_line(np.random.default_rng(0))


# --------------------------- the carried faces --------------------------- #


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The export script's font copy in a temporary directory, and the set
    the renderers read from it where the globs find nothing and matplotlib
    is absent: (directory, files, bans)."""
    import glob

    from omniparser_tpu_torch.train import synth_text

    root = str(tmp_path_factory.mktemp("exported") / "fonts")
    synth_text.carry_fonts(root)
    mp = pytest.MonkeyPatch()
    mp.setattr(glob, "glob", lambda *a, **k: [])
    mp.setattr(synth_text, "matplotlib_font_dir", lambda: None)
    try:
        assert synth_text.glob_fonts() == []
        files, ban = synth_text._collect_fonts(root)
    finally:
        mp.undo()
    return root, files, ban


def _use_fonts(monkeypatch, files, ban):
    from omniparser_tpu_torch.train import synth_text

    monkeypatch.setattr(synth_text, "_FONT_FILES", files)
    monkeypatch.setattr(synth_text, "_FONT_BAN", ban)
    monkeypatch.setattr(tgui, "_FONT_FILES", files)


def test_carried_manifest_keeps_order_weights_bans_and_halves(carried):
    from omniparser_tpu_torch.train import synth_text

    root, files, ban = carried
    with open(f"{root}/fonts.json") as f:
        fonts = json.load(f)["fonts"]
    globbed = synth_text.glob_fonts()
    assert [e["order"] for e in fonts] == list(range(len(globbed)))
    assert [(e["weight"], frozenset(e["ban"]), e["half"]) for e in fonts] == \
        [(w, b, h) for _, w, b, h in globbed]
    assert [e["half"] for e in fonts[:6]] == ["system"] * 6  # pick_font's re-pick set
    names = [f.rsplit("/", 1)[-1] for f in files]
    assert names == [f.rsplit("/", 1)[-1] for f in synth_text._FONT_FILES]
    assert names.count("cmss10.ttf") == 4
    # the two halves hold faces of the same name, in their own directories
    assert len({f for f in files if f.endswith("/DejaVuSans-Bold.ttf")}) == 2
    assert sorted(p.rsplit("/", 1)[-1] for p in ban) == ["cmr10.ttf", "cmss10.ttf"]
    assert all(p.startswith(root) for p in ban)


@pytest.mark.parametrize("seed", [0, 5, 777100])
def test_carried_fonts_render_bit_equal(seed, carried, monkeypatch):
    """render_gui_scene and render_line (a text with banned characters
    among them) from the carried set, read with the globs finding nothing,
    equal the globbed set's renders."""
    from omniparser_tpu_torch.train import synth_text

    texts = (None, "a<b>{c}|d\\e", "Save As")
    want = [tgui.render_gui_scene(np.random.default_rng(seed), size=320, return_kinds=True)]
    want += [synth_text.render_line(np.random.default_rng(seed + i), t)
             for i, t in enumerate(texts)]
    _, files, ban = carried
    _use_fonts(monkeypatch, files, ban)
    got = [tgui.render_gui_scene(np.random.default_rng(seed), size=320, return_kinds=True)]
    got += [synth_text.render_line(np.random.default_rng(seed + i), t)
            for i, t in enumerate(texts)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


def test_carried_ban_repicks_the_same_face(carried, monkeypatch):
    """A text with a banned character re-picks among the six system faces
    from the carried set as from the globbed one."""
    from omniparser_tpu_torch.train import synth_text

    text = "C:\\Users\\{me}"
    name = lambda f: f.path.rsplit("/", 1)[-1]
    want = [name(synth_text.pick_font(np.random.default_rng(s), text, 14)) for s in range(64)]
    _, files, ban = carried
    _use_fonts(monkeypatch, files, ban)
    got = [synth_text.pick_font(np.random.default_rng(s), text, 14) for s in range(64)]
    assert [name(f) for f in got] == want
    assert "cmss10.ttf" not in want and len(set(want)) > 1
    # the first draw landed on a banned face for some seeds: the re-pick ran
    first = [files[int(np.random.default_rng(s).integers(0, len(files)))] for s in range(64)]
    assert any(f in ban for f in first)


def test_carried_italic_glyph_without_matplotlib(carried, monkeypatch):
    """With no oblique face in the set the italic glyph falls back to
    matplotlib's faces; where matplotlib is absent, to the carried half."""
    from PIL import Image, ImageDraw

    from omniparser_tpu_torch.train import synth_text

    root, files, _ = carried

    def glyph():
        img = Image.new("RGB", (40, 40), (255, 255, 255))
        tgui._draw_icon(ImageDraw.Draw(img), np.random.default_rng(3), 4, 4, 32, (0, 0, 0),
                        (255, 255, 255), kind="italic")
        return np.asarray(img), tgui._italic_font(30).path.rsplit("/", 2)[-2:]

    monkeypatch.setattr(tgui, "_FONT_FILES", list(synth_text._FONT_FILES[:6]))
    want, want_face = glyph()
    monkeypatch.setattr(tgui, "_FONT_FILES", files[:6])
    monkeypatch.setattr(tgui, "matplotlib_font_dir", lambda: None)
    monkeypatch.setattr(tgui, "CARRIED_FONT_DIR", root)
    got, got_face = glyph()
    assert got_face == ["matplotlib", want_face[1]] and "Italic" in want_face[1]
    np.testing.assert_array_equal(got, want)
    assert (want < 128).any()  # ink


def test_no_fonts_error_names_the_carried_manifest(monkeypatch):
    from omniparser_tpu_torch.train import synth_text

    monkeypatch.setattr(synth_text, "_FONT_FILES", [])
    with pytest.raises(RuntimeError) as err:
        synth_text.render_line(np.random.default_rng(0))
    msg = str(err.value)
    assert "no TTF font" in msg and "/usr/share/fonts" in msg
    assert synth_text.CARRIED_FONT_DIR in msg and "export_torch_weights.py" in msg


def test_make_dataset_rows_equal():
    got, want = tsb.make_dataset(2, seed=123), jsb.make_dataset(2, seed=123)
    assert len(got) == len(want) and {r["group"] for r in got} == {"text", "icon"}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.pop("img_path"), b.pop("img_path"))
        assert a == b


def test_scripted_grounder_matches_jax():
    lines = [
        '<p id=0 class="text" alt="Save As"> </p>',
        '<img id=1 class="icon" alt="settings icon"> </img>',
        '<p id=2 class="text" alt="Cancel"> </p>',
        '<img id=3 class="icon" alt="folder"> </img>',
    ]
    for instruction, want in (("click the text 'Cancel'", "Click BBox ID: 2"),
                              ("click the settings icon", "Click BBox ID: 1"),
                              ("click the folder icon", "Click BBox ID: 3"),
                              ("click the text 'Nonexistent zz'", "Click BBox ID: -")):
        prompt = tss.GROUNDING_PROMPT.format(instruction=instruction,
                                             screen_info="\n".join(lines))
        msgs = [{"role": "user", "content": [{"type": "text", "text": prompt}]}]
        got = tsb.ScriptedGrounder()(msgs)
        assert got == jsb.ScriptedGrounder()(msgs) and want in got[0]


# ------------------------------- the CLI ------------------------------- #


def test_cli_mock_on_a_two_row_dataset(tmp_path, monkeypatch, rng, capsys):
    """python -m omniparser_tpu_torch.eval --mock --device cpu: the rows are
    read, the pipeline is built on the CPU (here a reduced seeded one in
    place of PipelineConfig()'s full-width export), every row answered
    'Click BBox ID: 0' and logged."""
    import cv2

    from omniparser_tpu_torch import pipeline as tpipe
    from omniparser_tpu_torch.config import (CaptionerConfig, DetectorConfig, OcrConfig,
                                             PipelineConfig)
    from omniparser_tpu_torch.eval.__main__ import main

    small = PipelineConfig(detector=DetectorConfig(default_imgsz=128, dtype="float32",
                                                   box_threshold=0.02),
                           ocr=OcrConfig(backend="null"),
                           captioner=CaptionerConfig(backend="null"),
                           detector_weights=None, captioner_weights=None)
    built = []
    real = tpipe.SOMPipeline
    monkeypatch.setattr(tpipe, "SOMPipeline",
                        lambda cfg, device: built.append((cfg, device)) or real(small, device))
    path = str(tmp_path / "shot.png")
    cv2.imwrite(path, rng.integers(0, 255, (96, 112, 3), dtype=np.uint8))
    rows = [{"img_path": path, "instruction": "save", "gt_bbox": [0, 0, 1, 1], "group": "a"},
            {"img_path": path, "instruction": "open", "gt_bbox": [0, 0, 0.01, 0.01],
             "group": "b"}]
    with open(tmp_path / "data.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    out = str(tmp_path / "log.jsonl")
    main(["--dataset", str(tmp_path / "data.jsonl"), "--out", out, "--mock", "--device", "cpu"])
    assert [str(d) for _, d in built] == ["cpu"] and built[0][0] == PipelineConfig()
    scores = json.loads(capsys.readouterr().out)
    assert scores["n"] == 2 and scores["a"] == 1.0 and scores["b"] == 0.0
    logged = [json.loads(line) for line in open(out)]
    assert [r["correctness"] for r in logged] == ["correct", "wrong"]



def test_real_bench_reads_its_own_ground_truth(tmp_path):
    """The port's copy of eval/real_gt.json is the JAX package's; the rows
    are built from the images found (none in an empty directory), and a
    missing directory raises naming it."""
    import os

    from omniparser_tpu.eval import real_bench as jrb
    from omniparser_tpu_torch.eval import real_bench as trb

    with open(trb._GT) as f, open(jrb._GT) as g:
        assert json.load(f)["images"] == json.load(g)["images"]
    assert trb.IMGS == jrb._IMGS  # the same fixed directory as the JAX package
    assert trb.load_dataset(imgs_dir=str(tmp_path)) == []
    with pytest.raises(FileNotFoundError, match="nowhere"):
        trb.load_dataset(imgs_dir=os.path.join(str(tmp_path), "nowhere"))
