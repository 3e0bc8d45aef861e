"""``scripts/trained_on_card.py`` on the CPU: it refuses to run without the
export or the carried faces, and its comparisons and timers see what they
should.  The script itself runs on the card only."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import trained_on_card as toc  # noqa: E402


def _element(content, box=(0.1, 0.1, 0.2, 0.2), source="box_yolo_content_yolo"):
    return {"type": "icon", "bbox": list(box), "interactivity": True, "content": content,
            "source": source}


def test_raises_without_the_export_or_the_faces(tmp_path):
    """Only the carried faces are required: the trained weights are the
    committed trees, which the pipeline's 'auto' reads (and names where
    they are missing); an export's .npz files make no difference."""
    with pytest.raises(FileNotFoundError, match="scripts/export_torch_weights.py") as err:
        toc.require_inputs(str(tmp_path))
    assert "fonts.json" in str(err.value) and ".npz" not in str(err.value)
    for name in toc.EXPORTS:
        (tmp_path / name).write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="fonts.json") as err:
        toc.require_inputs(str(tmp_path))
    assert "det_synth" not in str(err.value)


def test_the_script_fails_without_a_card_or_the_inputs(tmp_path):
    """Run with no arguments beyond ``check`` on a host without a card: a
    non-zero exit, never a skip."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "trained_on_card.py"),
                          "check"], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "export_torch_weights.py" in out.stderr or "CUDA" in out.stderr, out.stderr[-2000:]


def test_parses_equal_sees_a_caption_a_box_and_a_count():
    a = [([_element("gear icon"), _element("File", source="box_ocr_content_ocr")],
          {"det_keep": 1, "kb": 8})]
    assert toc.parses_equal(a, a)[0]
    moved = [([_element("gear icon", (0.1, 0.1, 0.2, 0.2 + 2e-4)), a[0][0][1]], a[0][1])]
    ok, rows = toc.parses_equal(moved, a)
    assert not ok and "bbox" in rows[0]["first_difference"]
    assert toc.parses_equal([([_element("gear icon", (0.1, 0.1, 0.2, 0.2 + 5e-5)),
                               a[0][0][1]], a[0][1])], a)[0]
    ok, rows = toc.parses_equal([([_element("menu icon"), a[0][0][1]], a[0][1])], a)
    assert not ok and rows[0]["caption_flips"] == 1
    ok, rows = toc.parses_equal([(a[0][0], {"det_keep": 1, "kb": 16})], a)
    assert not ok and rows[0]["counts_differing"] == {"kb": [16, 8]}


def test_bench_rows_equal_and_row_flips():
    row = {"instruction": "click the settings icon", "correctness": "correct",
           "pred": [0.5, 0.5]}
    assert toc.bench_rows_equal([row], [row]) == ([], 0.0)
    near = dict(row, pred=[0.5, 0.5 + 5e-5])
    differ, far = toc.bench_rows_equal([near], [row])
    assert differ == [] and far == pytest.approx(5e-5)
    assert len(toc.bench_rows_equal([dict(row, pred=[0.5, 0.6])], [row])[0]) == 1
    assert len(toc.bench_rows_equal([dict(row, correctness="wrong")], [row])[0]) == 1
    assert len(toc.bench_rows_equal([dict(row, pred=None)], [row])[0]) == 1
    rows = [dict(row, correctness="correct" if c else "wrong")
            for c in toc.CPU_BF16_ROWS_777555]
    assert len(rows) == 39 and sum(toc.CPU_BF16_ROWS_777555) == 38
    assert toc.row_flips(rows, toc.CPU_BF16_ROWS_777555) == []
    rows[0] = dict(row, correctness="wrong")
    assert toc.row_flips(rows, toc.CPU_BF16_ROWS_777555) == [0]


def test_scene_hashes_are_this_machines():
    """The hashes written into the script are the renderers' here (the
    globbed faces); the card's run compares its own against them."""
    assert toc.scene_hashes() == toc.SCENE_HASHES


def test_scenes_dump_compares_equal_on_the_machine_that_wrote_it(tmp_path, monkeypatch):
    from omniparser_tpu_torch.train import synth_gui, synth_text

    monkeypatch.setattr(toc, "OUT_DIR", str(tmp_path))
    toc.scenes()
    font = synth_text._font
    got = toc.compare_scenes(str(tmp_path / "scenes_seed0.npz"))
    assert synth_text._font is synth_gui._font is font  # the basic layout is undone
    assert got["default"]["gui"] == {"pixels_differing": 0, "pixels": 640 * 640, "max_abs": 0,
                                     "boxes_and_texts_equal": True}
    assert got["default"]["shot"]["pixels_differing"] == 0
    assert set(got["basic"]) == {"gui", "shot"}


def test_phases_time_render_and_train_apart_and_keep_the_losses():
    class Trainer:
        """A stand-in trainer module: main -> train (render inside, steps)
        -> evaluate (render inside)."""

        @staticmethod
        def build(n):
            return np.zeros(n)

        @staticmethod
        def step(i):
            return torch.tensor(10.0 - i)

        @staticmethod
        def train(steps):
            Trainer.build(4)
            return [Trainer.step(i) for i in range(steps)]

        @staticmethod
        def evaluate():
            Trainer.build(2)
            return {"exact_match": 1.0}

    roles = {"build": "render", "train": "train", "evaluate": "evaluate", "step": "step"}
    with toc.Phases(Trainer, roles, "cpu") as ph:
        Trainer.train(250)
        Trainer.evaluate()
    assert Trainer.train.__name__ == "train"  # unwrapped again
    tr, ev = ph.summary(chunk=100)
    assert tr["function"] == "train" and tr["steps"] == 250
    assert tr["loss_first"] == 10.0 and tr["loss_last"] == 10.0 - 249
    assert tr["loss_curve"] == [10.0 - 49.5, 10.0 - 149.5, 10.0 - 224.5]
    assert 0 <= tr["render_seconds"] <= tr["seconds"]
    assert tr["train_seconds"] == pytest.approx(tr["seconds"] - tr["render_seconds"], abs=0.02)
    assert ev["report"] == {"exact_match": 1.0} and "steps" not in ev
