"""The port stands on torch, numpy and the standard library alone: importing
every module of it pulls in nothing of JAX, nothing of the JAX package and
none of the optional host libraries."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "orbax", "tensorstore", "omniparser_tpu", "cv2", "PIL", "regex")


def _port_modules():
    pkg_dir = os.path.join(ROOT, "omniparser_tpu_torch")
    names = ["omniparser_tpu_torch"]
    for m in pkgutil.walk_packages([pkg_dir], prefix="omniparser_tpu_torch."):
        names.append(m.name)
    return names


def test_importing_every_module_leaves_forbidden_packages_out():
    names = _port_modules()
    assert len(names) >= 20
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_none_of_them():
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert "omniparser_tpu_torch" in roots and "torch" in roots
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


# the model families of the sixth slice
FAMILY_MODULES = ("models/yolov9.py", "weights/convert_yolov9.py", "models/ocr_easy.py",
                  "weights/convert_ocr.py", "models/generate.py", "models/blip2.py",
                  "weights/convert_blip2.py")
# the seventh slice: Phi-3-V, the renderer copies and the eval harnesses
SLICE7_MODULES = ("models/phi3v.py", "weights/convert_phi3v.py", "train/synth_text.py",
                  "train/synth_gui.py", "train/train_captioner.py", "eval/llm.py",
                  "eval/screenspot.py", "eval/synth_bench.py", "eval/real_bench.py",
                  "eval/__main__.py")
# the eighth slice: training (the trainers, their losses and optimiser, the
# checkpoints, the flax-equal BatchNorm)
SLICE8_MODULES = ("train/__init__.py", "train/losses.py", "train/ocr_losses.py",
                  "train/optim.py", "train/train_step.py", "train/train_detector.py",
                  "train/train_ocr.py", "train/train_captioner.py", "train/trajectory_data.py",
                  "weights/checkpoints.py", "weights/convert.py", "weights/init.py",
                  "models/norm.py", "train/data.py")

# the tenth slice: the ops names, the OCR host postprocess, the carried faces
SLICE10_MODULES = ("ops/__init__.py", "ops/boxes.py", "ops/preprocess.py", "models/ocr.py",
                   "train/train_ocr.py", "utils/hostops.py", "train/synth_text.py",
                   "train/synth_gui.py")
SLICE10_SCRIPTS = ("scripts/trained_on_card.py", "scripts/export_torch_weights.py")


def test_the_family_modules_are_walked_and_import_none_of_jax():
    """Every module of the YOLOv9, easyocr, BLIP-2 and Phi-3-V families and
    of the eval harnesses is among the modules the subprocess check above
    imports, and names none of the forbidden packages in an import
    statement."""
    names = set(_port_modules())
    host = {"PIL", "cv2", "regex"}  # the renderers draw with PIL and blur with cv2
    for rel in FAMILY_MODULES + SLICE7_MODULES + SLICE8_MODULES:
        name = "omniparser_tpu_torch." + rel[:-3].replace("/", ".")
        assert name.removesuffix(".__init__") in names
        roots = _imported_roots(os.path.join(ROOT, "omniparser_tpu_torch", rel))
        allowed = {"PIL"} if rel in FAMILY_MODULES else host
        assert not roots & set(FORBIDDEN) - allowed, (rel, roots & set(FORBIDDEN))


def test_the_tenth_slice_modules_and_script_import_none_of_jax():
    """The changed modules are walked by the subprocess check above and
    name none of the forbidden packages in an import statement; the
    trained-path script imports none of JAX or the JAX package, in its
    statements or once it runs (the export script reads the JAX package
    inside its main alone)."""
    names = set(_port_modules())
    for rel in SLICE10_MODULES:
        name = "omniparser_tpu_torch." + rel[:-3].replace("/", ".")
        assert name.removesuffix(".__init__") in names
        roots = _imported_roots(os.path.join(ROOT, "omniparser_tpu_torch", rel))
        assert not roots & set(FORBIDDEN) - {"PIL", "cv2"}, (rel, roots & set(FORBIDDEN))
    roots = _imported_roots(os.path.join(ROOT, SLICE10_SCRIPTS[0]))
    assert "omniparser_tpu_torch" in roots and not roots & {"jax", "flax", "orbax",
                                                            "omniparser_tpu"}
    code = (
        "import sys\n"
        "sys.path.insert(0, 'scripts')\n"
        "import trained_on_card, chip_smoke\n"
        "from omniparser_tpu_torch.train import train_detector, train_ocr, train_captioner\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'omniparser_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    with open(os.path.join(ROOT, SLICE10_SCRIPTS[1])) as f:
        tree = ast.parse(f.read())
    top = {n.module.split(".")[0] for n in tree.body if isinstance(n, ast.ImportFrom)}
    top |= {a.name.split(".")[0] for n in tree.body if isinstance(n, ast.Import)
            for a in n.names}
    assert not top & {"jax", "omniparser_tpu"}


@pytest.mark.parametrize("rel", ["annotate.py", "utils/image.py", "models/tokenizer.py",
                                 "pipeline.py", "serving/http.py", "serving/batcher.py",
                                 "utils/metrics.py", "models/quant.py", *FAMILY_MODULES,
                                 *SLICE7_MODULES, *SLICE8_MODULES,
                                 *sorted(set(SLICE10_MODULES) - set(SLICE7_MODULES)
                                         - set(SLICE8_MODULES))])
def test_optional_host_libraries_are_imported_inside_functions(rel):
    """cv2, PIL and regex may appear only inside function bodies."""
    with open(os.path.join(ROOT, "omniparser_tpu_torch", rel)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:  # module level only
        if isinstance(node, ast.Import):
            assert not {a.name.split(".")[0] for a in node.names} & {"cv2", "PIL", "regex"}
        if isinstance(node, ast.ImportFrom):
            assert (node.module or "").split(".")[0] not in ("cv2", "PIL", "regex")


def test_entry_points_default_to_the_card_and_raise_without_one():
    import torch

    from omniparser_tpu_torch.config import CaptionerConfig, OcrConfig, PipelineConfig
    from omniparser_tpu_torch.pipeline import Omniparser, SOMPipeline

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    cfg = PipelineConfig(captioner=CaptionerConfig(backend="null"), ocr=OcrConfig(backend="null"),
                         detector_weights=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SOMPipeline(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Omniparser(cfg)

    from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner, FlorenceDims
    from omniparser_tpu_torch.models.ocr import TorchOCR
    from omniparser_tpu_torch.serving import OmniparserServer, main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlorenceCaptioner(CaptionerConfig(), FlorenceDims(d_model=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOCR(OcrConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OmniparserServer(cfg)  # no pipeline given: it builds one, on the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--port", "0"])  # --device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mesh", "4,2"])  # the mesh's devices default to every visible card


def test_family_entry_points_default_to_the_card_and_raise_without_one():
    import torch

    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.config import CaptionerConfig, OcrConfig
    from omniparser_tpu_torch.models.blip2 import TINY_BLIP2, Blip2Captioner
    from omniparser_tpu_torch.models.ocr import TorchOCR

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.get_yolo_model(variant="v9test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOCR(OcrConfig(arch="easyocr", rec_height=64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Blip2Captioner(CaptionerConfig(backend="blip2"), TINY_BLIP2)


def test_training_entry_points_default_to_the_card_and_raise_without_one():
    import torch

    from omniparser_tpu_torch.train import train_captioner, train_detector, train_ocr
    from omniparser_tpu_torch.train.synth_text import crops_from_buffers
    from omniparser_tpu_torch.train.train_step import make_train_state

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    data = np.zeros((1, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_state(imgsz=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_detector.train_detector(1, 1, 0, 1, data=(data, None, None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ocr.train_recognizer(1, 1, data=(data, None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ocr.train_detector(1, 1, data=(data, None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_captioner.train_captioner(1, 1, data=(data, None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        crops_from_buffers(data, np.asarray([[8, 8]]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_captioner.crop_tiles(data, np.asarray([[0.0, 0.0, 1.0, 1.0]]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_detector.main(["--steps", "1", "--data", "1"])  # --device defaults to cuda


def test_phi3v_and_eval_entry_points_default_to_the_card_and_raise_without_one(tmp_path):
    import torch

    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.config import CaptionerConfig
    from omniparser_tpu_torch.eval import real_bench, synth_bench
    from omniparser_tpu_torch.eval.__main__ import main
    from omniparser_tpu_torch.models.phi3v import TINY_PHI3V, Phi3VCaptioner

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Phi3VCaptioner(CaptionerConfig(backend="phi3v"), TINY_PHI3V)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.get_caption_model_processor("phi3_v")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth_bench.run(n_scenes=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        real_bench.run(imgs_dir=str(tmp_path))  # an empty directory: no rows
    with pytest.raises(FileNotFoundError, match="no_such_dir"):
        real_bench.run(imgs_dir=str(tmp_path / "no_such_dir"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "/dev/null", "--mock"])  # --device defaults to cuda


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# the twelfth slice: the orbax reader and its zstd decoder, and the modules
# whose 'auto' weights now read the committed trees through them
SLICE12_MODULES = ("weights/orbax_read.py", "utils/zstd.py", "weights/checkpoints.py",
                   "pipeline.py", "ocr.py")


@pytest.mark.parametrize("rel", SLICE12_MODULES)
def test_the_checkpoint_reader_imports_none_of_jax_orbax_or_tensorstore(rel):
    """Walked by the subprocess check above, named in no import statement,
    and reading the three committed trees pulls none of them in (nor any
    zstd module: the decoder is the port's own C++)."""
    name = "omniparser_tpu_torch." + rel[:-3].replace("/", ".")
    assert name in set(_port_modules())
    roots = _imported_roots(os.path.join(ROOT, "omniparser_tpu_torch", rel))
    # cv2 and PIL may be imported inside functions (checked below)
    assert not roots & (set(FORBIDDEN) - {"cv2", "PIL"} | {"zstandard", "compression"}), roots
    if rel != "weights/orbax_read.py":
        return
    code = (
        "import sys\n"
        "from omniparser_tpu_torch.weights.orbax_read import read_orbax_tree\n"
        "for t in ('det_synth', 'ocr_en_synth', 'cap_synth'):\n"
        "    read_orbax_tree('omniparser_tpu/weights/' + t)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('zstandard', 'compression')!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


# the eleventh slice: the port's benchmark and demo
MEASUREMENT_SCRIPTS = ("bench_torch.py", "examples/demo_torch.py")


@pytest.mark.parametrize("rel", MEASUREMENT_SCRIPTS)
def test_the_benchmark_and_demo_import_none_of_jax(rel):
    """The benchmark and the demo name none of JAX or the JAX package in an
    import statement, nor the JAX package's benchmark or chip_smoke, and
    importing them (with the modules their main functions import) pulls in
    none of it."""
    roots = _imported_roots(os.path.join(ROOT, rel))
    assert "omniparser_tpu_torch" in roots
    assert not roots & {"jax", "flax", "orbax", "omniparser_tpu", "bench", "chip_smoke"}, roots
    name = os.path.basename(rel)[:-3]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.join(ROOT, rel))!r})\n"
        f"import {name}\n"
        "from omniparser_tpu_torch import pipeline, ops\n"
        "from omniparser_tpu_torch.train import synth_gui\n"
        "from omniparser_tpu_torch.utils import image\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'omniparser_tpu', 'bench', 'chip_smoke'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
