"""The port stands on torch, numpy and the standard library alone: importing
every module of it pulls in nothing of JAX, nothing of the JAX package and
none of the optional host libraries."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "orbax", "omniparser_tpu", "cv2", "PIL", "regex")


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


def test_the_family_modules_are_walked_and_import_none_of_jax():
    """Every module of the YOLOv9, easyocr and BLIP-2 families is among the
    modules the subprocess check above imports, and names none of the
    forbidden packages in an import statement."""
    names = set(_port_modules())
    for rel in FAMILY_MODULES:
        assert "omniparser_tpu_torch." + rel[:-3].replace("/", ".") in names
        roots = _imported_roots(os.path.join(ROOT, "omniparser_tpu_torch", rel))
        assert not roots & set(FORBIDDEN) - {"PIL"}, (rel, roots & set(FORBIDDEN))


@pytest.mark.parametrize("rel", ["annotate.py", "utils/image.py", "models/tokenizer.py",
                                 "pipeline.py", "serving/http.py", "serving/batcher.py",
                                 "utils/metrics.py", "models/quant.py", *FAMILY_MODULES])
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
    with pytest.raises(NotImplementedError, match="A.10"):
        main(["--mesh", "4,2"])


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


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
