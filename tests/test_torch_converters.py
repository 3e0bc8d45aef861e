"""Upstream checkpoints into the port, against the JAX package's loaders,
on the CPU in float32:

  * an ultralytics YOLOv8 ``.pt`` (a plain state_dict, and a whole bundle
    that pickles classes which cannot be imported) through
    ``weights/convert_yolo.py``, against JAX ``load_detector_params``, as
    detector outputs on one image;
  * an HF Florence-2 ``model.safetensors`` made from tiny genuine
    ``transformers`` halves (the DaViT tower and the BART model), read by
    the port's own reader (``weights/safetensors.py``) array for array and
    converted by ``weights/convert_florence.py``, against JAX
    ``convert_florence_state_dict``, as Florence logits;
  * ``Omniparser`` with the reference's config dict (an ultralytics .pt and
    an HF directory) without transformers, safetensors or ultralytics at
    run time, and the refusal of an orbax directory.
"""

import json
import os
import pickle
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu.weights.convert_florence import convert_florence_state_dict as j_convert_flo
from omniparser_tpu.weights.convert_yolo import load_detector_params
from omniparser_tpu_torch import config as tcfg
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models import yolov8 as tyolo
from omniparser_tpu_torch.ocr import NullOCR
from omniparser_tpu_torch.pipeline import Omniparser, SOMPipeline
from omniparser_tpu_torch.weights import convert_florence, convert_yolo
from omniparser_tpu_torch.weights.init import build_module
from omniparser_tpu_torch.weights.safetensors import read_safetensors
from tests.test_converters import _synthesize_ultralytics_sd

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)


class F32Detector(jyolo.Detector):
    """The JAX detector with a float32 module (its own builds bfloat16)."""

    @property
    def module(self):
        return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                            dtype=jnp.float32)


def _seeded_tree(shapes, rng):
    """Values for an abstract variable tree: kernels normal with std
    sqrt(2 / fan_in), BatchNorm statistics and affine terms uniform around
    their identity, so that a swapped or dropped tensor shows."""
    def visit(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = visit(v, path + (k,))
            elif k == "kernel":
                std = np.sqrt(2.0 / np.prod(v.shape[:-1]))
                out[k] = rng.normal(0, std, v.shape).astype(np.float32)
            else:
                lo, hi = (0.5, 1.5) if k in ("var", "scale") else (-0.3, 0.3)
                out[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)
        return out

    return visit(shapes, ())


def _save_bundle(sd, path):
    """torch.save an ultralytics-like bundle: {'model': DetectionModel} whose
    module classes live in a module that is gone when the file is read."""
    name = "_gone_ultralytics_nn_tasks"
    mod = types.ModuleType(name)

    class DetectionModel(torch.nn.Module):
        pass

    class Layer(torch.nn.Module):
        pass

    for cls in (DetectionModel, Layer):
        cls.__module__, cls.__qualname__ = name, cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules[name] = mod
    try:
        root = DetectionModel()
        for key, value in sd.items():
            *parts, leaf = key.split(".")
            node = root
            for part in parts:
                if part not in node._modules:
                    node.add_module(part, Layer())
                node = node._modules[part]
            t = torch.from_numpy(np.asarray(value)).half()  # ultralytics saves half
            if leaf.startswith("running_"):
                node.register_buffer(leaf, t)
            else:
                node.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
        torch.save({"epoch": -1, "model": root, "train_args": {"imgsz": 1280}}, path)
    finally:
        del sys.modules[name]


@pytest.fixture(scope="module")
def yolo_files(tmp_path_factory):
    """The same seeded YOLOv8-n weights as a plain state_dict file and as a
    bundle; the bundle's values are float16, so the plain file holds them
    rounded the same way."""
    shapes = jax.eval_shape(lambda: jyolo.Detector(imgsz=64).init_params(jax.random.PRNGKey(1)))
    variables = _seeded_tree(shapes, np.random.default_rng(5))
    sd = {k: np.asarray(v, np.float16).astype(np.float32)
          for k, v in _synthesize_ultralytics_sd(variables).items()}
    d = tmp_path_factory.mktemp("yolo")
    plain, bundle = str(d / "state_dict.pt"), str(d / "model.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, plain)
    _save_bundle(sd, bundle)
    return {"plain": plain, "bundle": bundle}, sd


@pytest.mark.parametrize("kind", ["plain", "bundle"])
def test_ultralytics_checkpoint_matches_jax(yolo_files, kind, rng):
    files, sd = yolo_files
    path = files[kind]
    if kind == "bundle":  # a weights-only load refuses the bundle's classes
        with pytest.raises(pickle.UnpicklingError):
            torch.load(path, weights_only=True)
    jdet = F32Detector(imgsz=128, max_det=16)
    params = load_detector_params(path, jdet)
    tdet = tyolo.Detector(imgsz=128, max_det=16)
    state = convert_yolo.load_detector_state(path, tdet)
    assert np.array_equal(state["stem.conv.weight"].numpy(), sd["model.0.conv.weight"])
    module = build_module(tdet.make_module(), state, None, torch.float32, "cpu")
    img = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8)
    wb, ws, wv = (np.asarray(x) for x in jdet.detect(
        params, jnp.asarray(img), jnp.asarray([96, 128], jnp.int32), 0.05, 0.3))
    gb, gs, gv = (x.numpy() for x in tdet.detect_graph(
        module, torch.from_numpy(img), (96, 128), 0.05, 0.3))
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() >= 2
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-5)


def test_ultralytics_missing_layer_or_wrong_variant_raises(yolo_files, tmp_path):
    files, sd = yolo_files
    cut = str(tmp_path / "cut.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()
                if not k.startswith("model.9.")}, cut)  # no SPPF
    with pytest.raises(KeyError, match="model.9"):
        convert_yolo.load_detector_state(cut, tyolo.Detector())
    with pytest.raises(ValueError, match="shape"):
        convert_yolo.load_detector_state(files["plain"], tyolo.Detector(variant="s"))


# ------------------------------ Florence-2 ------------------------------ #

TINY = dict(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
            depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=2,
            decoder_layers=2, attn_heads=4, ffn_dim=64, vocab_size=160, max_positions=64)


def _hf_florence_sd(dims, rng):
    """A Florence-2 state dict in the HF checkpoint's spelling: the tower
    and the BART model from genuine (tiny) transformers modules, the
    projection head around them seeded by shape."""
    from transformers import BartConfig, BartForConditionalGeneration
    from transformers.models.florence2.modeling_florence2 import (
        Florence2VisionBackbone, Florence2VisionConfig)

    torch.manual_seed(0)
    tower = Florence2VisionBackbone(Florence2VisionConfig(
        depths=list(dims.depths), embed_dim=list(dims.embed_dims),
        num_heads=list(dims.num_heads), num_groups=list(dims.num_groups),
        patch_size=list(dims.patch_size), patch_stride=list(dims.patch_stride),
        patch_padding=list(dims.patch_padding), window_size=dims.window_size,
        mlp_ratio=dims.mlp_ratio, projection_dim=dims.d_model))
    bart = BartForConditionalGeneration(BartConfig(
        d_model=dims.d_model, encoder_layers=dims.encoder_layers,
        decoder_layers=dims.decoder_layers, encoder_ffn_dim=dims.ffn_dim,
        decoder_ffn_dim=dims.ffn_dim, encoder_attention_heads=dims.attn_heads,
        decoder_attention_heads=dims.attn_heads, vocab_size=dims.vocab_size,
        max_position_embeddings=dims.max_positions))
    with torch.no_grad():  # decided logits: a wide table and a non-zero bias
        bart.model.shared.weight.normal_(0, 1.0)
        bart.final_logits_bias.normal_(0, 1.0)
    sd = {"vision_tower." + k: v.detach().numpy().copy()
          for k, v in tower.state_dict().items()}
    sd.update({"language_model." + k: v.detach().numpy().copy()
               for k, v in bart.state_dict().items()})
    e, d = dims.embed_dims[-1], dims.d_model
    sd["image_projection"] = rng.normal(0, 0.2, (e, d)).astype(np.float32)
    sd["image_proj_norm.weight"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
    sd["image_proj_norm.bias"] = rng.normal(0, 0.1, d).astype(np.float32)
    for axis in ("row", "column"):
        sd[f"image_pos_embed.{axis}_embeddings.weight"] = rng.normal(
            0, 0.02, (dims.pos_embed_grid, e)).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from safetensors.numpy import save_file

    dims = jflo.FlorenceDims(**TINY)
    sd = _hf_florence_sd(dims, np.random.default_rng(3))
    d = tmp_path_factory.mktemp("florence")
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({"model_type": "florence2"}))
    return str(d), sd


def test_hf_florence_checkpoint_matches_jax(hf_dir, rng):
    path, sd = hf_dir
    got = read_safetensors(os.path.join(path, "model.safetensors"))
    assert set(got) == set(sd)
    for k in sd:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], sd[k]), k

    td, jd = tflo.FlorenceDims(**TINY), jflo.FlorenceDims(**TINY)
    state, dims, tok_dir = convert_florence.load_florence_state(path, td)
    assert dims == td and tok_dir == path
    # the tied head and the logits bias survive both hops
    lm = "language_model.model."
    np.testing.assert_array_equal(state["language_model.shared.weight"].numpy(),
                                  sd[lm + "shared.weight"])
    np.testing.assert_array_equal(state["language_model.shared.weight"].numpy(),
                                  sd["language_model.lm_head.weight"])
    np.testing.assert_array_equal(state["language_model.final_logits_bias"].numpy(),
                                  sd["language_model.final_logits_bias"].reshape(-1))
    variables, unmatched = j_convert_flo(sd, jd)
    assert unmatched == []
    model = jflo.Florence2(dims=jd, dtype=jnp.float32)
    px = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    prompt = np.array([[0, 17, 23, 2], [0, 5, 2, 1]], np.int32)
    dec = np.array([[2, 11, 12], [2, 40, 7]], np.int32)
    want = np.asarray(jax.jit(model.apply)(variables, px, prompt, dec))
    net = build_module(tflo.Florence2(td), state, None, torch.float32, "cpu")
    with torch.no_grad():
        out = net(torch.from_numpy(px), torch.from_numpy(prompt).long(),
                  torch.from_numpy(dec).long()).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-4)
    # a checkpoint that kept only an alias of the tied table
    alias = {k: v for k, v in sd.items() if k != lm + "shared.weight"}
    flat, _ = convert_florence.convert_florence_state_dict(alias, td)
    np.testing.assert_array_equal(flat["params"]["language_model"]["shared"]["embedding"],
                                  sd[lm + "shared.weight"])


def test_safetensors_reader_dtypes(tmp_path):
    from safetensors.torch import save_file

    t = {"h": torch.randn(3, 4).half(), "b": torch.randn(5).bfloat16(), "f": torch.randn(2)}
    save_file(t, str(tmp_path / "x.safetensors"))
    got = read_safetensors(str(tmp_path / "x.safetensors"))
    assert got["h"].dtype == np.float16 and got["b"].dtype == np.float32
    for k, v in t.items():
        np.testing.assert_array_equal(got[k].astype(np.float32), v.float().numpy())
    save_file({"i": torch.arange(3)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        read_safetensors(str(tmp_path / "i.safetensors"))


def test_omniparser_config_dict_loads_upstream_checkpoints(yolo_files, hf_dir, rng,
                                                           monkeypatch):
    """The reference's config dict with an ultralytics .pt and an HF
    Florence-2 directory builds and parses, with transformers, safetensors
    and ultralytics unimportable."""
    from omniparser_tpu_torch.utils.image import decode_base64_image, encode_image_base64

    for name in ("transformers", "safetensors", "ultralytics"):
        monkeypatch.setitem(sys.modules, name, None)
    files, _ = yolo_files
    path, _ = hf_dir
    parser = Omniparser({"som_model_path": files["bundle"], "caption_model_path": path,
                         "BOX_TRESHOLD": 0.05}, device="cpu", ocr=NullOCR(),
                        captioner_dims=tflo.FlorenceDims(**TINY))
    pipe = parser.pipeline
    want = convert_yolo.load_detector_state(files["plain"], pipe.detector)
    for k, v in pipe.det_module.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.float().numpy(),
                                          want[k].to(v.dtype).float().numpy(), err_msg=k)
    state, _, _ = convert_florence.load_florence_state(path, tflo.FlorenceDims(**TINY))
    got = pipe.captioner.model.state_dict()
    assert set(got) == set(state)
    assert got["language_model.shared.weight"].dtype == torch.float32
    np.testing.assert_array_equal(got["language_model.shared.weight"].numpy(),
                                  state["language_model.shared.weight"].numpy())
    img = rng.integers(0, 255, (96, 160, 3), dtype=np.uint8)
    som, elements = parser.parse(encode_image_base64(img))
    assert decode_base64_image(som).shape == img.shape
    assert elements and all(e["type"] == "icon" and isinstance(e["content"], str)
                            for e in elements)


@pytest.mark.parametrize("field,checkpoint", [
    ("detector_weights", "det_synth"), ("ocr_weights", "ocr_en_synth"),
    ("captioner_weights", "cap_synth")])
def test_orbax_directory_raises(field, checkpoint):
    """The JAX package's own checkpoints are orbax trees, which the port
    once refused; it now reads them without JAX (weights/orbax_read.py):
    the directory given as a weight field loads, and each network's state
    equals the conversion of the JAX package's load_checkpoint of it."""
    import dataclasses

    import omniparser_tpu.weights as jweights
    from omniparser_tpu.weights.checkpoints import load_checkpoint
    from omniparser_tpu_torch.weights import convert
    from omniparser_tpu_torch.weights.convert import flatten_variables

    path = os.path.join(os.path.dirname(jweights.__file__), checkpoint)
    assert os.path.isdir(path)
    cfg = tcfg.PipelineConfig(detector_weights=None, ocr_weights=None, captioner_weights=None,
                              detector=tcfg.DetectorConfig(dtype="float32"),
                              ocr=tcfg.OcrConfig(dtype="float32"),
                              captioner=tcfg.CaptionerConfig(dtype="float32"))
    cfg = dataclasses.replace(cfg, **{field: path})
    pipe = SOMPipeline(cfg, device="cpu", captioner_dims=tflo.FlorenceDims(**TINY))
    jax_tree = load_checkpoint(path)
    if checkpoint == "det_synth":
        pairs = [(pipe.det_module, convert.convert_yolov8(flatten_variables(jax_tree["det"])))]
    elif checkpoint == "ocr_en_synth":
        pairs = [(pipe.ocr.det, convert.convert_text_detector(flatten_variables(jax_tree["det"]))),
                 (pipe.ocr.rec,
                  convert.convert_text_recognizer(flatten_variables(jax_tree["rec"])))]
    else:
        with open(os.path.join(path, "dims.json")) as f:
            raw = json.load(f)
        dims = pipe.captioner.dims
        assert dims.d_model == raw["d_model"] and list(dims.patch_prenorm) == raw["patch_prenorm"]
        pairs = [(pipe.captioner.model,
                  convert.convert_florence2(flatten_variables(jax_tree["cap"]), dims))]
    for module, want in pairs:
        got = module.state_dict()
        assert sorted(k for k in got if not k.endswith("num_batches_tracked")) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_chip_smoke_writes_upstream_checkpoints_the_loaders_read(tmp_path):
    """The card check writes its seeded networks in the upstream formats
    (an ultralytics state_dict, an HF Florence-2 directory) and loads them
    back through the config dict: the writers are the loaders' inverse."""
    import chip_smoke

    gen = torch.Generator().manual_seed(3)
    det = tyolo.Detector()
    det_module = build_module(det.make_module(), None, gen, torch.float32, "cpu")
    dims = tflo.FlorenceDims(**TINY)
    florence = build_module(tflo.Florence2(dims), None, gen, torch.float32, "cpu")
    pt, hf, nbytes = chip_smoke.write_upstream_checkpoints(str(tmp_path), det_module, florence)
    assert nbytes > 0 and os.path.isfile(os.path.join(hf, "config.json"))
    want = {k: v for k, v in det_module.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert chip_smoke.state_mismatches(convert_yolo.load_detector_state(pt, det), want) == []
    state, _, _ = convert_florence.load_florence_state(hf, dims)
    assert chip_smoke.state_mismatches(state, florence.state_dict()) == []
