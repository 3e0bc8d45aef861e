"""The port's Phi-3-V captioner (``models/phi3v.py``,
``weights/convert_phi3v.py``) and its routes, against the JAX package's, on
the CPU in float32 at TINY_PHI3V, with the same numpy-seeded inputs and
weights (carried through ``weights/convert.py``).  Token ids, texts and
element lists are exact; logits and image embeddings agree to 1e-4 of
their largest magnitude, boxes to 1e-4."""

import dataclasses
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.config import CaptionerConfig as JCap
from omniparser_tpu.models import phi3v as jp
from omniparser_tpu_torch.config import CaptionerConfig
from omniparser_tpu_torch.models import phi3v as tp
from omniparser_tpu_torch.weights import convert

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

JDIMS = jp.TINY_PHI3V
TDIMS = tp.TINY_PHI3V
ATOL = 1e-4  # of the largest magnitude, float32 on both sides


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=ATOL * np.abs(want).max())


def _tree(rng, dims=JDIMS):
    from tests.test_torch_yolov9 import seeded_tree

    model = jp.Phi3V(dims=dims, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, dims.image_size, dims.image_size, 3)),
        jnp.zeros((3,), jnp.int32), jnp.zeros((2,), jnp.int32), None,
        method=jp.Phi3V.forward_prompt))
    return model, seeded_tree(shapes, rng)


def _port(tree, dims=TDIMS):
    state = convert.convert_phi3v(convert.flatten_variables(tree), dims)
    return state, tp.build_phi3v(dims, state, torch.float32, "cpu")


@pytest.fixture(scope="module")
def phi():
    model, tree = _tree(np.random.default_rng(7))
    state, tm = _port(tree)
    return model, tree, state, tm


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((b, 28, 28, 3)).astype(np.float32)
    return px, np.array([70, 38, 31], np.int32), np.array([20, 14, 15, 42], np.int32)


def _t(px, pre, suf):
    return (torch.from_numpy(px).permute(0, 3, 1, 2), torch.from_numpy(pre).long(),
            torch.from_numpy(suf).long())


def test_image_embeds_and_prompt_logits_match_jax(phi):
    """image_embeds; forward_prompt's logits over the prompt alone and into
    a longer cache; two decode steps after it."""
    model, tree, _, tm = phi
    px, pre, suf = _inputs(1)
    with torch.no_grad():
        _close(tm.image_embeds(_t(px, pre, suf)[0]).numpy(),
               model.apply(tree, jnp.asarray(px), method=jp.Phi3V.image_embeds))
        for extra in (0, 5):
            p = len(pre) + len(suf) + 1  # TINY: one 2x2 group of a 2x2 patch grid
            jl, (jc, jlen) = model.apply(tree, jnp.asarray(px), jnp.asarray(pre),
                                         jnp.asarray(suf), p + extra if extra else None,
                                         method=jp.Phi3V.forward_prompt)
            tl, (tc, tlen) = tm.forward_prompt(*_t(px, pre, suf), extra)
            assert tlen == jlen == p and tc[0][0].shape[2] == p + extra
            _close(tl.numpy(), jl)
        for s, tok in enumerate((7, 8)):
            jl, jc = model.apply(tree, jnp.asarray([tok, tok], jnp.int32), jnp.asarray(jlen + s),
                                 jlen, jc,
                                 method=jp.Phi3V.decode_one)
            _close(tm.decode_one(torch.tensor([tok, tok]), tlen + s, tc).numpy(), jl)


def _generate_both(model, tree, tm, px, pre, suf, n, jdims=JDIMS, tdims=TDIMS):
    jm = jp.Phi3V(dims=jdims, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, x: jp.phi3v_generate(
        jm, v, x, pre, suf, max_new_tokens=n))(tree, jnp.asarray(px)))
    tm.dims = tdims
    try:
        got = tp.phi3v_generate(tm, *_t(px, pre, suf), n).numpy()
    finally:
        tm.dims = TDIMS
    return got, want


def test_generate_matches_jax_and_stops_at_eos(phi):
    """Greedy tokens equal; then with eos set to row 1's first token and
    <|end|> to a later token of row 0, both stop and pad the same way."""
    model, tree, _, tm = phi
    px, pre, suf = _inputs(2, b=3)
    got, want = _generate_both(model, tree, tm, px, pre, suf, 8)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    eos, end = int(got[1, 0]), int(got[0, 3])
    assert len({eos, end, JDIMS.pad_token_id}) == 3, "pick other rows for the stop tokens"
    got2, want2 = _generate_both(
        model, tree, tm, px, pre, suf, 8,
        dataclasses.replace(JDIMS, eos_token_id=eos, end_token_id=end),
        dataclasses.replace(TDIMS, eos_token_id=eos, end_token_id=end))
    np.testing.assert_array_equal(got2, want2)
    pad = JDIMS.pad_token_id
    # row 1 stops at its first token, row 0 at its fourth or before
    assert (got2[1, 1:] == pad).all() and (got2[0, 4:] == pad).all()
    for row in got2:  # every token after a stop is pad
        stops = np.flatnonzero((row == eos) | (row == end))
        if stops.size:
            assert (row[stops[0] + 1:] == pad).all()


def test_argmax_takes_the_first_of_tied_maxima(phi):
    """A zero LM head ties every logit: the port's greedy tokens and the JAX
    package's are both token 0 (torch.argmax and jnp.argmax take the first
    of equal maxima); and on a tied row of its own."""
    model, tree, _, _ = phi
    tied = jax.tree_util.tree_map(np.copy, tree)
    tied["params"]["lm_head"]["kernel"][:] = 0.0
    _, tm = _port(tied)
    px, pre, suf = _inputs(3)
    got, want = _generate_both(model, tied, tm, px, pre, suf, 4)
    np.testing.assert_array_equal(got, want)
    assert not got.any()
    row = np.array([0.5, 2.0, -1.0, 2.0, 2.0], np.float32)
    assert int(torch.from_numpy(row).argmax(-1)) == int(jnp.argmax(jnp.asarray(row), -1)) == 1


def _captioners(phi, max_new=6, batch=5):
    model, tree, state, _ = phi
    jcap = jp.Phi3VCaptioner(JCap(backend="phi3v", max_new_tokens=max_new), dims=JDIMS,
                             params=tree, batch_size=batch)
    jcap.model = model  # float32 (its own builds bfloat16); read when its graph traces
    tcap = tp.Phi3VCaptioner(CaptionerConfig(backend="phi3v", max_new_tokens=max_new,
                                             dtype="float32"),
                             TDIMS, state, batch_size=batch, device="cpu")
    return jcap, tcap


@pytest.fixture(scope="module")
def captioners(phi):
    return _captioners(phi)


def test_captioner_matches_jax(phi, captioners):
    """Prompt ids, the 64 -> 28 resize and CLIP normalisation, caption texts
    of 7 crops (padded to 10); the first 3 captioned alone (padded to 5)
    read the same."""
    jcap, tcap = captioners
    np.testing.assert_array_equal(tcap.prefix_ids, jcap.prefix_ids)
    np.testing.assert_array_equal(tcap.suffix_ids, jcap.suffix_ids)
    assert tcap.max_new_tokens == 6 and tcap.batch_size == 5 and not tcap.fusable
    rng = np.random.default_rng(4)
    crops = (rng.random((7, 64, 64, 3)) * 255).astype(np.float32)
    _close(tcap.preprocess(torch.from_numpy(crops)).permute(0, 2, 3, 1).numpy(),
           jcap.preprocess(jnp.asarray(crops)))
    valid = np.array([True, False, True, True, True, False, True])
    got = tcap.caption_crops(torch.from_numpy(crops), valid)
    assert got == jcap.caption_crops(jnp.asarray(crops), valid)
    assert tcap.generate_calls == 2 and len(got) == 5
    only_first = np.arange(7) < 3  # the second batch of 5 holds no valid crop
    assert tcap.caption_crops(torch.from_numpy(crops), only_first) == \
        jcap.caption_crops(jnp.asarray(crops), only_first)
    assert tcap.generate_calls == 3
    every = tcap.caption_crops(torch.from_numpy(crops), np.ones(7, bool))
    assert tcap.caption_crops(torch.from_numpy(crops[:3]), np.ones(3, bool)) == every[:3]


def test_get_parsed_content_icon_phi3v_matches_jax(captioners):
    """The reference's call: the first len(ocr_bbox) boxes are OCR and
    skipped, the rest cropped and captioned in batches of 5."""
    from omniparser_tpu import compat as jcompat
    from omniparser_tpu_torch import compat as tcompat

    jcap, tcap = captioners
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    boxes = np.array([[0.0, 0.0, 0.4, 0.3], [0.1, 0.1, 0.6, 0.6], [0.5, 0.4, 0.9, 0.9],
                      [0.2, 0.5, 0.3, 0.95]], np.float32)
    for ocr in ([[0, 0, 51, 28]], None):
        got = tcompat.get_parsed_content_icon_phi3v(boxes, ocr, img, tcap, device="cpu")
        assert got == jcompat.get_parsed_content_icon_phi3v(boxes, ocr, img, jcap)
        assert len(got) == (3 if ocr else 4)


def test_parse_with_phi3v_matches_jax(phi):
    """A reduced-width parse (seeded YOLOv8-n at 128, no OCR) with backend 'phi3v':
    the port builds its captioner through the route from the carried state,
    the JAX pipeline is handed the float32 captioner; every content-less
    icon is captioned after the fused step, and the elements are equal."""
    from omniparser_tpu import config as jcfg
    from omniparser_tpu.models import yolov8 as jyolo
    from omniparser_tpu.pipeline import SOMPipeline as JaxPipeline
    from omniparser_tpu_torch import config as tcfg
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from tests.test_torch_yolov9 import seeded_tree

    @dataclasses.dataclass(frozen=True)
    class F32Detector(jyolo.Detector):
        @property
        def module(self):
            return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                                dtype=jnp.float32)

    jdet = F32Detector(imgsz=128, max_det=32)
    det_tree = seeded_tree(jax.eval_shape(lambda: jdet.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)),
        np.random.default_rng(11))
    det = dict(default_imgsz=128, max_detections=32, box_threshold=0.02,
               nms_iou_threshold=0.6)
    cap = dict(backend="phi3v", batch_size=4, max_new_tokens=5)
    kw = dict(detector_weights=None, captioner_weights=None)
    jcap, _ = _captioners(phi, max_new=5)
    jpipe = JaxPipeline(jcfg.PipelineConfig(detector=jcfg.DetectorConfig(**det),
                                            captioner=jcfg.CaptionerConfig(**cap),
                                            ocr=jcfg.OcrConfig(backend="null"), **kw),
                        detector=jdet, detector_params=det_tree, captioner=jcap)
    tpipe = SOMPipeline(tcfg.PipelineConfig(detector=tcfg.DetectorConfig(dtype="float32", **det),
                                            captioner=tcfg.CaptionerConfig(dtype="float32", **cap),
                                            ocr=tcfg.OcrConfig(backend="null"), **kw),
                        device="cpu", captioner_state=phi[2], captioner_dims=TDIMS,
                        detector_state=convert.convert_yolov8(convert.flatten_variables(det_tree)))
    assert isinstance(tpipe.captioner, tp.Phi3VCaptioner) and tpipe._florence is None
    img = np.random.default_rng(15).integers(0, 255, (96, 112, 3), dtype=np.uint8)
    _, _, j_el = jpipe.parse_image(img)
    _, _, t_el = tpipe.parse_image(img)
    icons = [e for e in t_el if e["source"] == "box_yolo_content_yolo"]
    # two caption-grid batches of 4 crops, each padded to one decode batch of 5
    assert len(icons) > 4 and tpipe.captioner.generate_calls == 2
    assert len(t_el) == len(j_el)
    for a, b in zip(t_el, j_el):
        assert (a["type"], a["source"], a["content"]) == (b["type"], b["source"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-4)
    assert all(isinstance(e["content"], str) for e in icons)


# ------------------------------ converter ------------------------------ #


def test_convert_phi3v_matches_jax_converter(phi):
    """The synthesised HF state dict of tests/test_phi3v.py: the port's tree
    equals the JAX converter's leaf for leaf, but for the tower layer after
    the feature layer, which the port returns apart as unused (the JAX tree
    keeps it; its ClipViT never runs it); the same unmatched keys; the
    carried state computes what the JAX model computes from the JAX tree."""
    from omniparser_tpu.weights.convert_phi3v import convert_phi3v_state_dict as jconvert
    from omniparser_tpu_torch.weights.convert_phi3v import convert_phi3v_state_dict
    from tests.test_phi3v import _synth_hf_state_dict

    sd = _synth_hf_state_dict(np.random.default_rng(12))
    sd["model.vision_embed_tokens.img_projection.1.weight"] = np.zeros(3, np.float32)
    sd["model.extra.weight"] = np.zeros(3, np.float32)
    j_tree, j_unmatched = jconvert(sd, JDIMS)
    tree, unmatched, unused = convert_phi3v_state_dict(sd, TDIMS)
    assert unmatched == j_unmatched == ["model.vision_embed_tokens.img_projection.1.weight",
                                        "model.extra.weight"]
    last = "model.vision_embed_tokens.img_processor.vision_model.encoder.layers.1."
    assert sorted(unused) == sorted(k for k in sd if k.startswith(last))
    flat, j_flat = convert.flatten_variables(tree), convert.flatten_variables(j_tree)
    assert set(j_flat) - set(flat) == {k for k in j_flat if "/vision/layers_1/" in k}
    for k, v in flat.items():
        np.testing.assert_array_equal(v, j_flat[k], err_msg=k)
    state = convert.convert_phi3v(flat, TDIMS)
    tm = tp.build_phi3v(TDIMS, state, torch.float32, "cpu")
    px, pre, suf = _inputs(13)
    jl, _ = phi[0].apply(j_tree, jnp.asarray(px), jnp.asarray(pre), jnp.asarray(suf), None,
                         method=jp.Phi3V.forward_prompt)
    with torch.no_grad():
        _close(tm.forward_prompt(*_t(px, pre, suf))[0].numpy(), jl)


def test_manifest_keys_are_consumed_or_skipped():
    """The JAX package's manifest of the checkpoint's remote-code keys (read
    as data): the projector keys are consumed at their shapes, the HD
    separators skipped, the CLIP prefix spelling recognised."""
    from omniparser_tpu_torch.weights.convert_phi3v import convert_phi3v_state_dict

    path = os.path.join(os.path.dirname(__file__), "..", "omniparser_tpu", "weights",
                        "manifests", "phi3v_vision_prefix.json")
    with open(path) as f:
        man = json.load(f)
    d = tp.PHI3V_BASE
    tree, unmatched, _ = convert_phi3v_state_dict(
        {k: np.zeros(s, np.float32) for k, s in man["consumed"].items()})
    assert unmatched == []
    p = tree["params"]
    assert (p["proj_1"]["kernel"].shape, p["proj_2"]["kernel"].shape) == ((4096, 3072),
                                                                          (3072, 3072))
    tree, unmatched, unused = convert_phi3v_state_dict(
        {k: np.zeros(s, np.float32) for k, s in man["skipped"].items()})
    assert unmatched == [] and unused == [] and tree == {"params": {}}
    n = (d.image_size // d.patch_size) ** 2 + 1
    shapes = {"embeddings.class_embedding": (d.vision_width,),
              "embeddings.patch_embedding.weight": (d.vision_width, 3, 14, 14),
              "embeddings.position_embedding.weight": (n, d.vision_width),
              "pre_layrnorm.weight": (d.vision_width,),
              "encoder.layers.0.self_attn.q_proj.weight": (d.vision_width, d.vision_width),
              "encoder.layers.0.mlp.fc1.weight": (d.vision_mlp, d.vision_width),
              "post_layernorm.weight": (d.vision_width,)}
    for key in man["clip_prefix_example_keys"]:
        _, unmatched, _ = convert_phi3v_state_dict(
            {key: np.zeros(shapes[key.removeprefix(man["clip_prefix"])], np.float32)})
        assert unmatched == [], key


def test_two_shard_directory_loads_through_the_routes(phi, tmp_path, monkeypatch):
    """A TINY HF-spelled directory in two shards loads through
    get_caption_model_processor('phi3_v', path) (the depth read from the keys) and
    Omniparser(dict) with caption_model_name 'phi3_v', with transformers
    and safetensors unimportable: tensor for tensor equal; 'auto' raises."""
    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.config import OcrConfig, PipelineConfig
    from omniparser_tpu_torch.ocr import NullOCR
    from omniparser_tpu_torch.pipeline import Omniparser, SOMPipeline
    from omniparser_tpu_torch.weights.convert_phi3v import convert_phi3v_state_dict
    from omniparser_tpu_torch.weights.safetensors import write_safetensors
    from tests.test_phi3v import _synth_hf_state_dict

    for name in ("transformers", "safetensors"):
        monkeypatch.setitem(sys.modules, name, None)
    sd = _synth_hf_state_dict(np.random.default_rng(14))
    keys = sorted(sd)
    write_safetensors(str(tmp_path / "model-00001-of-00002.safetensors"),
                      {k: sd[k] for k in keys[: len(keys) // 2]})
    write_safetensors(str(tmp_path / "model-00002-of-00002.safetensors"),
                      {k: sd[k] for k in keys[len(keys) // 2:]})
    tree, _, _ = convert_phi3v_state_dict(sd, TDIMS)
    want = convert.convert_phi3v(convert.flatten_variables(tree), TDIMS)
    # the route reads the published widths at the checkpoint's own depth:
    # here TINY's widths stand in for the published ones
    monkeypatch.setattr(tp, "PHI3V_BASE", dataclasses.replace(TDIMS, lm_layers=9,
                                                             vision_layers=9))
    cap = compat.get_caption_model_processor("phi3_v", str(tmp_path), device="cpu")
    assert cap.dims == TDIMS
    parser = Omniparser({"caption_model_name": "phi3_v", "caption_model_path": str(tmp_path)},
                        device="cpu", ocr=NullOCR(), captioner_dims=TDIMS)
    for got in (cap, parser.pipeline.captioner):
        assert isinstance(got, tp.Phi3VCaptioner) and got.max_new_tokens in (25, 20)
        gs = got.model.state_dict()
        assert set(gs) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(gs[k], v.to(gs[k].dtype), rtol=0, atol=0, msg=k)
    assert parser.config.captioner.backend == "phi3v"
    cfg = PipelineConfig(captioner=CaptionerConfig(backend="phi3v", dtype="float32"),
                         ocr=OcrConfig(backend="null"), detector_weights=None,
                         captioner_weights="auto")
    with pytest.raises(ValueError, match="Phi-3-vision"):
        SOMPipeline(cfg, device="cpu", captioner_dims=TDIMS)
