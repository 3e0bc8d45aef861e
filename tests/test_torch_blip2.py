"""The port's beam search (``models/generate.py``), BLIP-2 captioner
(``models/blip2.py``, ``weights/convert_blip2.py``) and the non-fusable
captioner route of the pipeline, against the JAX package's, on the CPU in
float32, with the same numpy-seeded inputs and weights (carried through
``weights/convert.py``).  Token ids, texts and element lists are exact;
scores agree to 1e-5, logits to 1e-4 of their largest magnitude."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.models import blip2 as jb
from omniparser_tpu.models.generate import beam_search as jbeam
from omniparser_tpu_torch.models import blip2 as tb
from omniparser_tpu_torch.models.generate import beam_search, stable_top_k
from omniparser_tpu_torch.weights import convert

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)


def _beams(table, init, k, t, eos, pad, **kw):
    """The same bigram LM (next-token logits depend on the last token only)
    through both beam searches -> (port tokens, port scores, JAX tokens,
    JAX scores)."""
    tt = torch.from_numpy(table)

    def t_step(flat, s, caches):
        return tt[flat[:, 0]][:, None, :], caches

    def j_step(flat, s, caches):
        return jnp.asarray(table)[flat[:, 0]][:, None, :], caches

    b, v = init.shape
    prompt = kw.pop("prompt", None)
    got = beam_search(t_step, torch.from_numpy(init), [], b, k, t, v, eos, pad,
                      prompt_tokens=None if prompt is None else torch.from_numpy(prompt), **kw)
    want = jbeam(j_step, jnp.asarray(init), (), b, k, t, v, eos_token_id=eos,
                 pad_token_id=pad, prompt_tokens=None if prompt is None else jnp.asarray(prompt),
                 **kw)
    return got[0].numpy(), got[1].numpy(), np.asarray(want[0]), np.asarray(want[1])


@pytest.mark.parametrize("ngram,prompt", [(0, False), (2, False), (2, True)])
def test_beam_search_matches_jax(ngram, prompt, rng):
    v, k, t = 12, 3, 6
    for _ in range(3):
        table = (rng.normal(size=(v, v)) * 2).astype(np.float32)
        init = (rng.normal(size=(2, v)) * 2).astype(np.float32)
        kw = dict(no_repeat_ngram_size=ngram, length_penalty=1.3)
        if prompt:
            kw.update(prompt=rng.integers(0, v, (2, 4)).astype(np.int32), length_offset=4)
        tok, sc, j_tok, j_sc = _beams(table, init, k, t, 11, 0, **kw)
        np.testing.assert_array_equal(tok, j_tok)
        np.testing.assert_allclose(sc, j_sc, rtol=0, atol=1e-5)


def test_beam_search_ties_break_as_jax_top_k():
    """All logits equal: every candidate ties at every step, and finished
    beams tie at pad; jax.lax.top_k takes the lower index first, and so
    must the port (torch.topk promises no order)."""
    v = 9
    table = np.zeros((v, v), np.float32)
    table[:, 8] = -1.0
    init = np.zeros((2, v), np.float32)
    init[1, 3] = 1.0
    for ngram in (0, 2):
        tok, sc, j_tok, j_sc = _beams(table, init, 4, 5, 2, 0, no_repeat_ngram_size=ngram)
        np.testing.assert_array_equal(tok, j_tok)
        np.testing.assert_allclose(sc, j_sc, rtol=0, atol=1e-6)
    x = np.array([[0.5, 1.0, 1.0, 0.2, 1.0, 0.5]], np.float32)
    vals, idx = stable_top_k(torch.from_numpy(x), 4)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


def test_beam_search_bigram_ban_and_prompt_boundary():
    """The JAX tests' LMs that love a cycle: (3, 4) may not repeat, and a
    bigram of the prompt is banned across the prompt boundary; an invalid
    pair never bans token 0."""
    v = 6
    table = np.full((v, v), -5.0, np.float32)
    table[3, 4] = table[4, 3] = 5.0
    table[3, 2] = table[4, 2] = 1.0
    table[:, 0] = 2.0  # token 0 is a strong second choice everywhere
    init = np.full((1, v), -5.0, np.float32)
    init[0, 3] = 5.0
    tok, _, j_tok, _ = _beams(table, init, 2, 6, 5, 1, no_repeat_ngram_size=2)
    np.testing.assert_array_equal(tok, j_tok)
    pairs = [(tok[0][i], tok[0][i + 1]) for i in range(5)]
    assert pairs.count((3, 4)) <= 1
    prompt = np.array([[2, 3, 4]], np.int32)
    init[0, 4] = 6.0
    tok, _, j_tok, _ = _beams(table, init, 2, 4, 5, 1, no_repeat_ngram_size=2,
                              prompt=prompt, length_offset=3)
    np.testing.assert_array_equal(tok, j_tok)
    full = [2, 3, 4] + list(tok[0])
    assert [(full[i], full[i + 1]) for i in range(len(full) - 1)].count((3, 4)) == 1


def test_beam_eos_freezes_beam_and_one_beam_is_greedy(rng):
    v = 5
    table = np.zeros((v, v), np.float32)
    table[1, 4] = 10.0  # 1 -> eos (4)
    init = np.zeros((1, v), np.float32)
    init[0, 1] = 10.0
    tok, _, j_tok, _ = _beams(table, init, 2, 5, 4, 0)
    np.testing.assert_array_equal(tok, j_tok)
    assert list(tok[0][:2]) == [1, 4] and not tok[0][2:].any()
    v = 10
    table = rng.normal(size=(v, v)).astype(np.float32)
    init = rng.normal(size=(1, v)).astype(np.float32)
    tok, _, j_tok, _ = _beams(table, init, 1, 6, 9, 0)
    np.testing.assert_array_equal(tok, j_tok)
    cur = int(np.argmax(init[0]))
    want = [cur]
    for _ in range(5):  # the greedy rollout; pad after eos
        if cur == 9:
            want.append(0)
            continue
        cur = int(np.argmax(table[cur]))
        want.append(cur)
    assert list(tok[0]) == want


# ------------------------------- BLIP-2 ------------------------------- #

# a vocabulary that holds the fallback tokenizer's prompt ids (ROADMAP C.4)
DIMS = dataclasses.replace(jb.TINY_BLIP2, vocab_size=160, eos_token_id=159)
TDIMS = tb.Blip2Dims(**dataclasses.asdict(DIMS))


@pytest.fixture(scope="module")
def blip():
    from tests.test_torch_yolov9 import seeded_tree

    model = jb.Blip2(dims=DIMS, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)), jnp.zeros((1, 3), jnp.int32),
        jnp.zeros((1, 2), jnp.int32)))
    tree = seeded_tree(shapes, np.random.default_rng(7))
    state = convert.convert_blip2(convert.flatten_variables(tree), TDIMS)
    return model, tree, state, tb.build_blip2(TDIMS, state, torch.float32, "cpu")


def test_tiny_blip2_prefill_and_decode_match_jax(blip):
    model, tree, _, tm = blip
    rng = np.random.default_rng(8)
    px = rng.random((2, 28, 28, 3), np.float32)
    prompt = rng.integers(3, 150, (2, 5)).astype(np.int32)
    prefill = jax.jit(lambda v, x, ids: model.apply(v, x, ids, 12,
                                                    method=jb.Blip2.encode_and_prefill)[:2])
    decode = jax.jit(lambda v, ids, s, c: model.apply(v, ids, s, jp, c,
                                                      method=jb.Blip2.decode_one))
    jp = DIMS.num_query_tokens + 5
    jl, jc = prefill(tree, jnp.asarray(px), jnp.asarray(prompt))
    with torch.no_grad():
        tl, tc, tp = tm.encode_and_prefill(torch.from_numpy(px).permute(0, 3, 1, 2),
                                           torch.from_numpy(prompt).long(), 12)
    assert tp == jp == DIMS.num_query_tokens + 5
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
    for s, tok in enumerate(([7], [8])):
        jl, jc = decode(tree, jnp.asarray([tok, tok], jnp.int32), s, list(jc))
        with torch.no_grad():
            tl = tm.decode_one(torch.tensor([tok, tok]), s, tp, tc)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())


def test_blip2_generate_matches_jax(blip):
    model, tree, _, tm = blip
    rng = np.random.default_rng(9)
    px = rng.random((3, 28, 28, 3), np.float32)
    prompt = np.tile(np.array([[2, 40, 41, 42]], np.int32), (3, 1))
    j_tok, j_sc = jax.jit(lambda p, x, ids: jb.blip2_generate(
        model, p, x, ids, max_new_tokens=6, num_beams=3))(tree, jnp.asarray(px),
                                                         jnp.asarray(prompt))
    tok, sc = tb.blip2_generate(tm, torch.from_numpy(px).permute(0, 3, 1, 2),
                                torch.from_numpy(prompt).long(), 6, 3)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(sc.numpy(), np.asarray(j_sc), rtol=0, atol=1e-5)
    tok2, _ = tb.blip2_generate(tm, torch.from_numpy(px).permute(0, 3, 1, 2),
                                torch.from_numpy(prompt).long(), 6, 3)
    assert torch.equal(tok, tok2)


def _captioners(blip, crop_size=64, batch=8, max_new=5):
    from omniparser_tpu.config import CaptionerConfig as JCap
    from omniparser_tpu_torch.config import CaptionerConfig

    model, tree, state, _ = blip
    jcap = jb.Blip2Captioner(JCap(backend="blip2", crop_size=crop_size, batch_size=batch,
                                  max_new_tokens=max_new), dims=DIMS, params=tree, num_beams=3)
    jcap.model = model  # float32 (its own builds bfloat16); read when its graph traces
    tcap = tb.Blip2Captioner(CaptionerConfig(backend="blip2", crop_size=crop_size,
                                             batch_size=batch, max_new_tokens=max_new,
                                             dtype="float32"),
                             TDIMS, state, num_beams=3, device="cpu")
    return jcap, tcap


def test_blip2_captioner_matches_jax(blip):
    """Crops of 64 (shrunk to the tower's 28: antialiased, as jax.image.resize
    is) and of 16 (grown): the same pixels into the tower, the same captions."""
    rng = np.random.default_rng(10)
    for size in (64, 16):
        jcap, tcap = _captioners(blip, crop_size=size)
        crops = (rng.random((3, size, size, 3)) * 255).astype(np.float32)
        want = np.asarray(jcap.preprocess(jnp.asarray(crops)))
        got = tcap.preprocess(torch.from_numpy(crops)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
        valid = np.array([True, False, True])
        assert tcap.caption_crops(torch.from_numpy(crops), valid) == \
            jcap.caption_crops(jnp.asarray(crops), valid)
    np.testing.assert_array_equal(tcap.prompt_ids, jcap.prompt_ids)


def _icon_pipelines(blip, captioners):
    """(JAX pipeline, port pipeline): a seeded YOLOv8-n at 128, no OCR, the
    given (JAX, port) captioners."""
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
    det = dict(default_imgsz=128, max_detections=32, box_threshold=0.05,
               nms_iou_threshold=0.6)
    cap = dict(backend="blip2", batch_size=2, max_new_tokens=5)
    kw = dict(detector_weights=None, captioner_weights=None)
    jcap, tcap = captioners
    jp = JaxPipeline(jcfg.PipelineConfig(detector=jcfg.DetectorConfig(**det),
                                         captioner=jcfg.CaptionerConfig(**cap),
                                         ocr=jcfg.OcrConfig(backend="null"), **kw),
                     detector=jdet, detector_params=det_tree, captioner=jcap)
    tp = SOMPipeline(tcfg.PipelineConfig(detector=tcfg.DetectorConfig(dtype="float32", **det),
                                         captioner=tcfg.CaptionerConfig(dtype="float32", **cap),
                                         ocr=tcfg.OcrConfig(backend="null"), **kw),
                     device="cpu", captioner=tcap,
                     detector_state=convert.convert_yolov8(convert.flatten_variables(det_tree)))
    return jp, tp


def test_parse_with_blip2_matches_jax(blip, rng):
    """backend='blip2': every content-less icon is captioned by beam search
    after the fused step (in batches through the caption grid), in
    parse_image and parse_batch alike, as the JAX package does."""
    jp, tp = _icon_pipelines(blip, _captioners(blip))
    img = rng.integers(0, 255, (96, 112, 3), dtype=np.uint8)
    _, _, j_el = jp.parse_image(img)
    _, _, t_el = tp.parse_image(img)
    icons = [e for e in t_el if e["source"] == "box_yolo_content_yolo"]
    assert len(icons) > 2, "more icons than one caption batch (2 crops)"
    assert tp.captioner.generate_calls == -(-len(icons) // 2)
    assert len(t_el) == len(j_el)
    for a, b in zip(t_el, j_el):
        assert (a["type"], a["source"], a["content"]) == (b["type"], b["source"], b["content"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=1e-4)
    assert all(isinstance(e["content"], str) for e in icons)
    assert {e["content"] for e in icons} != {"icon"}
    (_, _, batched), = tp.parse_batch([img])
    assert batched == t_el


def test_fill_captions_uses_a_non_fusable_captioner(blip, rng):
    """The repair of _fill_captions (ROADMAP C.11): a captioner outside the
    fused step captions every content-less icon through _caption_boxes; only
    the NullCaptioner writes 'icon'."""
    from omniparser_tpu_torch.pipeline import NullCaptioner

    class Stub:
        fusable = False
        config = None

        def __init__(self):
            self.crops = []

        def caption_crops(self, crops, valid):
            self.crops.append(tuple(crops.shape))
            return [f"stub {i}" for i in range(int(np.asarray(valid).sum()))]

    jcap, tcap = _captioners(blip)
    _, tp = _icon_pipelines(blip, (jcap, tcap))
    stub = Stub()
    tp.captioner, tp._florence = stub, None
    img = rng.integers(0, 255, (96, 112, 3), dtype=np.uint8)
    _, _, elements = tp.parse_image(img)
    icons = [e for e in elements if e["source"] == "box_yolo_content_yolo"]
    assert icons and [e["content"] for e in icons] == [f"stub {i % 2}" for i in range(len(icons))]
    assert len(stub.crops) == -(-len(icons) // 2) and set(stub.crops) == {(2, 64, 64, 3)}
    tp.captioner = NullCaptioner()
    _, _, elements = tp.parse_image(img)
    assert {e["content"] for e in elements if e["source"] == "box_yolo_content_yolo"} == {"icon"}


def test_convert_blip2_on_a_genuine_hf_model(blip, tmp_path):
    """A real transformers Blip2ForConditionalGeneration (tiny config): no key
    left over, the carrier accepts the tree, the port computes what the JAX
    package computes from its own converter's tree, and an HF-spelled
    safetensors directory loads back equal."""
    from transformers import (Blip2Config, Blip2ForConditionalGeneration, Blip2QFormerConfig,
                              Blip2VisionConfig, OPTConfig)

    from omniparser_tpu.weights.convert_blip2 import convert_blip2_state_dict as jconvert
    from omniparser_tpu_torch.weights.convert_blip2 import (convert_blip2_state_dict,
                                                            load_blip2_state)
    from omniparser_tpu_torch.weights.safetensors import write_safetensors

    d = DIMS
    cfg = Blip2Config.from_vision_qformer_text_configs(
        Blip2VisionConfig(hidden_size=d.vision_width, intermediate_size=d.vision_mlp,
                          num_hidden_layers=d.vision_layers, num_attention_heads=d.vision_heads,
                          image_size=d.image_size, patch_size=d.patch_size),
        Blip2QFormerConfig(hidden_size=d.qformer_width, num_hidden_layers=d.qformer_layers,
                           num_attention_heads=d.qformer_heads, intermediate_size=d.qformer_mlp,
                           encoder_hidden_size=d.vision_width,
                           cross_attention_frequency=d.cross_frequency),
        OPTConfig(hidden_size=d.lm_width, num_hidden_layers=d.lm_layers, ffn_dim=d.lm_mlp,
                  num_attention_heads=d.lm_heads, vocab_size=d.vocab_size,
                  max_position_embeddings=d.max_positions, word_embed_proj_dim=d.lm_width),
        num_query_tokens=d.num_query_tokens)
    torch.manual_seed(0)
    sd = {k: v.detach().numpy() for k, v in Blip2ForConditionalGeneration(cfg).state_dict().items()}
    tree, unmatched = convert_blip2_state_dict(sd)
    j_tree, j_unmatched = jconvert(sd, d)
    assert unmatched == j_unmatched == []
    state = convert.convert_blip2(convert.flatten_variables(tree), TDIMS)
    tm = tb.build_blip2(TDIMS, state, torch.float32, "cpu")
    model = jb.Blip2(dims=d, dtype=jnp.float32)
    px = np.random.default_rng(12).random((1, 28, 28, 3), np.float32)
    prompt = np.array([[2, 40, 41]], np.int32)
    jl = jax.jit(lambda v, x, ids: model.apply(v, x, ids, 8,
                                               method=jb.Blip2.encode_and_prefill)[0])(
        j_tree, jnp.asarray(px), jnp.asarray(prompt))
    with torch.no_grad():
        tl, _, _ = tm.encode_and_prefill(torch.from_numpy(px).permute(0, 3, 1, 2),
                                         torch.from_numpy(prompt).long(), 8)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
    write_safetensors(str(tmp_path / "model.safetensors"), sd)
    loaded = load_blip2_state(str(tmp_path), TDIMS)
    assert set(loaded) == set(state)
    for k, v in loaded.items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)


def test_blip2_routes(monkeypatch):
    """backend='blip2' and get_caption_model_processor('blip2') build a
    Blip2Captioner (the reference's 5 beams, 100 new tokens); Phi-3-V
    still raises, naming ROADMAP A.8."""
    from omniparser_tpu_torch import compat
    from omniparser_tpu_torch.config import CaptionerConfig, OcrConfig, PipelineConfig
    from omniparser_tpu_torch.pipeline import SOMPipeline

    seen = []
    monkeypatch.setattr(tb, "build_blip2", lambda dims, state, dtype, device, seed=0:
                        seen.append((dims, state, dtype, str(device))) or torch.nn.Linear(1, 1))
    cap = compat.get_caption_model_processor("blip2", device="cpu")
    assert isinstance(cap, tb.Blip2Captioner) and not cap.fusable
    assert (cap.num_beams, cap.max_new_tokens, seen[-1][0]) == (5, 100, tb.BLIP2_OPT_2_7B)
    cfg = PipelineConfig(captioner=CaptionerConfig(backend="blip2", dtype="float32"),
                         ocr=OcrConfig(backend="null"), detector_weights=None,
                         captioner_weights=None)
    p = SOMPipeline(cfg, device="cpu", captioner_dims=TDIMS)
    assert isinstance(p.captioner, tb.Blip2Captioner) and p._florence is None
    assert seen[-1][0] == TDIMS and p.captioner.max_new_tokens == 20
    with pytest.raises(ValueError, match="blip2-opt"):
        SOMPipeline(dataclasses.replace(cfg, captioner_weights="auto"), device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        compat.get_caption_model_processor("phi3_v", device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        SOMPipeline(dataclasses.replace(cfg, captioner=CaptionerConfig(backend="phi3v")),
                    device="cpu")
