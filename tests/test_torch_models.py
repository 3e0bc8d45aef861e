"""The port's networks vs the JAX package's, with the same weights carried
through ``weights/convert.py`` and the same numpy-seeded inputs, on the CPU
in float32 at small sizes."""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import ocr as jocr
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu.ops.preprocess import pad_to_bucket
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models import ocr as tocr
from omniparser_tpu_torch.models import yolov8 as tyolo
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.init import build_module

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)

T = torch.from_numpy
F32 = torch.float32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randomise_stats(variables, rng):
    """Give BatchNorm non-trivial statistics and affine terms, so that a
    swapped or dropped tensor shows."""
    variables = _np_tree(variables)

    def visit(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v, path + (k,))
            elif path[0] == "batch_stats" or k in ("scale", "bias"):
                lo, hi = (0.5, 1.5) if k in ("var", "scale") else (-0.3, 0.3)
                node[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)

    visit(variables, ())
    return variables


def _build(module, state):
    return build_module(module, state, None, F32, "cpu")


# ------------------------------- YOLOv8 ------------------------------- #

class F32Detector(jyolo.Detector):
    """The JAX detector with a float32 module (its own builds bfloat16)."""

    @property
    def module(self):
        return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                            dtype=jnp.float32)


DET = F32Detector(imgsz=320, max_det=64)  # 2100 anchors -> the 2100-box NMS window
TDET = tyolo.Detector(imgsz=320, max_det=64)
_j_detect = jax.jit(lambda v, p, hw, c, n: DET.detect_graph(v, p, hw, c, n, with_stats=True,
                                                            with_raw=True))


@functools.lru_cache(maxsize=None)
def _det_init():
    """One jitted init for the three tests that need the detector's tree."""
    return _np_tree(DET.init_params(jax.random.PRNGKey(0)))


def _compare_detect(variables, padded, h, w, conf):
    want = _j_detect(variables, jnp.asarray(padded), jnp.asarray([h, w], jnp.int32),
                     jnp.float32(conf), jnp.float32(0.1))
    module = _build(TDET.make_module(), convert.convert_yolov8(
        convert.flatten_variables(_np_tree(variables))))
    got = TDET.detect_graph(module, T(padded), (h, w), conf, 0.1, with_stats=True,
                            with_raw=True)
    wb, ws, wv, wover, (wraw_b, wraw_s) = [np.asarray(x) if not isinstance(x, tuple)
                                           else tuple(np.asarray(y) for y in x) for x in want]
    gb, gs, gv, gover, (graw_b, graw_s) = got
    # the network and the decode: float32 convolutions summed in another order
    np.testing.assert_allclose(graw_s.numpy(), wraw_s, rtol=0, atol=2e-5)
    np.testing.assert_allclose(graw_b.numpy(), wraw_b, rtol=0, atol=2e-4)
    assert int(gover) == int(wover)
    # after NMS: same slots valid, same boxes
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() >= 3
    np.testing.assert_allclose(gs.numpy(), ws, rtol=0, atol=2e-5)
    np.testing.assert_allclose(gb.numpy(), wb, rtol=0, atol=2e-4)


def test_yolov8n_random_init_detect_matches(rng):
    variables = _randomise_stats(_det_init(), rng)
    h, w = 200, 300
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    padded, _ = pad_to_bucket(img, 256, 384)
    # a high threshold leaves a few dozen candidates whose scores are apart
    # by more than the float32 noise between the two frameworks, so the
    # greedy order is the same on both sides
    raw = _j_detect(variables, jnp.asarray(padded), jnp.asarray([h, w], jnp.int32),
                    jnp.float32(0.0), jnp.float32(0.1))[4][1]
    conf = float(np.sort(np.asarray(raw))[-60])
    _compare_detect(variables, padded, h, w, conf)


def test_yolov8n_shipped_det_synth_matches(rng):
    """The shipped detector checkpoint, read through the JAX package."""
    from omniparser_tpu.train.synth_gui import render_gui_scene
    from omniparser_tpu.weights.checkpoints import load_checkpoint

    from omniparser_tpu.config import DetectorConfig

    path = jyolo.default_detector_weights(DetectorConfig())
    assert path and os.path.isdir(path)
    like = {"det": _det_init()}
    variables = load_checkpoint(path, like=like)["det"]
    img = render_gui_scene(np.random.default_rng(7), size=320)[0]
    h, w = img.shape[:2]
    padded, _ = pad_to_bucket(np.asarray(img), 384, 384)
    _compare_detect(variables, padded, h, w, 0.25)


def test_convert_rejects_missing_and_leftover_keys(rng):
    flat = convert.flatten_variables(_det_init())
    short = dict(flat)
    short.pop("params/stem/conv/kernel")
    with pytest.raises(KeyError, match="stem.conv.weight"):
        convert.convert_yolov8(short)
    extra = dict(flat)
    extra["params/stem/conv/extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="params/stem/conv/extra"):
        convert.convert_yolov8(extra)
    bad = dict(flat)
    bad["params/stem/conv/kernel"] = np.zeros((3, 3, 3, 7), np.float32)
    with pytest.raises(ValueError, match="params/stem/conv/kernel"):
        convert.convert_yolov8(bad)


def test_load_npz_round_trip(tmp_path, rng):
    flat = {"params/a/kernel": rng.normal(size=(3, 4)).astype(np.float32),
            "batch_stats/a/mean": rng.normal(size=(4,)).astype(np.float32)}
    np.savez(tmp_path / "w.npz", **flat)
    back = convert.load_npz(str(tmp_path / "w.npz"))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


# --------------------------------- OCR --------------------------------- #


def _jit_init(model, seed, shape):
    """Flax init under jit (op-by-op init costs tens of seconds on the CPU)."""
    return jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))


def _jit_apply(model):
    return jax.jit(functools.partial(model.apply, train=False))



@pytest.mark.parametrize("size", [128, 104])  # 104: odd sizes down the pyramid
def test_text_detector_matches(rng, size):
    model = jocr.TextDetector(dtype=jnp.float32)
    variables = _randomise_stats(_jit_init(model, 1, (1, 64, 64, 3)), rng)
    x = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(_jit_apply(model)(variables, jnp.asarray(x)))
    net = _build(tocr.TextDetector(), convert.convert_text_detector(
        convert.flatten_variables(variables)))
    with torch.no_grad():
        got = net(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    # float32 convolutions summed in another order, through a sigmoid
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_text_recognizer_and_ctc_stats_match(rng):
    model = jocr.TextRecognizer(dtype=jnp.float32)
    variables = _randomise_stats(_jit_init(model, 2, (1, 32, 128, 3)), rng)
    variables["params"]["ctc_head"]["kernel"] = (
        variables["params"]["ctc_head"]["kernel"] * 8.0)  # peaky logits: repeats and blanks
    x = rng.uniform(0, 1, (6, 32, 128, 3)).astype(np.float32)
    want = _jit_apply(model)(variables, jnp.asarray(x))
    net = _build(tocr.TextRecognizer(seq_len=32), convert.convert_text_recognizer(
        convert.flatten_variables(variables)))
    with torch.no_grad():
        got = net(T(x).permute(0, 3, 1, 2))
    # float32 sums in another order through two transformer layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    wids, wconf, wn = jocr.ctc_device_stats(want)
    gids, gconf, gn = tocr.ctc_device_stats(got)
    np.testing.assert_array_equal(gids.numpy(), np.asarray(wids))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    np.testing.assert_allclose(gconf.numpy(), np.asarray(wconf), rtol=0, atol=1e-4)
    assert np.asarray(wn).sum() > 0
    for row in np.asarray(wids):
        assert tocr.ids_to_text(row) == jocr.ids_to_text(row)


# ------------------------------- Florence ------------------------------ #

_TINY = dict(
    embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
    depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=2, decoder_layers=2,
    attn_heads=4, ffn_dim=64, vocab_size=100, max_positions=64,
)


def test_florence_greedy_generate_matches(rng):
    jd, td = jflo.FlorenceDims(**_TINY), tflo.FlorenceDims(**_TINY)
    assert jd.patch_prenorm == td.patch_prenorm and jflo.BASE.__dict__ == tflo.BASE.__dict__
    model = jflo.Florence2(dims=jd, dtype=jnp.float32)
    # 96 px -> 3x3 tokens at the last stage; window 4 pads the 6x6 stage
    variables = _np_tree(jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 96, 96, 3), jnp.float32),
        jnp.zeros((1, 5), jnp.int32), jnp.zeros((1, 3), jnp.int32)))
    # larger embeddings and biases: decided argmaxes, and some rows reach EOS
    p = variables["params"]["language_model"]
    p["shared"]["embedding"] = rng.normal(0, 1.0, p["shared"]["embedding"].shape).astype(np.float32)
    p["final_logits_bias"] = rng.normal(0, 1.0, p["final_logits_bias"].shape).astype(np.float32)
    p["final_logits_bias"][2] += 3.5
    px = rng.normal(0, 1, (5, 96, 96, 3)).astype(np.float32)
    prompt = np.tile(np.array([[0, 17, 23, 2, 1]], np.int32), (5, 1))  # with a pad
    max_new = 8
    wtok, wlp = jax.jit(lambda v, a, b: jflo.greedy_generate(
        model, v, a, b, max_new, with_scores=True))(variables, jnp.asarray(px), jnp.asarray(prompt))
    net = _build(tflo.Florence2(td), convert.convert_florence2(
        convert.flatten_variables(variables), td))
    gtok, glp = tflo.greedy_generate(net, T(px), T(prompt).long(), max_new, with_scores=True)
    wtok = np.asarray(wtok)
    np.testing.assert_array_equal(gtok.numpy(), wtok)
    np.testing.assert_allclose(glp.numpy(), np.asarray(wlp), rtol=0, atol=1e-4)
    assert (wtok == 2).any() and (wtok == 1).any() and not (wtok[:, 0] == 2).all()
    # teacher-forced logits too
    dec = np.tile(np.array([[2, 11, 12]], np.int32), (5, 1))
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(px), jnp.asarray(prompt),
                                           jnp.asarray(dec)))
    with torch.no_grad():
        got = net(T(px), T(prompt).long(), T(dec).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_florence_captioner_host_side():
    from omniparser_tpu.config import CaptionerConfig as JC
    from omniparser_tpu_torch.config import CaptionerConfig as TC
    from omniparser_tpu.models.tokenizer import FallbackTokenizer as JTok
    from omniparser_tpu_torch.models.tokenizer import FallbackTokenizer as TTok

    text = "What does the image describe?"
    assert TTok().encode(text) == JTok().encode(text)
    ids = [2, 0, 45, 1, 77, 89, 2, 1]
    assert TTok().decode(ids) == JTok().decode(ids)
    cap = tflo.FlorenceCaptioner(TC(dtype="float32", min_logp=-1.0),
                                 tflo.FlorenceDims(**_TINY), device="cpu")
    assert cap.gate_caption("gear icon", -2.0) == "image icon"
    assert cap.gate_caption("gear icon", -0.5) == "gear icon"
    assert cap.tokens_to_text(np.array([2, 0, 45, 77, 1, 1])) == TTok().decode([45, 77]).strip()
    x = torch.full((1, 4, 4, 3), 255.0)
    want = (1.0 - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])
    np.testing.assert_allclose(cap.preprocess(x)[0, 0, 0].numpy(), want, rtol=1e-6)
    assert JC().max_new_tokens == TC().max_new_tokens
