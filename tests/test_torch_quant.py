"""The port's int8 weight-only decode (``omniparser_tpu_torch/models/quant.py``
and the ``quant`` branches of its Florence-2) against the JAX package's
``models/quant.py``: the same numpy inputs and weights on both sides, on the
CPU in float32 unless a test says otherwise."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omniparser_tpu.config import CaptionerConfig as JCaptionerConfig
from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import quant as jquant
from omniparser_tpu_torch.config import CaptionerConfig
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models import quant as tquant
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.init import build_module

torch.set_num_threads(2)

# tests/test_quant.py's TINY dims
_TINY = dict(
    embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
    depths=(1, 1, 1, 1), d_model=32, encoder_layers=1, decoder_layers=2, attn_heads=4,
    ffn_dim=64, vocab_size=512, pos_embed_grid=50,
)
JTINY, TTINY = jflo.FlorenceDims(**_TINY), tflo.FlorenceDims(**_TINY)

CAP_SYNTH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "omniparser_tpu", "weights", "cap_synth")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(rng, shape):
    """Normal weights with the corner cases of the rounding: an all-zero
    channel (the 1e-8 floor), and a channel whose scale is exactly 1 with
    entries on half steps (round half to even)."""
    w = rng.normal(0, 0.08, shape).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = 0.0
    w[:6, 1] = [127.0, 2.5, -0.5, 3.5, -126.5, 0.5]
    return w


def test_quantize_ops_match_jax(rng):
    """int8 values and scales exact; the per-row form of the torch layout
    equals the per-column form of the JAX layout."""
    w = _weights(rng, (96, 64))  # a JAX kernel [in, out]
    jq, js = jquant.quantize_columns(w)
    tq, ts = tquant.quantize_columns(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tq[:6, 1].numpy()) == [127, 2, 0, 4, -126, 0]  # half to even
    jqr, jsr = jquant.quantize_rows(w.T)
    tqr, tsr = tquant.quantize_rows(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tqr.numpy(), np.asarray(jqr))
    np.testing.assert_array_equal(tsr.numpy(), np.asarray(jsr))
    np.testing.assert_array_equal(tqr.numpy(), tq.numpy().T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlinear_matches_qdense(rng, dtype):
    """Outputs to 1e-5 in float32; in bfloat16 both round the same float32
    accumulation once to bfloat16, so they agree to one bfloat16 step of
    the output's magnitude."""
    w = _weights(rng, (48, 32))
    b = rng.normal(0, 0.02, (32,)).astype(np.float32)
    x = rng.normal(0, 1.0, (5, 7, 48)).astype(np.float32)
    q, s = jquant.quantize_columns(w)
    want = jquant.QDense(32, dtype=getattr(jnp, dtype)).apply(
        {"params": {"kernel": q, "scale": s, "bias": b}}, jnp.asarray(x))
    want = np.asarray(want.astype(jnp.float32))
    lin = tquant.QLinear(48, 32)
    lin.weight.copy_(torch.from_numpy(np.asarray(q).T.copy()))
    lin.scale.copy_(torch.from_numpy(np.array(s)))
    lin.bias.copy_(torch.from_numpy(b))
    lin.compute_dtype = getattr(torch, dtype)
    got = lin(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    atol = 1e-5 if dtype == "float32" else 2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@functools.lru_cache(maxsize=None)
def _tiny_fp_vars():
    """A float tree at TINY (16 px crops, prompt of 3) with the shapes of
    Flax's init and values from numpy: kernels and embeddings at std
    1/sqrt(fan-in), biases and bare tables at 0.02, norm scales near 1.
    (jax.eval_shape instead of a compiled init keeps this cheap.)"""
    shapes = jax.eval_shape(
        jflo.Florence2(dims=JTINY).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, 16, 3), jnp.float32), jnp.zeros((1, 3), jnp.int32),
        jnp.zeros((1, 1), jnp.int32))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            std = 1.0 / np.sqrt(shape[-1])
        else:
            std = 0.02
        return rng.normal(0, std, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_quantized_state_equals_the_jax_tree_carried_across():
    """quantize_florence_state(port fp state) == convert_florence2(
    quantize_florence_params(JAX fp tree)): same keys, dtypes, every tensor
    bit for bit."""
    fp = _tiny_fp_vars()
    flat = convert.flatten_variables
    want = convert.convert_florence2(flat(_np_tree(jquant.quantize_florence_params(fp))), TTINY)
    fp_state = convert.convert_florence2(flat(fp), TTINY)
    got = tquant.quantize_florence_state(fp_state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert "language_model.shared.weight" in fp_state  # the input is not changed
    assert fp_state["language_model.decoder_layer0.fc1.weight"].dtype == torch.float32
    # the module the state is for: int8 decoder and head, float encoder and tower
    net = build_module(tflo.Florence2(TTINY, quant=True), got, None, torch.bfloat16, "cpu")
    lm = net.language_model
    assert not hasattr(lm, "shared") and lm.lm_head_kernel.dtype == torch.int8
    assert lm.lm_head_scale.shape == (TTINY.vocab_size,)
    for i in range(TTINY.decoder_layers):
        layer = getattr(lm, f"decoder_layer{i}")
        for m in (layer.self_attn.q_proj, layer.encoder_attn.v_proj, layer.fc1, layer.fc2):
            assert isinstance(m, tquant.QLinear) and m.weight.dtype == torch.int8
            assert m.compute_dtype == torch.bfloat16 and m.scale.dtype == torch.float32
    assert lm.encoder_layer0.fc1.weight.dtype == torch.bfloat16
    assert tquant.resident_bytes(net) < tquant.resident_bytes(
        build_module(tflo.Florence2(TTINY), fp_state, None, torch.bfloat16, "cpu"))


def test_int8_logits_match_jax(rng):
    """Teacher-forced logits of the int8 model, port against JAX, both in
    float32: 1e-4.  And the int8 model against the float one within
    tests/test_quant.py's bounds."""
    fp = _tiny_fp_vars()
    qv = _np_tree(jquant.quantize_florence_params(fp))
    px = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    prompt = np.array([[3, 4, 5], [6, 7, 1]], np.int32)
    dec = np.array([[2, 3], [2, 4]], np.int32)
    want = np.asarray(jax.jit(jflo.Florence2(dims=JTINY, dtype=jnp.float32, quant=True).apply)(
        qv, jnp.asarray(px), jnp.asarray(prompt), jnp.asarray(dec)))
    flat = convert.flatten_variables
    qnet = build_module(tflo.Florence2(TTINY, quant=True),
                        convert.convert_florence2(flat(qv), TTINY), None, torch.float32, "cpu")
    fnet = build_module(tflo.Florence2(TTINY), convert.convert_florence2(flat(fp), TTINY),
                        None, torch.float32, "cpu")
    args = (torch.from_numpy(px), torch.from_numpy(prompt).long(), torch.from_numpy(dec).long())
    with torch.no_grad():
        got, ref = qnet(*args).numpy(), fnet(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    denom = np.std(ref) + 1e-6
    assert np.max(np.abs(got - ref)) / denom < 0.35
    assert np.mean(np.abs(got - ref)) / denom < 0.05


@pytest.mark.skipif(not os.path.isfile(os.path.join(CAP_SYNTH, "dims.json")),
                    reason="shipped cap_synth checkpoint not present")
def test_int8_captions_on_cap_synth():
    """The shipped trained captioner, read by the JAX package's loader and
    carried across: port int8 captions equal JAX int8 captions exactly
    (both in float32) on build_dataset(24, seed=11), and equal the port's
    float captions in at least 95% of crops (tests/test_quant.py's gate)."""
    from omniparser_tpu.train.train_captioner import build_dataset

    crops_u8, _ = build_dataset(24, seed=11, cache=False)
    valid = np.ones(len(crops_u8), bool)
    jfp = jflo.FlorenceCaptioner.from_synth_checkpoint(CAP_SYNTH, JCaptionerConfig(batch_size=24))
    jq = jflo.FlorenceCaptioner(JCaptionerConfig(batch_size=24, quant="int8"), dims=jfp.dims,
                                params=jfp.params, tokenizer=jfp.tokenizer)
    jq.model = jflo.Florence2(dims=jfp.dims, dtype=jnp.float32, quant=True)
    want = jq.caption_crops(jnp.asarray(crops_u8, jnp.float32), valid)

    dims = tflo.FlorenceDims(**{f: getattr(jfp.dims, f)
                                for f in tflo.FlorenceDims.__dataclass_fields__})
    state = convert.convert_florence2(convert.flatten_variables(_np_tree(jfp.params)), dims)
    crops = torch.from_numpy(crops_u8.astype(np.float32))
    tq = tflo.FlorenceCaptioner(CaptionerConfig(batch_size=24, quant="int8", dtype="float32"),
                                dims, state, device="cpu")
    tf = tflo.FlorenceCaptioner(CaptionerConfig(batch_size=24, dtype="float32"), dims, state,
                                device="cpu")
    got = tq.caption_crops(crops, valid)
    ref = tf.caption_crops(crops, valid)
    assert got == want
    match = sum(a == b for a, b in zip(ref, got)) / len(ref)
    assert match >= 0.95, (match, list(zip(ref, got))[:6])
    assert tq.generate_calls == 1 and not hasattr(tq.model.language_model, "shared")


def test_bf16_captioner_keeps_the_float32_head():
    """In bfloat16 the JAX model still reads its tied table and its logits
    bias in float32 for the head (``h.astype(f32) @ embedding.T + bias``);
    the port keeps both float32 too, float and int8, and casts looked-up
    rows to bfloat16 as Flax's Embed does."""
    fp_state = convert.convert_florence2(convert.flatten_variables(_tiny_fp_vars()), TTINY)
    cfg = CaptionerConfig(dtype="bfloat16")
    fcap = tflo.FlorenceCaptioner(cfg, TTINY, fp_state, device="cpu")
    lm = fcap.model.language_model
    w32 = fp_state["language_model.shared.weight"]
    b32 = fp_state["language_model.final_logits_bias"]
    assert lm.shared.weight.dtype == torch.float32 and torch.equal(lm.lm_head(), w32.t())
    assert torch.equal(lm.final_logits_bias, b32)
    assert lm.decoder_layer0.fc1.weight.dtype == torch.bfloat16
    ids = torch.tensor([[3, 4, 5]])
    emb = lm.embed_tokens(ids)
    assert emb.dtype == torch.bfloat16 and torch.equal(emb, w32[ids].to(torch.bfloat16))
    h = torch.randn((2, 1, TTINY.d_model), generator=torch.Generator().manual_seed(0))
    h = h.to(torch.bfloat16)
    assert torch.equal(lm._logits(h), h.float() @ w32.t() + b32)
    qcap = tflo.FlorenceCaptioner(dataclasses.replace(cfg, quant="int8"), TTINY, fp_state,
                                  device="cpu")
    assert qcap.model.language_model.final_logits_bias.dtype == torch.float32
