"""The port's joint train step against the JAX package's: one step of
YOLOv8-n at imgsz 64 plus the JAX default tiny Florence-2, from the same
weights (carried through ``weights/convert.py``) on the same numpy-seeded
batch, both sides in float32 on the CPU; and the flax-default initialiser
of both families against flax's own init."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models import yolov8 as tyolo
from omniparser_tpu_torch.weights import convert
from tests.test_torch_train_losses import check_flax_init

# the packages export a function of the module's name: take the modules
jts = importlib.import_module("omniparser_tpu.train.train_step")
tts = importlib.import_module("omniparser_tpu_torch.train.train_step")

torch.set_num_threads(2)

IMGSZ = 64
LR = 1e-3
# JAX make_train_state's default captioner dims
JDIMS = jflo.FlorenceDims(
    embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
    depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=2,
    decoder_layers=2, attn_heads=4, ffn_dim=64, vocab_size=128, max_positions=64)


class F32Detector(jyolo.Detector):
    """The JAX detector with a float32 module (its own builds bfloat16)."""

    @property
    def module(self):
        return jyolo.YOLOv8(variant=self.variant, num_classes=self.num_classes,
                            dtype=jnp.float32)


def _keys():
    return jax.random.split(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_det():
    """The JAX detector with a float32 module and its flax-default
    variables (one jitted init), apart from the captioner's so that a
    process that needs only the detector compiles only its init."""
    det = F32Detector(variant="n", num_classes=1, imgsz=IMGSZ)
    return det, jax.tree.map(np.asarray, det.init_params(_keys()[0]))


@functools.lru_cache(maxsize=None)
def _jax_cap():
    """The float32 JAX Florence-2 at JDIMS and its flax-default variables."""
    flo = jflo.Florence2(dims=JDIMS, dtype=jnp.float32)
    cap_vars = jax.jit(flo.init)(_keys()[1], jnp.zeros((1, 32, 32, 3)),
                                 jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 3), jnp.int32))
    return flo, jax.tree.map(np.asarray, cap_vars)


@functools.lru_cache(maxsize=None)
def _jax_state():
    """The JAX TrainState over both, and its jitted step."""
    (det, det_vars), (flo, cap_vars) = _jax_det(), _jax_cap()
    params = {"det": det_vars, "cap": cap_vars}
    tx = optax.adamw(LR)
    state = jts.TrainState(det, flo, params, tx.init(jts._trainable(params)), tx, IMGSZ)

    @jax.jit
    def step(params, opt_state, batch):
        return jts.train_step(dataclasses.replace(state, params=params, opt_state=opt_state),
                              batch)

    return state, step


def _batch(seed: int = 0, b: int = 2):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 0.6, (b, 8, 2))
    wh = rng.uniform(0.1, 0.35, (b, 8, 2))
    return {
        "images": rng.uniform(0, 1, (b, IMGSZ, IMGSZ, 3)).astype(np.float32),
        "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
        "gt_mask": np.ones((b, 8), bool),
        "crops": rng.uniform(0, 1, (b, 32, 32, 3)).astype(np.float32),
        "prompt_ids": rng.integers(4, 100, (b, 4)).astype(np.int32),
        "caption_ids": rng.integers(4, 100, (b, 6)).astype(np.int32),
    }


def _port_state(jparams):
    st = tts.make_train_state(imgsz=IMGSZ, florence_dims=tflo.FlorenceDims(
        **dataclasses.asdict(JDIMS)), learning_rate=LR, device="cpu", dtype=torch.float32)
    st.det_module.load_state_dict(convert.convert_variables(
        convert.flatten_variables(jparams["det"]), st.det_module))
    st.florence.load_state_dict(convert.convert_variables(
        convert.flatten_variables(jparams["cap"]), st.florence))
    return st


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for k, v in batch.items()}


def test_one_joint_train_step_equals_jax():
    """loss, det_loss and cap_loss to 1e-5 relative; updated parameters and
    batch_stats to 1e-5 absolute, except where Adam's first update
    lr * g / (|g| + eps) meets a gradient near zero: the two sides' float32
    sums may give it either sign, so such an element may differ by up to
    2 * lr; at most 1% of the elements may."""
    state, jstep = _jax_state()
    batch = _batch()
    new_params, _, metrics = jstep(state.params, state.opt_state,
                                   jax.tree.map(jnp.asarray, batch))
    st = _port_state(state.params)
    got = tts.train_step(st, _torch_batch(batch))
    for k in ("loss", "det_loss", "cap_loss"):
        np.testing.assert_allclose(got[k].item(), float(metrics[k]), rtol=1e-5, err_msg=k)
    for fam, mod in (("det", st.det_module), ("cap", st.florence)):
        want = convert.flatten_variables(jax.tree.map(np.asarray, new_params[fam]))
        have = convert.unconvert_state(mod.state_dict(), mod)
        assert set(have) == set(want)
        flips = total = 0
        for k, w in want.items():
            diff = np.abs(have[k] - w)
            if k.startswith("batch_stats/"):
                np.testing.assert_allclose(have[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
                continue
            assert diff.max() <= 2 * LR + 1e-6, (k, diff.max())
            flips += int((diff > 1e-5).sum())
            total += w.size
        assert flips <= 0.01 * total, (fam, flips, total)


def test_loss_falls_over_five_steps_and_stats_move():
    """As tests/test_train.py::test_detection_loss_decreases_with_training
    asserts for the JAX step: five steps on one batch lower the loss; the
    detector's running statistics leave their initial values."""
    st = tts.make_train_state(imgsz=IMGSZ, learning_rate=LR, device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(1))
    batch = _torch_batch(_batch(3))
    before = st.det_module.stem.bn.running_var.clone()
    losses = [tts.train_step(st, batch)["loss"].item() for _ in range(5)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert not torch.equal(before, st.det_module.stem.bn.running_var)


def test_synthetic_batch_and_fast_init():
    g = torch.Generator().manual_seed(0)
    b = tts.make_synthetic_batch(g, 2, IMGSZ)
    assert b["images"].shape == (2, IMGSZ, IMGSZ, 3) and b["crops"].shape == (2, 32, 32, 3)
    assert float(b["images"].min()) >= 0 and float(b["images"].max()) <= 1
    assert bool((b["gt_boxes"][..., 2:] > b["gt_boxes"][..., :2]).all())
    assert int(b["prompt_ids"].min()) >= 4 and int(b["caption_ids"].max()) < 100
    again = tts.make_synthetic_batch(torch.Generator().manual_seed(0), 2, IMGSZ)
    assert all(torch.equal(b[k], again[k]) for k in b)
    st = tts.make_train_state(imgsz=IMGSZ, fast_init=True, device="cpu", dtype=torch.float32)
    assert float(st.det_module.stem.bn.running_var.min()) == 1.0
    assert np.isfinite(tts.train_step(st, b)["loss"].item())
    from omniparser_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="not a multiple of dp"):
        tts.make_sharded_train_step(st, make_mesh(["cpu"] * 4, dp=4))(b)


@pytest.mark.parametrize("family", ["yolov8", "florence2"])
def test_flax_init_matches_flax_default_init(family):
    if family == "yolov8":
        tmod, jv = tyolo.YOLOv8(), _jax_det()[1]
    else:
        tmod, jv = tflo.Florence2(tflo.FlorenceDims(**dataclasses.asdict(JDIMS))), _jax_cap()[1]
    assert check_flax_init(tmod, jv) >= 10
