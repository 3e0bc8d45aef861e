"""The port's three trainers against the JAX package's, on the CPU in
float32 at reduced widths: each trainer's loss-and-update steps from the
same weights on the same numpy-seeded batch (augmentation bypassed), the
augmentations, the data path (renders, crops, shrink maps), the captioner's
dataset, the flax-default init of the OCR networks and the captioner, and
checkpoints that the port's pipeline loads."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.models import ocr as jocr
from omniparser_tpu.train import losses as jl
from omniparser_tpu.train import ocr_losses as jol
from omniparser_tpu.train import synth_text as jst
from omniparser_tpu.train import train_captioner as jtc
from omniparser_tpu.train import train_ocr as jto
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models import ocr as tocr
from omniparser_tpu_torch.models import yolov8 as tyolo
from omniparser_tpu_torch.train import synth_text as tst
from omniparser_tpu_torch.train import train_captioner as ttc
from omniparser_tpu_torch.train import train_detector as ttd
from omniparser_tpu_torch.train import train_ocr as tto
from omniparser_tpu_torch.train.ocr_losses import balanced_bce_dice_loss, ctc_loss
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.checkpoints import (
    latest_step_dir, load_checkpoint, save_checkpoint)
from tests.test_torch_train_losses import check_flax_init
from tests.test_torch_train_step import IMGSZ as DET_IMGSZ
from tests.test_torch_train_step import _jax_det

torch.set_num_threads(2)

STEPS = 4  # each schedule's length; warm-up min(., STEPS // 2) = 2
F32 = torch.float32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(tmod, jvars):
    tmod.load_state_dict(convert.convert_variables(convert.flatten_variables(_np(jvars)), tmod))
    return tmod


def _jax_runner(tx, loss_for):
    """The JAX trainers' step without their augmentation: value_and_grad
    over the params, tx update, new batch_stats."""

    @jax.jit
    def step(params, stats, opt, x, y):
        (loss, new_stats), grads = jax.value_and_grad(loss_for, has_aux=True)(
            params, stats, x, y)
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), new_stats, opt, loss

    return step


def _compare(jvars, tmod, jlosses, tlosses, lr, steps):
    """The first step's loss (same weights) to 1e-5 relative.  After it,
    Adam's update lr * m / (sqrt(v) + eps) is about +-lr for any gradient
    well above eps, so a gradient near zero that the two sides' float32
    sums give opposite signs moves its element 2 * lr apart: later losses
    to 1e-3 relative, parameters within 2 * lr a step, at most 1% of the
    elements by more than 1e-5; batch_stats (the later steps' batches pass
    through those parameters) to 1e-3 relative or 1e-4 absolute."""
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tlosses[1:], jlosses[1:], rtol=1e-3)
    want = convert.flatten_variables(_np(jvars))
    have = convert.unconvert_state(tmod.state_dict(), tmod)
    assert set(have) == set(want)
    flips = total = 0
    for k, w in want.items():
        diff = np.abs(have[k] - w)
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(have[k], w, rtol=1e-3, atol=1e-4, err_msg=k)
            continue
        assert diff.max() <= 2 * lr * steps + 1e-5, (k, diff.max())
        flips += int((diff > 1e-5).sum())
        total += w.size
    assert flips <= 0.01 * total, (flips, total)


# ------------------------------- detector ------------------------------- #

def test_detector_trainer_step_equals_jax():
    """One step of the icon-detector trainer's chain (clip 5 ->
    adamw(cosine 2e-3, alpha 0.05), wd 1e-4) at imgsz 64, from flax's
    default init of the JAX YOLOv8 (shared with test_torch_train_step).
    One step: at this learning rate the sign flips of the first update
    (see _compare) move the deep head's batch statistics of a second step
    by more than 1e-4."""
    det, jvars = _jax_det()
    lr, n = 2e-3, 1
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adamw(optax.cosine_decay_schedule(lr, STEPS, alpha=0.05),
                                 weight_decay=1e-4))
    module = det.module

    def loss_for(p, stats, x, y):
        outs, mut = module.apply({"params": p, "batch_stats": stats}, x, train=True,
                                 mutable=["batch_stats"])
        return jl.detection_loss(outs, y[0], y[1], DET_IMGSZ), mut["batch_stats"]

    jstep = _jax_runner(tx, loss_for)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (n, 2, DET_IMGSZ, DET_IMGSZ, 3), dtype=np.uint8)
    xy = rng.uniform(0.05, 0.5, (n, 2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.1, 0.4, (n, 2, 6, 2))], -1).astype(np.float32)
    mask = rng.random((n, 2, 6)) < 0.8
    params, stats = jvars["params"], jvars["batch_stats"]
    opt = tx.init(params)
    jlosses = []
    for i in range(n):
        params, stats, opt, loss = jstep(params, stats, opt, jnp.asarray(imgs[i]) / 255.0,
                                         (jnp.asarray(boxes[i]), jnp.asarray(mask[i])))
        jlosses.append(float(loss))
    tmod = _load(tyolo.YOLOv8(), jvars)
    tmod, topt = ttd.make_detector_trainer(STEPS, 0, lr, "cpu", module=tmod)
    tlosses = [ttd.detector_step(tmod, topt, torch.from_numpy(imgs[i]),
                                 torch.from_numpy(boxes[i]), torch.from_numpy(mask[i]), None,
                                 F32, DET_IMGSZ).item() for i in range(n)]
    _compare({"params": params, "batch_stats": stats}, tmod, jlosses, tlosses, lr, n)


@pytest.mark.parametrize("which", ["detector", "ocr"])
def test_augment_is_deterministic_in_range_and_shaped(which):
    mod = ttd if which == "detector" else tto
    x = torch.rand((3, 8, 10, 3), generator=torch.Generator().manual_seed(0))
    a = mod._augment(torch.Generator().manual_seed(7), x)
    b = mod._augment(torch.Generator().manual_seed(7), x)
    c = mod._augment(torch.Generator().manual_seed(8), x)
    assert a.shape == x.shape and a.dtype == x.dtype
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    d = mod.augment_draws(torch.Generator().manual_seed(7), x.shape)
    assert torch.equal(mod.apply_augment(x, d), a)


# ------------------------------- OCR ------------------------------- #

@functools.lru_cache(maxsize=None)
def _jax_ocr(kind: str):
    """A reduced JAX OCR network (float32), flax's default init."""
    if kind == "rec":
        mod = jocr.TextRecognizer(width=16, layers=1, heads=2, dtype=jnp.float32)
        x = jnp.zeros((1, 32, 64, 3))
    else:
        mod = jocr.TextDetector(width=8, dtype=jnp.float32)
        x = jnp.zeros((1, 64, 64, 3))
    return mod, _np(jax.jit(lambda k, x: mod.init(k, x))(jax.random.PRNGKey(1), x))


@pytest.mark.parametrize("kind", ["rec", "det"])
def test_ocr_trainer_steps_equal_jax(kind):
    """Three steps of the OCR trainer's chain (clip 1 -> adamw(warmup-cosine
    from 0), wd 1e-4): step 0 at learning rate 0, then the warm-up."""
    jmod, jvars = _jax_ocr(kind)
    rng = np.random.default_rng(11)
    n, lr = 3, (1e-3 if kind == "rec" else 5e-4)
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, STEPS // 2, STEPS, lr * 0.01)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))
    if kind == "rec":
        xs = rng.integers(0, 256, (n, 4, 32, 64, 3), dtype=np.uint8)
        ys = np.zeros((n, 4, 8), np.int32)
        for i in range(n):
            for j in range(4):
                k = int(rng.integers(0, 9))
                ys[i, j, :k] = rng.integers(1, jocr.NUM_CLASSES, k)
        jloss, tloss = jol.ctc_loss, ctc_loss
        tmod = _load(tocr.TextRecognizer(16, 1, 2, seq_len=16), jvars)
        tmod, topt = tto.make_recognizer_trainer(STEPS, 0, lr, "cpu", module=tmod)
    else:
        xs = rng.integers(0, 256, (n, 2, 64, 64, 3), dtype=np.uint8)
        ys = (rng.random((n, 2, 32, 32)) < 0.15).astype(np.uint8)
        jloss, tloss = jol.balanced_bce_dice_loss, balanced_bce_dice_loss
        tmod = _load(tocr.TextDetector(8), jvars)
        tmod, topt = tto.make_text_detector_trainer(STEPS, 0, lr, "cpu", module=tmod)

    def loss_for(p, stats, x, y):
        out, mut = jmod.apply({"params": p, "batch_stats": stats}, x, train=True,
                              mutable=["batch_stats"])
        return jloss(out, y), mut["batch_stats"]

    jstep = _jax_runner(tx, loss_for)
    params, stats = jvars["params"], jvars["batch_stats"]
    opt = tx.init(params)
    jlosses, tlosses = [], []
    for i in range(n):
        x = xs[i].astype(np.float32) / 255.0
        y = ys[i].astype(np.float32) if kind == "det" else ys[i]
        params, stats, opt, loss = jstep(params, stats, opt, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(loss))
        tlosses.append(tto.ocr_step(tmod, topt, tloss, torch.from_numpy(x),
                                    torch.from_numpy(y).long() if kind == "rec"
                                    else torch.from_numpy(y), None, F32).item())
    _compare({"params": params, "batch_stats": stats}, tmod, jlosses, tlosses, lr, n)


@pytest.mark.parametrize("kind", ["rec", "det"])
def test_flax_init_matches_flax_default_init_ocr(kind):
    jmod, jvars = _jax_ocr(kind)
    tmod = tocr.TextRecognizer(16, 1, 2, seq_len=16) if kind == "rec" else tocr.TextDetector(8)
    assert check_flax_init(tmod, jvars) >= 5


# ------------------------------- captioner ------------------------------- #

# the JAX make_train_state's tiny Florence-2 with a vocabulary that holds
# the fallback tokenizer's ASCII ids
CAP_DIMS = dict(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
                depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=1,
                decoder_layers=1, attn_heads=4, ffn_dim=64, vocab_size=160, max_positions=64)


@functools.lru_cache(maxsize=None)
def _jax_captioner():
    model = jflo.Florence2(dims=jflo.FlorenceDims(**CAP_DIMS), dtype=jnp.float32)
    tok = jtc.load_tokenizer(None)
    prompt = np.asarray(tok.encode(jflo.TASK_PROMPTS["<CAPTION>"]), np.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)),
                                    jnp.zeros((1, len(prompt)), jnp.int32),
                                    jnp.zeros((1, jtc.MAX_T), jnp.int32))
    return model, _np(variables), prompt, jtc.caption_tokens(tok)


def test_captioner_trainer_steps_equal_jax():
    """Three steps of the captioner trainer (label smoothing 0.1, clip 1 ->
    adamw(warmup-cosine), wd 1e-4) at the tiny dims on 32x32 crops; the
    JAX loss is the trainer's own formula."""
    model, jvars, prompt, (dec_in_k, labels_k, mask_k) = _jax_captioner()
    lr, n, b = 3e-4, 3, 4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, STEPS // 2, STEPS, lr * 0.01)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))
    mean, std = jnp.asarray([0.485, 0.456, 0.406]), jnp.asarray([0.229, 0.224, 0.225])
    prompt_dev = jnp.asarray(np.tile(prompt[None], (b, 1)))

    def loss_for(p, _stats, x, kind_ids):  # train_captioner.py's loss_for
        logits = model.apply({"params": p}, (x - mean) / std, prompt_dev,
                             jnp.asarray(dec_in_k)[kind_ids])
        labels, mask = jnp.asarray(labels_k)[kind_ids], jnp.asarray(mask_k)[kind_ids]
        eps, v = 0.1, logits.shape[-1]
        logp = jax.nn.log_softmax(logits)
        smoothed = jax.nn.one_hot(labels, v, dtype=logp.dtype) * (1.0 - eps) + eps / v
        ce = -(smoothed * logp).sum(-1)
        return (ce * mask).sum() / mask.sum(), _stats

    jstep = _jax_runner(tx, loss_for)
    rng = np.random.default_rng(13)
    xs = rng.integers(0, 256, (n, b, 32, 32, 3), dtype=np.uint8)
    kinds = rng.integers(0, len(dec_in_k), (n, b)).astype(np.int32)
    params, opt = jvars["params"], tx.init(jvars["params"])
    tmod = _load(tflo.Florence2(tflo.FlorenceDims(**CAP_DIMS)), jvars)
    tmod, topt = ttc.make_captioner_trainer(STEPS, 0, lr, "cpu", module=tmod)
    tables = ttc.CaptionTables("cpu")
    np.testing.assert_array_equal(tables.prompt.numpy(), prompt)
    np.testing.assert_array_equal(tables.labels.numpy(), labels_k)
    jlosses, tlosses = [], []
    for i in range(n):
        x = xs[i].astype(np.float32) / 255.0
        params, _, opt, loss = jstep(params, 0, opt, jnp.asarray(x), jnp.asarray(kinds[i]))
        jlosses.append(float(loss))
        tlosses.append(ttc.captioner_step(tmod, topt, tables, torch.from_numpy(x),
                                          torch.from_numpy(kinds[i]).long(), None, F32).item())
    _compare({"params": params}, tmod, jlosses, tlosses, lr, n)


def test_flax_init_matches_flax_default_init_captioner():
    _, jvars, _, _ = _jax_captioner()
    assert check_flax_init(tflo.Florence2(tflo.FlorenceDims(**CAP_DIMS)), jvars) >= 10


def test_train_captioner_tail_average_and_loss(monkeypatch):
    """train_captioner on given arrays at reduced dims: finite losses to
    ``on_step`` every step, and the returned parameters the mean of the
    chunk snapshots of the run's last 30%."""
    monkeypatch.setattr(ttc, "SYNTH_CAP_DIMS", tflo.FlorenceDims(**CAP_DIMS))
    rng = np.random.default_rng(17)
    crops = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    kinds = rng.integers(0, 33, 8).astype(np.int32)
    seen, snaps = [], []
    real_run = ttc.run_logged

    def run_recording(run_chunk, steps, log_every, tag, after_chunk=None):
        def after(done):
            after_chunk(done)
            snaps.append(len(seen))
        return real_run(run_chunk, steps, log_every, tag, after)

    monkeypatch.setattr(ttc, "run_logged", run_recording)
    model = ttc.train_captioner(steps=10, batch=4, seed=1, log_every=1, tail_avg=0.3,
                                device="cpu", dtype=F32, data=(crops, kinds),
                                on_step=lambda s, loss: seen.append(float(loss)))
    assert len(seen) == 10 and np.all(np.isfinite(seen)) and snaps[-1] == 10
    assert not model.training


# ------------------------------- data path ------------------------------- #

def test_shrink_map_bit_equal(rng):
    boxes = [[int(a), int(b), int(a + w), int(b + h)]
             for a, b, w, h in zip(rng.integers(0, 600, 40), rng.integers(0, 600, 40),
                                   rng.integers(-2, 120, 40), rng.integers(-2, 30, 40))]
    np.testing.assert_array_equal(tst.shrink_map(boxes, 640), jst.shrink_map(boxes, 640))


@functools.lru_cache(maxsize=None)
def _line_buffers():
    return (tst.render_line_buffers(np.random.default_rng(21), 6, 56),
            jst.render_line_buffers(np.random.default_rng(21), 6, 56))


def test_render_line_buffers_bit_equal():
    got, want = _line_buffers()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def test_crops_from_buffers_within_one_grey_level():
    (bufs, hws, _, _), _ = _line_buffers()
    got = tst.crops_from_buffers(bufs, hws, tto.REC_HW, device="cpu")
    want = jst.crops_from_buffers(bufs, hws, jto.REC_HW)
    assert got.shape == want.shape == (6, 32, 480, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_captioner_build_dataset_matches_jax():
    """n = 8 tiles from one seed: the same kinds, crops within 1 grey
    level (the port's plain crop against XLA's; a float a hair either side
    of an integer truncates to neighbours)."""
    crops, kinds = ttc.build_dataset(8, 31, cache=False, device="cpu")
    jcrops, jkinds = jtc.build_dataset(8, 31, cache=False)
    np.testing.assert_array_equal(kinds, jkinds)
    assert crops.shape == jcrops.shape == (8, 64, 64, 3)
    assert np.abs(crops.astype(int) - jcrops.astype(int)).max() <= 1


# ------------------------------- checkpoints ------------------------------- #

def test_unconvert_state_round_trips_each_trained_family():
    """convert_variables(unconvert_state(s)) == s exactly."""
    g = torch.Generator().manual_seed(4)
    for mod in (tyolo.YOLOv8(), tocr.TextDetector(8), tocr.TextRecognizer(16, 1, 2, 16),
                tflo.Florence2(tflo.FlorenceDims(**CAP_DIMS))):
        from omniparser_tpu_torch.weights.init import seeded_init_

        seeded_init_(mod, g)
        for m in mod.modules():  # non-trivial running statistics
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-1, 1, generator=g)
                m.running_var.uniform_(0.5, 2, generator=g)
        sd = {k: v for k, v in mod.state_dict().items() if not k.endswith("num_batches_tracked")}
        back = convert.convert_variables(convert.unconvert_state(sd, mod), mod)
        assert set(back) == set(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), (type(mod).__name__, k)


def test_save_checkpoint_loads_bit_equal_into_the_pipeline(tmp_path):
    """Trained-shape networks saved through weights/checkpoints.py load
    through SOMPipeline's weight fields (float32) bit-equal; the captioner's
    dims travel in __dims__; step files and latest_step_dir."""
    from omniparser_tpu_torch.config import (
        CaptionerConfig, DetectorConfig, OcrConfig, PipelineConfig)
    from omniparser_tpu_torch.pipeline import SOMPipeline
    from omniparser_tpu_torch.weights.init import flax_init_

    g = torch.Generator().manual_seed(9)
    det = flax_init_(tyolo.YOLOv8(), g)
    tdet, rec = flax_init_(tocr.TextDetector(), g), flax_init_(tocr.TextRecognizer(), g)
    dims = tflo.FlorenceDims(**{**CAP_DIMS, "vocab_size": 16512})
    cap = flax_init_(tflo.Florence2(dims), g)
    for m in (det, tdet, rec):  # one train step's worth of running statistics
        m.train()
    det(torch.rand((2, 3, 64, 64), generator=g))
    tdet(torch.rand((2, 3, 64, 64), generator=g))
    rec(torch.rand((2, 3, 32, 480), generator=g))
    p_det = save_checkpoint(str(tmp_path / "det_synth"), {"det": det})
    p_ocr = save_checkpoint(str(tmp_path / "ocr.npz"), {"det": tdet, "rec": rec})
    p_cap = save_checkpoint(str(tmp_path / "ckpt"), {"cap": cap}, step=7, dims=dims)
    assert latest_step_dir(str(tmp_path / "ckpt")) == p_cap and p_det.endswith(".npz")
    assert set(load_checkpoint(p_ocr)) == {"det", "rec"}
    cfg = PipelineConfig(detector=DetectorConfig(dtype="float32"),
                         ocr=OcrConfig(dtype="float32"), captioner=CaptionerConfig(dtype="float32"),
                         detector_weights=p_det, ocr_weights=p_ocr, captioner_weights=p_cap)
    pipe = SOMPipeline(cfg, device="cpu")
    assert pipe.captioner.dims == dims
    for got, want in ((pipe.det_module, det), (pipe.ocr.det, tdet), (pipe.ocr.rec, rec),
                      (pipe.captioner.model, cap)):
        sg = got.state_dict()
        for k, v in want.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(sg[k], v), (type(want).__name__, k)
