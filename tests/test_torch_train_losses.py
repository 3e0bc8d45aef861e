"""The port's training pieces against the JAX package's, on the CPU in
float32 with numpy-seeded inputs: the losses (values and input gradients),
the optimiser (schedules, global-norm clip, one AdamW step), the flax-equal
BatchNorm and the flax-default initialiser."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omniparser_tpu.models import ocr as jocr
from omniparser_tpu.models import yolov8 as jyolo
from omniparser_tpu.train import losses as jl
from omniparser_tpu.train import ocr_losses as jol
from omniparser_tpu_torch.models import ocr as tocr
from omniparser_tpu_torch.models import yolov8 as tyolo
from omniparser_tpu_torch.train import losses as tl
from omniparser_tpu_torch.train import ocr_losses as tol
from omniparser_tpu_torch.train import optim
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.init import flax_init_

torch.set_num_threads(2)

# float32 on both sides; sums are taken in other orders
RTOL, ATOL = 1e-5, 1e-6
# gradients pass through more reductions than the values
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _boxes(rng, shape, lo=0.05, hi=0.6, wmin=0.02, wmax=0.3):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(wmin, wmax, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------- losses ------------------------------- #

def test_anchor_centers_match():
    jc, js = jl._anchor_centers(64)
    tc, ts = tl._anchor_centers(64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ciou_values_and_gradients_match(rng):
    pred, gt = _boxes(rng, (64,)), _boxes(rng, (64,))
    want, jgrad = jax.value_and_grad(lambda p: jl._ciou(p, gt).sum())(jnp.asarray(pred))
    p = _t(pred, True)
    got = tl._ciou(p, _t(gt)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _level_outputs(rng, b, imgsz, nc=1):
    """NHWC level outputs as the JAX YOLOv8 gives them."""
    return [(rng.normal(0, 1.5, (b, imgsz // s, imgsz // s, 4 * jl.REG_MAX)).astype(np.float32),
             rng.normal(0, 1.5, (b, imgsz // s, imgsz // s, nc)).astype(np.float32))
            for s in jl.STRIDES]


def test_detection_loss_values_and_gradients_match(rng):
    b, imgsz = 2, 64
    outs = _level_outputs(rng, b, imgsz)
    gtb = _boxes(rng, (b, 5), 0.0, 0.5, 0.1, 0.5)
    gtm = np.ones((b, 5), bool)
    gtm[1, 3:] = False

    def jloss(o):
        return jl.detection_loss(o, jnp.asarray(gtb), jnp.asarray(gtm), imgsz)

    want, jgrad = jax.value_and_grad(jloss)([tuple(map(jnp.asarray, o)) for o in outs])
    tout = [(_t(o[0].transpose(0, 3, 1, 2), True), _t(o[1].transpose(0, 3, 1, 2), True))
            for o in outs]
    got = tl.detection_loss(tout, _t(gtb), _t(gtm), imgsz)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for (tb, tc), (jb, jc) in zip(tout, jgrad):
        np.testing.assert_allclose(tb.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jb),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(tc.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jc),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_caption_loss_values_and_gradients_match(rng):
    logits = rng.normal(0, 2, (3, 6, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 6)).astype(np.int32)
    labels[0, 4:] = 1  # padding
    want, jgrad = jax.value_and_grad(lambda x: jl.caption_loss(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = _t(logits, True)
    got = tl.caption_loss(x, _t(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_balanced_bce_dice_loss_values_and_gradients_match(rng):
    prob = rng.uniform(0.01, 0.99, (2, 16, 16, 1)).astype(np.float32)
    target = (rng.random((2, 16, 16)) < 0.2).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda p: jol.balanced_bce_dice_loss(p, jnp.asarray(target)))(jnp.asarray(prob))
    p = _t(prob.transpose(0, 3, 1, 2), True)  # the port's detector gives [B,1,H,W]
    got = tol.balanced_bce_dice_loss(p, _t(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgrad),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_ctc_loss_values_and_gradients_match(rng):
    """Padded labels of several lengths (one empty) and repeated
    characters, which CTC must separate with a blank."""
    b, t, c, lmax = 4, 24, 12, 8
    logits = rng.normal(0, 2, (b, t, c)).astype(np.float32)
    labels = np.zeros((b, lmax), np.int32)
    labels[0, :5] = [3, 3, 4, 4, 4]
    labels[1, :8] = rng.integers(1, c, 8)
    labels[2, :2] = [7, 7]
    want, jgrad = jax.value_and_grad(lambda x: jol.ctc_loss(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = _t(logits, True)
    got = tol.ctc_loss(x, _t(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ------------------------------- optimiser ------------------------------- #

@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
def test_schedules_equal_optax_at_every_step(kind):
    # optax evaluates in float32, this port in float64: near the cosine's
    # end 1 + cos(...) cancels in float32, so the bound is relative to the
    # peak value
    n, peak = 40, 2e-3 if kind == "cosine" else 1e-3
    if kind == "cosine":
        want, got = (optax.cosine_decay_schedule(2e-3, n, alpha=0.05),
                     optim.cosine_decay_schedule(2e-3, n, alpha=0.05))
    else:
        want, got = (optax.warmup_cosine_decay_schedule(0.0, 1e-3, 7, n, 1e-5),
                     optim.warmup_cosine_decay_schedule(0.0, 1e-3, 7, n, 1e-5))
    for step in range(n + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-6 * peak)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_equals_optax(rng, max_norm):
    tree = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in tree], None)
    got = [torch.tensor(a) for a in tree]
    norm = optim.clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(want if max_norm > 10
                                                                    else tree)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_adamw_steps_equal_the_optax_chain(rng):
    """Three steps of clip(1.0) -> adamw(warmup-cosine, wd 1e-4) on a random
    tree (a parameter without a gradient included: optax still decays
    it), from the same gradients."""
    shapes = ((4, 3), (7,), (2, 3, 2))
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    sched = (0.0, 1e-2, 1, 10, 1e-4)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.warmup_cosine_decay_schedule(*sched), weight_decay=1e-4))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(p)) for p in params]
    opt = optim.AdamW(tp, optim.warmup_cosine_decay_schedule(*sched), weight_decay=1e-4,
                      clip_norm=1.0)
    for _ in range(3):
        grads = [rng.normal(0, 2, s).astype(np.float32) for s in shapes]
        grads[1][:] = 0.0  # the port's parameter gets no gradient at all
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        for p, g, i in zip(tp, grads, range(3)):
            if i != 1:
                p.grad = torch.tensor(g)
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    assert opt.count == 3


# ------------------------------- BatchNorm ------------------------------- #

def _bn_case(rng, jmod, tmod, x):
    """One train-mode forward of the same block on both sides; returns the
    port's block and flax's updated batch_stats."""
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # non-trivial running statistics to start from
    variables["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    y, mut = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    flat = convert.flatten_variables(variables)
    tmod.load_state_dict(convert.convert_variables(flat, tmod))
    tmod.train()
    got = tmod(torch.tensor(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y),
                               rtol=1e-4, atol=1e-5)
    return tmod, convert.flatten_variables(jax.tree.map(np.asarray, mut["batch_stats"]))


@pytest.mark.parametrize("family", ["yolov8", "ocr"])
def test_batchnorm_running_statistics_equal_flax_after_one_train_step(rng, family):
    """flax momentum (0.97 YOLOv8, 0.99 OCR) and the biased variance: a
    plain nn.BatchNorm2d (PyTorch momentum 0.1, unbiased running_var)
    fails this at batch 2 on 4x4 maps."""
    x = rng.normal(0.3, 1.2, (2, 4, 4, 6)).astype(np.float32)
    if family == "yolov8":
        jmod = jyolo.ConvBNAct(8, 3, dtype=jnp.float32)
        tmod = tyolo.ConvBNAct(6, 8, 3)
        bn = "bn"
    else:
        jmod = jocr._ConvBlock(8, 1, jnp.float32)
        tmod = tocr._ConvBlock(6, 8)
        bn = "BatchNorm_0"
    tmod, stats = _bn_case(rng, jmod, tmod, x)
    sd = tmod.state_dict()
    np.testing.assert_allclose(sd[f"{bn}.running_mean"].numpy(), stats[f"{bn}/mean"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sd[f"{bn}.running_var"].numpy(), stats[f"{bn}/var"],
                               rtol=1e-5, atol=1e-7)


# ------------------------------- flax_init_ ------------------------------- #

def check_flax_init(tmod, jax_variables, seed: int = 0):
    """``flax_init_`` of the port's module against flax's default init of
    the JAX module (`jax_variables`, same shapes): the same leaves; zeros
    and ones exact; each leaf of 256 values or more with a std within
    sampling error of flax's, and no value beyond flax's truncation.  The
    tests that build a family's JAX init call it (test_torch_train_step.py:
    YOLOv8 and Florence-2; test_torch_trainers.py: the OCR networks and the
    captioner)."""
    want = convert.flatten_variables(jax.tree.map(np.asarray, jax_variables))
    flax_init_(tmod, torch.Generator().manual_seed(seed))
    got = convert.unconvert_state(tmod.state_dict(), tmod)
    assert set(got) == set(want)
    checked = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.all(w == w.flat[0]):  # zeros and ones
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        if w.size < 256:
            continue
        # the std of n draws has a relative sampling error of about 1/sqrt(2n)
        # on each side: five of those plus 2% apart
        tol = 5.0 * np.sqrt(2.0 / (2 * w.size)) + 0.02
        assert abs(np.std(g) / np.std(w) - 1) < tol, (k, np.std(g), np.std(w))
        if w.size >= 1024:
            # lecun_normal is cut at 2 / 0.8796 = 2.27 of its std; 1024 plain
            # normal draws (embeddings, normal(0.02)) all stay below 2.45 of
            # theirs with probability 7e-5
            truncated = np.abs(w).max() < 2.45 * np.std(w)
            assert (np.abs(g).max() < 2.45 * np.std(g)) == truncated, k
            if truncated:
                assert np.abs(g).max() <= np.abs(w).max() * 1.06, k
        checked += 1
    return checked
