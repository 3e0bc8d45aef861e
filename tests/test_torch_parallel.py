"""The port's device mesh (``omniparser_tpu_torch/parallel/``) on the CPU: the
mesh and shardings, the tensor-parallel rule against the JAX package's
``shard_params_fsdp_tp``, gather-on-use, ``ShardedDetector``,
``ShardedCaptioner`` against the JAX package's, and the sharded train step
against ``train_step`` on the whole batch.  A mesh here repeats the CPU
(``['cpu'] * 8`` at dp = 4, tp = 2), as the JAX tests run eight virtual
CPU devices."""

import dataclasses
import functools
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu import config as jcfg
from omniparser_tpu.models import florence2 as jflo
from omniparser_tpu.parallel.mesh import make_mesh as jax_make_mesh
from omniparser_tpu.parallel.mesh import shard_params_fsdp_tp as jax_shard_params
from omniparser_tpu.parallel.sharded import ShardedCaptioner as JaxShardedCaptioner
from omniparser_tpu_torch import config as tcfg
from omniparser_tpu_torch.models import florence2 as tflo
from omniparser_tpu_torch.models.yolov8 import Detector
from omniparser_tpu_torch.ops.preprocess import pad_to_bucket
from omniparser_tpu_torch.parallel import batch_sharding, make_mesh, replicated
from omniparser_tpu_torch.parallel.mesh import shard_params_fsdp_tp, tp_leaves
from omniparser_tpu_torch.parallel.sharded import ShardedCaptioner, ShardedDetector
from omniparser_tpu_torch.weights import convert
from omniparser_tpu_torch.weights.init import build_module

tts = importlib.import_module("omniparser_tpu_torch.train.train_step")

torch.set_num_threads(2)

TINY = dict(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
            depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=2,
            decoder_layers=2, attn_heads=4, ffn_dim=64, vocab_size=160, max_positions=64)


def test_make_mesh_and_shardings():
    mesh = make_mesh(["cpu"] * 8, dp=4, tp=2)
    assert mesh.shape == {"dp": 4, "tp": 2} and mesh.devices.shape == (4, 2)
    assert make_mesh(["cpu"] * 6, tp=3).shape == {"dp": 2, "tp": 3}
    with pytest.raises(ValueError, match="3\\*2 != 8 devices"):
        make_mesh(["cpu"] * 8, dp=3, tp=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()  # no CPU default
    x = torch.arange(24.0).reshape(8, 3)
    parts = batch_sharding(mesh).shard(x.numpy())
    assert [p.shape[0] for p in parts] == [2] * 4 and torch.equal(parts[1], x[2:4])
    assert torch.equal(batch_sharding(mesh).gather(parts), x)
    with pytest.raises(ValueError, match="not a multiple of dp"):
        batch_sharding(mesh).shard(x[:6])
    rep = replicated(mesh).shard(x)
    assert len(rep) == 4 and all(r is rep[0] for r in rep)  # one copy per distinct device


def _leaf_key(path, arr):
    """A JAX variable path -> the port's parameter name (weights/convert.py)."""
    parts = path.split("/")[1:]
    leaf, _ = convert._convert_leaf(path, parts[-2] if len(parts) > 1 else "", parts[-1],
                                    arr, False)
    return ".".join(parts[:-1] + [leaf])


@functools.lru_cache(maxsize=None)
def _florence_shapes():
    """The JAX tiny Florence-2's parameter shapes (traced, not computed)."""
    return jax.eval_shape(jflo.Florence2(dims=jflo.FlorenceDims(**TINY)).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                          jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 1), jnp.int32))["params"]


@pytest.mark.parametrize("tp", [2, 3])
def test_shard_params_selects_the_jax_leaves(tp):
    """The same leaves of a tiny Florence-2 as the JAX rule, at tp = 2 and at
    tp = 3 (where many fail the divisibility check), compared through the
    converter's key map; min_size lowered so that the tiny widths select."""
    shapes = _florence_shapes()
    shardings = jax_shard_params(shapes, jax_make_mesh(jax.devices()[:tp], dp=1, tp=tp),
                                 min_size=2 ** 8)
    want = set()
    for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(shapes)[0],
                                jax.tree_util.tree_leaves(shardings)):
        if "tp" in tuple(sh.spec):
            jpath = "params/" + "/".join(k.key for k in path)
            want.add(_leaf_key(jpath, np.zeros(leaf.shape, np.float32)))
    with torch.device("meta"):
        module = tflo.Florence2(tflo.FlorenceDims(**TINY))
    got = tp_leaves(module, tp, min_size=2 ** 8)
    assert set(got) == want
    large = {n for n, p in module.named_parameters() if p.dim() >= 2 and p.numel() >= 2 ** 8}
    # tp = 2 splits every large leaf; at tp = 3 only DaViT's qkv (3c wide) divide
    assert len(want) == (len(large) if tp == 2 else 6) and len(large) >= 30


def test_gather_on_use_is_exact_and_trains():
    """A tiny Florence-2 split over tp = 2: the same logits bit for bit, the
    LM head reading the one split token table, and each shard's gradient
    the matching slice of the unsplit gradient."""
    dims = tflo.FlorenceDims(**TINY)
    a = build_module(tflo.Florence2(dims), None, torch.Generator().manual_seed(0),
                     torch.float32, "cpu")
    b = build_module(tflo.Florence2(dims), a.state_dict(), None, torch.float32, "cpu")
    leaves = shard_params_fsdp_tp(b, make_mesh(["cpu"] * 2, dp=1, tp=2), min_size=2 ** 8)
    assert "language_model.shared.weight" in leaves
    shared = b.language_model.shared
    assert hasattr(shared, "parametrizations") and "weight" not in shared._parameters
    g = torch.Generator().manual_seed(1)
    px = torch.rand((2, 32, 32, 3), generator=g)
    prompt = torch.randint(4, 100, (2, 4), generator=g)
    dec = torch.randint(4, 100, (2, 3), generator=g)
    la, lb = a(px, prompt, dec), b(px, prompt, dec)
    assert torch.equal(la, lb)
    la.square().sum().backward()
    lb.square().sum().backward()
    for name, dim in leaves.items():
        owner, _, leaf = name.rpartition(".")
        plist = b.get_submodule(owner).parametrizations[leaf]
        want = a.get_parameter(name).grad.chunk(2, dim)
        for i in range(2):
            torch.testing.assert_close(getattr(plist, f"original{i}").grad, want[i],
                                       rtol=0, atol=0)


def test_sharded_detector_matches_per_image_detect(rng):
    """dp = 4 over eight CPU entries: each row's forward over its images,
    then each image's NMS; validity equal to the per-image detect_graph at
    the same 512 bucket, boxes within 1e-5 (a batched float32 convolution
    may round differently from a single image's).  Then the dp padding and
    the not-a-multiple raise."""
    det = Detector(imgsz=128, max_det=16)
    module = build_module(det.make_module(), None, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    with torch.no_grad():
        for i in range(3):  # scores spread over (0, 1): no near-ties in the NMS order
            getattr(module.head, f"cls{i}_2").weight.mul_(20.0)
    mesh = make_mesh(["cpu"] * 8, dp=4, tp=2)
    sharded = ShardedDetector(det, mesh)
    images = [rng.integers(0, 255, (100, 120, 3), dtype=np.uint8) for _ in range(4)]
    boxes, scores, valid = sharded.detect_images(module, images, conf=0.3)
    assert boxes.shape == (4, 16, 4)
    for i, img in enumerate(images):
        padded, hw = pad_to_bucket(img, 512, 512)
        b1, s1, v1 = det.detect_graph(module, torch.from_numpy(padded), hw, 0.3, 0.1)
        np.testing.assert_array_equal(valid[i], v1.numpy())
        np.testing.assert_allclose(boxes[i][valid[i]], b1.numpy()[valid[i]], rtol=0, atol=1e-5)
    assert valid.sum() >= 8
    five = [rng.integers(0, 255, (64, 64, 3), dtype=np.uint8) for _ in range(5)]
    assert sharded.detect_images(module, five)[0].shape[0] == 5  # padded to 8 inside
    with pytest.raises(ValueError, match="multiple of dp"):
        sharded(module, np.zeros((3, 128, 128, 3), np.uint8), np.ones((3, 2), np.int32),
                0.05, 0.1)


def test_sharded_captioner_matches_jax_and_unsharded():
    """(4, 2): the port's ShardedCaptioner gives the JAX package's
    ShardedCaptioner's texts and the port's unsharded captioner's, on the
    same weights (float32; JAX tests/test_parallel.py's case)."""
    dims = tflo.FlorenceDims(**TINY)
    net = build_module(tflo.Florence2(dims), None, torch.Generator().manual_seed(1),
                       torch.float32, "cpu")
    with torch.no_grad():  # a wide token table: captions that differ between crops
        net.language_model.shared.weight.normal_(0, 1.0,
                                                 generator=torch.Generator().manual_seed(11))
    cc = dict(crop_size=32, max_new_tokens=4)
    cap = tflo.FlorenceCaptioner(tcfg.CaptionerConfig(dtype="float32", **cc), dims,
                                 net.state_dict(), device="cpu")
    flat = convert.unconvert_state(net.state_dict(), net)
    params = {"params": {}}
    for path, arr in flat.items():
        node = params
        for k in path.split("/")[:-1]:
            node = node.setdefault(k, {})
        node[path.rsplit("/", 1)[1]] = jnp.asarray(arr)
    jd = jflo.FlorenceDims(**TINY)
    jcap = jflo.FlorenceCaptioner(jcfg.CaptionerConfig(**cc), dims=jd, params=params)
    jcap.model = jflo.Florence2(dims=jd, dtype=jnp.float32)
    crops = np.random.default_rng(0).uniform(0, 255, (8, 32, 32, 3)).astype(np.float32)
    want = JaxShardedCaptioner(jcap, jax_make_mesh(dp=4, tp=2)).caption(crops)
    got = ShardedCaptioner(cap, make_mesh(["cpu"] * 8, dp=4, tp=2)).caption(crops)
    single = cap.caption_crops(torch.from_numpy(crops), np.ones(8, bool))
    assert got == want == single
    assert len(set(got)) >= 2
    assert "weight" in cap.model.language_model.shared._parameters  # the caller's stays whole


def test_sharded_train_step_matches_train_step():
    """(2, 2) over four CPU entries: two steps of the sharded step against
    train_step on the whole batch of 8, from the same state: losses within
    1e-5 relative, the BatchNorm running statistics after the first step
    within 1e-6 (global statistics, updated once), the captioner's large
    parameters split over tp."""
    # a 512-row token table: 2**14 elements, so JAX's rule splits it over tp
    dims = dataclasses.replace(tts.TINY_TRAIN_DIMS, vocab_size=512)

    def state():
        return tts.make_train_state(imgsz=64, florence_dims=dims, device="cpu",
                                    generator=torch.Generator().manual_seed(0),
                                    dtype=torch.float32)

    ref, sh = state(), state()
    step = tts.make_sharded_train_step(sh, make_mesh(["cpu"] * 4, dp=2, tp=2))
    assert hasattr(sh.florence.language_model.shared, "parametrizations")
    for i in range(2):
        batch = tts.make_synthetic_batch(torch.Generator().manual_seed(10 + i), 8, 64)
        want, got = tts.train_step(ref, batch), step(batch)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=0)
        if i == 0:
            mine = dict(sh.det_module.named_buffers())
            stats = [(n, t) for n, t in ref.det_module.named_buffers() if "running" in n]
            assert len(stats) >= 100
            for n, t in stats:
                torch.testing.assert_close(mine[n], t, rtol=0, atol=1e-6)
            assert int(mine["stem.bn.num_batches_tracked"]) == 1
