"""The port's plain kernel versions vs the JAX package's Pallas kernels
(interpret mode on CPU) and XLA references.  Masks are compared exactly;
float maps within the stated tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from omniparser_tpu.ops.nms import _select_max_keep
from omniparser_tpu.ops.pallas_crop import pallas_crop_resize
from omniparser_tpu.ops.pallas_kernels import pallas_nms_keep, pallas_overlap_matrices
from omniparser_tpu.ops.preprocess import crop_resize_batch, pad_to_bucket
from omniparser_tpu_torch.ops import hopper_crop, hopper_kernels
from omniparser_tpu_torch.ops.hopper_crop import crop_resize, crop_resize_plain
from omniparser_tpu_torch.ops.hopper_kernels import (
    merge_masks,
    nms_keep,
    nms_keep_plain,
    overlap_matrices,
    overlap_matrices_plain,
)
from tests.conftest import random_boxes

# small shapes: more threads only contend with the other test workers
torch.set_num_threads(2)


def _sorted_case(rng, n, n_invalid=0, dup=0, zero=0):
    boxes = random_boxes(rng, n, max_size=0.5)
    if dup:
        boxes[n // 2: n // 2 + dup] = boxes[:dup]
    if zero:
        boxes[5: 5 + zero, 2] = boxes[5: 5 + zero, 0]
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    order = np.argsort(-scores, kind="stable")
    valid = np.ones(n, bool)
    if n_invalid:
        valid[n - n_invalid:] = False
    return boxes[order], valid


@pytest.mark.parametrize("n,thr", [(64, 0.3), (64, 0.1), (300, 0.3), (300, 0.5)])
def test_nms_keep_plain_matches_pallas_interpret(rng, n, thr):
    sboxes, svalid = _sorted_case(rng, n, n_invalid=n // 8, dup=3, zero=2)
    want = np.asarray(pallas_nms_keep(jnp.asarray(sboxes), jnp.asarray(svalid), thr,
                                      interpret=True))
    got = nms_keep_plain(torch.from_numpy(sboxes), torch.from_numpy(svalid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors (and counts no launch)
    before = dict(hopper_kernels.launch_counts)
    got2 = nms_keep(torch.from_numpy(sboxes), torch.from_numpy(svalid), thr).numpy()
    np.testing.assert_array_equal(got2, want)
    assert hopper_kernels.launch_counts == before


@pytest.mark.parametrize("n,max_out", [(64, 16), (300, 32), (300, 512)])
def test_nms_keep_plain_first_max_out_is_select_max_set(rng, n, max_out):
    """The full greedy mask cut to its first max_out survivors is the
    select-max loop's keep set."""
    sboxes, svalid = _sorted_case(rng, n, n_invalid=n // 10, dup=2)
    want = np.asarray(_select_max_keep(jnp.asarray(sboxes), jnp.asarray(svalid),
                                       0.3, max_out))
    full = nms_keep_plain(torch.from_numpy(sboxes), torch.from_numpy(svalid), 0.3).numpy()
    cut = full & (np.cumsum(full) <= max_out)
    np.testing.assert_array_equal(cut, want)


@pytest.mark.parametrize("n,m", [(48, 32), (20, 40)])
def test_overlap_matrices_plain_matches_pallas_interpret(rng, n, m):
    icons = random_boxes(rng, n, max_size=0.3)
    ocr = random_boxes(rng, m, max_size=0.15)
    # some OCR boxes well inside an icon, some icons well inside an OCR box
    c = (icons[:4, :2] + icons[:4, 2:]) / 2
    half = (icons[:4, 2:] - icons[:4, :2]) / 2
    ocr[:4] = np.concatenate([c - 0.5 * half, c + 0.5 * half], axis=1)
    ocr[4:6] = np.concatenate([c[:2] - 1.5 * half[:2], c[:2] + 1.5 * half[:2]], axis=1)
    r, a, b = pallas_overlap_matrices(jnp.asarray(icons), jnp.asarray(ocr), interpret=True)
    gr, ga, gb = overlap_matrices_plain(torch.from_numpy(icons), torch.from_numpy(ocr))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(a))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(b))
    assert ga.any() and gb.any()
    # ratio: same float32 formula, division rounding may differ in the last bit
    np.testing.assert_allclose(gr.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    before = dict(hopper_kernels.launch_counts)
    wr, wa, wb = overlap_matrices(torch.from_numpy(icons), torch.from_numpy(ocr))
    assert torch.equal(wa, ga) and torch.equal(wb, gb) and torch.equal(wr, gr)
    assert hopper_kernels.launch_counts == before


def test_overlap_matrices_plain_zero_area(rng):
    icons = np.array([[0.1, 0.1, 0.1, 0.5], [0.2, 0.2, 0.4, 0.4]], np.float32)
    ocr = np.array([[0.25, 0.25, 0.3, 0.3], [0.3, 0.3, 0.3, 0.35]], np.float32)
    r, a, b = pallas_overlap_matrices(jnp.asarray(icons), jnp.asarray(ocr), interpret=True)
    gr, ga, gb = overlap_matrices_plain(torch.from_numpy(icons), torch.from_numpy(ocr))
    assert np.isfinite(gr.numpy()).all()
    assert not ga.numpy()[0].any()  # a zero-area icon contains nothing
    np.testing.assert_array_equal(ga.numpy(), np.asarray(a))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(b))
    np.testing.assert_allclose(gr.numpy(), np.asarray(r), rtol=0, atol=1e-6)


_CROP_CASES = {
    "random": (100, 150, 128, 256, 32, [[0.1, 0.1, 0.5, 0.6], [0.0, 0.0, 0.3, 0.2],
                                        [0.55, 0.3, 0.95, 0.9], [0.2, 0.7, 0.9, 0.99]]),
    "edges": (64, 80, 64, 128, 16, [[0.0, 0.0, 1.0, 1.0], [0.9, 0.9, 1.0, 1.0],
                                    [0.0, 0.5, 0.05, 0.55]]),
    "upscale_small": (100, 100, 128, 128, 32, [[0.50, 0.50, 0.53, 0.53]]),
    "degenerate": (100, 100, 128, 128, 32, [[0.3, 0.3, 0.3, 0.3], [0.999, 0.999, 1.0, 1.0]]),
}


@pytest.mark.parametrize("case", sorted(_CROP_CASES))
def test_crop_resize_plain_matches_pallas_and_xla(rng, case):
    h, w, hb, wb, out, boxes = _CROP_CASES[case]
    boxes = np.asarray(boxes, np.float32)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    padded, _ = pad_to_bucket(img, hb, wb)
    hw = jnp.asarray([h, w], jnp.int32)
    want_xla = np.asarray(crop_resize_batch(jnp.asarray(padded), hw, jnp.asarray(boxes), out))
    got = crop_resize_plain(torch.from_numpy(padded), (h, w), torch.from_numpy(boxes), out)
    # same float32 sampling; the bound of tests/test_pallas_crop.py
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-4, atol=1e-2)
    if case != "degenerate":  # the Pallas kernel's fixtures have positive extent
        want_pl = np.asarray(pallas_crop_resize(jnp.asarray(padded), hw, jnp.asarray(boxes),
                                                out, interpret=True))
        np.testing.assert_allclose(got.numpy(), want_pl, rtol=1e-4, atol=1e-2)
    before = dict(hopper_crop.launch_counts)
    got2 = crop_resize(torch.from_numpy(padded), (h, w), torch.from_numpy(boxes), out)
    assert torch.equal(got2, got)
    assert hopper_crop.launch_counts == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    boxes = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        nms_keep(boxes, torch.ones(4, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError):
        nms_keep(torch.zeros((4, 4)), torch.ones(4, dtype=torch.int32), 0.5)
    with pytest.raises(ValueError):
        overlap_matrices(torch.zeros((4, 4)).t(), torch.zeros((2, 4)))
    icons, ocr = torch.zeros((4, 4)), torch.zeros((2, 4))
    iv, ov = torch.ones(4, dtype=torch.bool), torch.ones(2, dtype=torch.bool)
    for args in ((icons.double(), iv, ocr, ov),             # float64 boxes
                 (icons, iv, ocr.t().contiguous().t(), ov),  # boxes not contiguous
                 (icons, iv.int(), ocr, ov),                 # int32 valid flags
                 (icons, iv, ocr, ov[:1]),                   # valid of the wrong length
                 (icons, torch.ones(8, dtype=torch.bool)[::2], ocr, ov),  # flags not contiguous
                 (icons, iv, torch.zeros((0, 4)), ov[:0])):  # M = 0
        with pytest.raises(ValueError):
            merge_masks(*args, 0.7)
    with pytest.raises(ValueError):
        crop_resize(torch.zeros((8, 8, 3)), (8, 8), torch.zeros((1, 4)), 4)
    with pytest.raises(ValueError):
        crop_resize(torch.zeros((8, 8, 3), dtype=torch.uint8), (8, 8), torch.zeros((1, 4)), 4,
                    grid="nearest")


# ------------------------------------------------------------------ #
# The card kernels' designs replayed on the CPU
# ------------------------------------------------------------------ #

_BITS = np.uint64(1) << np.arange(64, dtype=np.uint64)


def _replay_nms_block_scan(over, svalid, stream_chunk=None):
    """csrc/nms.cu step by step, from the pair mask over = IoU > thr: the
    column-major, triangle-packed bitmask (column p holds rows 0 .. 64(p+1)
    at word 32*p*(p+1)), then the scan over 64-box blocks in order, skipping
    blocks without a valid box: OR the words of the kept rows below the
    block, read through the list of kept boxes, then resolve the block
    greedily on its diagonal words, every candidate that suppresses nothing
    kept in one step.  With stream_chunk None each column is one stage and
    the OR is split as the pipelined scan splits it; else the columns stream
    in stream_chunk-word tiles, each tile ORing the kept boxes of its own
    blocks, as the streaming scan does."""
    n = len(svalid)
    cb = -(-n // 64)
    rows = 64 * cb
    upper = np.zeros((rows, rows), bool)
    upper[:n, :n] = np.triu(over, 1)
    mask_t = np.zeros(32 * cb * (cb + 1), np.uint64)
    for p in range(cb):
        words = (upper[: 64 * (p + 1), 64 * p: 64 * (p + 1)].astype(np.uint64) * _BITS).sum(1)
        mask_t[32 * p * (p + 1): 32 * (p + 1) * (p + 2)] = words
    vb = np.zeros(rows, bool)
    vb[:n] = svalid
    vbits = [int(x) for x in (vb.reshape(cb, 64).astype(np.uint64) * _BITS).sum(1)]
    kbits = [0] * cb
    kcount = [0] * (cb + 1)     # kept boxes in the blocks before p
    klist = []                  # kept boxes in order
    for w in range(cb):
        kcount[w] = len(klist)
        if vbits[w] == 0:
            continue
        length = 64 * (w + 1)
        col_all = mask_t[32 * w * (w + 1): 32 * w * (w + 1) + length]
        acc = 0
        chunk = stream_chunk or length
        for lo in range(0, length, chunk):
            hi = min(lo + chunk, length)
            stage = col_all[lo:hi]                       # one bulk copy
            if stream_chunk is None:
                # one stage: P, the kept boxes of all but the last live
                # block before w (the helper warps' part), and Q, those of
                # the last one (warp 0's part)
                prev = max([p for p in range(w) if vbits[p]], default=None)
                kq = kcount[prev] if prev is not None else 0
                for part in (klist[:kq], klist[kq:]):
                    if part:
                        acc |= int(np.bitwise_or.reduce(stage[np.array(part)]))
            else:
                kb, ke = kcount[lo // 64], kcount[min(hi, 64 * w) // 64]
                if ke > kb:
                    acc |= int(np.bitwise_or.reduce(stage[np.array(klist[kb:ke]) - lo]))
            if hi == length:
                diag = [int(x) for x in stage[64 * w - lo: 64 * w - lo + 64]]
                nz = sum(1 << b for b in range(64) if diag[b])
                cand, kept = vbits[w] & ~acc, 0
                while cand:
                    sup = cand & nz
                    if not sup:
                        kept |= cand
                        break
                    b = (sup & -sup).bit_length() - 1
                    take = cand & ((2 << b) - 1)
                    kept |= take
                    cand &= ~(take | diag[b])
                kbits[w] = kept
                klist += [64 * w + b for b in range(64) if kept >> b & 1]
    return ((np.array(kbits, np.uint64)[:, None] & _BITS) != 0).reshape(-1)[:n]


def _nms_scan_case(rng, name):
    """The card cases of csrc/nms.cu's scan, at N <= 4096."""
    if name.startswith("n"):
        n = int(name[1:])
        boxes = random_boxes(rng, n, scale=200.0, max_size=0.2)
        boxes[n // 2: n // 2 + min(8, n // 2)] = boxes[: min(8, n // 2)]   # duplicates
        boxes[1: min(4, n), 2] = boxes[1: min(4, n), 0]                    # zero area
        valid = np.ones(n, bool)
        valid[rng.integers(0, n, n // 16)] = False
        valid[n - n // 10:] = False
        return boxes, valid
    if name == "all_kept":   # 4096 disjoint boxes on a grid
        g = np.arange(64, dtype=np.float32) * 10
        x, y = np.meshgrid(g, g)
        boxes = np.stack([x, y, x + 8, y + 8], -1).reshape(-1, 4).astype(np.float32)
        return boxes, np.ones(4096, bool)
    if name == "all_invalid":
        return random_boxes(rng, 300, scale=100.0), np.zeros(300, bool)
    # chain across block boundaries: A (63) suppresses B (64), B would have
    # suppressed C (128), so C is kept; the rest are far apart
    g = np.arange(300, dtype=np.float32) * 40 + 1000
    boxes = np.stack([g, g, g + 10, g + 10], -1).astype(np.float32)
    boxes[63] = [0, 0, 10, 10]
    boxes[64] = [5, 0, 15, 10]
    boxes[128] = [11, 0, 21, 10]
    return boxes, np.ones(300, bool)


_NMS_SCAN_CASES = ["n1", "n63", "n64", "n65", "n4000", "n4096", "all_kept", "all_invalid",
                   "chain"]


@pytest.mark.parametrize("name", _NMS_SCAN_CASES)
def test_nms_block_scan_replay_matches_plain(rng, name):
    boxes, valid = _nms_scan_case(rng, name)
    thr = 0.1
    want = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    over = (hopper_kernels.plain_pairwise_iou(torch.from_numpy(boxes)) > thr).numpy()
    # the pipelined scan, and the streaming scan at a tile small enough that
    # these columns span several tiles
    for stream_chunk in (None, 128):
        np.testing.assert_array_equal(_replay_nms_block_scan(over, valid, stream_chunk), want)
    if name == "all_kept":
        assert want.all()
    if name == "chain":
        assert want[63] and not want[64] and want[128]
    # the Pallas kernel in interpret mode at the two sizes its own tests
    # compile (64, 300), which keeps these cases cheap
    if len(valid) in (64, 300):
        pl = np.asarray(pallas_nms_keep(jnp.asarray(boxes), jnp.asarray(valid), thr,
                                        interpret=True))
        np.testing.assert_array_equal(want, pl)


def _u8f(b):
    """csrc/crop.cu's byte-to-float: the float32 with bits 0x4B000000 | b is
    2^23 + b exactly, less 2^23."""
    return (np.uint32(0x4B000000) | b.astype(np.uint32)).view(np.float32) - np.float32(2 ** 23)


def _replay_crop_kernel(padded, hw, boxes, out_hw, grid):
    """csrc/crop.cu step by step, with torch doing the float32 products:
    the box's scales divided once; per output column the taps (x0, xb, fx)
    and per output row (y0, yb, fy), the separable grid; each pixel's four
    taps as floats by the 2^23 trick; top and bottom along x, then along
    y."""
    f32 = np.float32
    img = padded.numpy()
    img_h, img_w = img.shape[:2]
    h, w = f32(hw[0]), f32(hw[1])
    out_h, out_w = out_hw
    out = torch.empty((boxes.shape[0], out_h, out_w, 3), dtype=torch.float32)
    cc, rr = np.arange(out_w, dtype=f32), np.arange(out_h, dtype=f32)
    half = f32(0.5)
    for i, bx in enumerate(boxes.numpy()):
        x1, y1 = np.trunc(bx[0] * w), np.trunc(bx[1] * h)
        cw = np.maximum(np.trunc(bx[2] * w) - x1, f32(1))
        ch = np.maximum(np.trunc(bx[3] * h) - y1, f32(1))
        sx, sy, off_y = cw / f32(out_w), ch / f32(out_h), f32(0)
        if grid == "line":
            sx = sy = np.maximum(sy, sx)
            off_y = (f32(out_h) - ch / sx) / f32(2)
        js = (cc + half) * sx - half
        is_ = ((rr - off_y) + half) * sy - half
        xs = np.clip(x1 + np.minimum(np.maximum(js, f32(0)), np.maximum(cw - f32(1), f32(0))),
                     f32(0), w - f32(1)).astype(f32)
        ys = np.clip(y1 + np.minimum(np.maximum(is_, f32(0)), np.maximum(ch - f32(1), f32(0))),
                     f32(0), h - f32(1)).astype(f32)
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, img_w - 1)
        xb = np.minimum(x0 + 1, img_w - 1)
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, img_h - 1)
        yb = np.minimum(y0 + 1, img_h - 1)
        fx = torch.from_numpy(xs - np.floor(xs))[None, :, None]
        fy = torch.from_numpy(ys - np.floor(ys))[:, None, None]
        tap = lambda yy, xx: torch.from_numpy(_u8f(img[yy[:, None], xx[None, :]]))
        top = tap(y0, x0) * (1 - fx) + tap(y0, xb) * fx
        bot = tap(yb, x0) * (1 - fx) + tap(yb, xb) * fx
        out[i] = top * (1 - fy) + bot * fy
    return out


def _chip_smoke_crop_boxes(rng, k):
    """Random boxes and the edge boxes of chip_smoke.crop_case."""
    xy = rng.uniform(0, 0.9, (k, 2))
    wh = rng.uniform(0.01, 0.1, (k, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], axis=1).astype(np.float32)
    boxes[:7] = [[0.0, 0.0, 1.0, 1.0], [0.97, 0.97, 1.0, 1.0], [0.0, 0.5, 0.02, 0.52],
                 [0.3, 0.3, 0.3, 0.3], [0.9995, 0.9995, 1.0, 1.0],
                 [0.5, 0.5, 0.5016, 0.5028], [0.25, 0.25, 0.2526, 0.2519]]
    return boxes


@pytest.mark.parametrize("frame,grid,out_hw", [
    ((1080, 1920, 1152, 1920), "resize", (64, 64)),     # caption crops
    ((1080, 1920, 1152, 1920), "line", (32, 480)),      # OCR line crops
    ((90, 150, 100, 150), "resize", (24, 20)),
    ((90, 150, 100, 150), "line", (8, 60)),
])
def test_crop_kernel_replay_matches_plain_bitwise(rng, frame, grid, out_hw):
    h, w, hb, wb = frame
    img = np.zeros((hb, wb, 3), np.uint8)
    img[:h, :w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    boxes = _chip_smoke_crop_boxes(rng, 24)
    if grid == "line":  # lines: wide, short boxes
        boxes[7:, 2] = np.minimum(boxes[7:, 0] + (boxes[7:, 2] - boxes[7:, 0]) * 4, 1.0)
    pt, bt = torch.from_numpy(img), torch.from_numpy(boxes)
    want = crop_resize_plain(pt, (h, w), bt, out_hw, grid)
    got = _replay_crop_kernel(pt, (h, w), bt, out_hw, grid)
    assert torch.equal(got, want)

