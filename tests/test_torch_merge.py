"""The fused merge kernel (csrc/overlap.cu, merge_masks_launch) replayed in
numpy, step for step as the card runs it, and held bit for bit against its
plain version `merge_masks_plain` on chip_smoke.MERGE_CASES, the cases the
card checks the kernel on; tests/test_torch_ops.py holds the plain version
against the JAX package's `merge_icons_and_ocr` on the same cases."""

import numpy as np
import pytest
import torch

from chip_smoke import MERGE_CASES
from omniparser_tpu_torch.ops import hopper_kernels
from omniparser_tpu_torch.ops.hopper_kernels import merge_masks, merge_masks_plain
from omniparser_tpu_torch.ops.overlap import merge_icons_and_ocr

torch.set_num_threads(2)

f32 = np.float32
_INSIDE = f32(0.80)
_EPS = f32(1e-6)
_ROWS, _ROW_WARPS = 2, 8  # MERGE_ROWS, MERGE_ROW_WARPS


def _area(b):
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def _inter(a, b):
    """a [4] against b [L,4] (or [L,4] against [4]), float32."""
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), f32(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), f32(0))
    return iw * ih


def _ffs(word):
    return (word & -word).bit_length()  # __ffs: 1-based lowest set bit, 0 if none


def _ballot(bits):
    return int(sum(1 << lane for lane in np.flatnonzero(bits)))


def _replay_merge_kernel(icons, icon_valid, ocr, ocr_valid, thr, rng):
    """merge_masks_kernel step for step: blocks of _ROWS rows, _ROW_WARPS
    warps a row dealt 32-wide chunks round-robin, in an order drawn from
    `rng` (the card's is unknown).  Suppression: a warp stops at its own
    hit or a sibling's flag, disjoint pairs skip the ratio.  Containment:
    each warp's a- and b-ballots into the row's words; k_stop from the first
    nonzero b-word's __ffs; absorb bits a & (k < k_stop) OR-ed into the
    block's words, the block's words into the launch's words, and the last
    block's ocr_keep."""
    n, m = len(icons), len(ocr)
    words = (m + 31) // 32
    thr = f32(thr)
    iarea, oarea = _area(icons), _area(ocr)
    icon_keep = np.zeros(n, bool)
    icon_sup = np.zeros(n, bool)
    absorb = np.zeros((n, m), bool)
    removed = np.zeros(words, np.uint64)
    blocks = (n + _ROWS - 1) // _ROWS if n else 1
    for blk in rng.permutation(blocks):
        s_removed = np.zeros(words, np.uint64)
        for i in range(blk * _ROWS, min(blk * _ROWS + _ROWS, n)):
            bi, ai = icons[i], iarea[i]
            flag = False
            if icon_valid[i]:
                # warp w takes chunks w, w + 8, ...; each round one of each warp
                chunks = [list(range(w, (n + 31) // 32, _ROW_WARPS)) for w in range(_ROW_WARPS)]
                for t in range(len(chunks[0])):
                    for w in rng.permutation(_ROW_WARPS):
                        if flag or t >= len(chunks[w]):  # a warp stops at the flag
                            continue
                        j = np.arange(chunks[w][t] * 32, min(chunks[w][t] * 32 + 32, n))
                        with np.errstate(divide="ignore", invalid="ignore"):
                            inter = _inter(bi, icons[j])
                            aj = iarea[j]
                            iou = inter / (((ai + aj) - inter) + _EPS)
                            both = (ai > 0) & (aj > 0)
                            ra = np.where(both, inter / ai, f32(0))
                            rb = np.where(both, inter / aj, f32(0))
                        live = (j != i) & icon_valid[j] & (ai > aj)
                        live &= ~((inter == 0) & (thr >= 0))  # the disjoint skip
                        hit = live & (np.maximum(iou, np.maximum(ra, rb)) > thr)
                        flag = bool(hit.any())  # __any_sync sets the row's flag
            passed = bool(icon_valid[i]) and not flag
            aw = np.zeros(words, np.int64)
            bw = np.zeros(words, np.int64)
            if passed:
                for c in range(words):
                    k = np.arange(c * 32, min(c * 32 + 32, m))
                    with np.errstate(divide="ignore", invalid="ignore"):
                        inter = _inter(ocr[k], bi)
                        a = ocr_valid[k] & (inter != 0) & (oarea[k] > 0) & (inter / oarea[k] > _INSIDE)
                        b = ocr_valid[k] & (inter != 0) & ~a & (ai > 0) & (inter / ai > _INSIDE)
                    aw[c], bw[c] = _ballot(a), _ballot(b)
            k_stop = m
            nonzero = np.flatnonzero(bw)
            if passed and len(nonzero):
                first = nonzero[0]
                k_stop = first * 32 + _ffs(int(bw[first])) - 1
            for c in range(words):
                k = np.arange(c * 32, min(c * 32 + 32, m))
                ab = passed & (((int(aw[c]) >> (k - c * 32)) & 1) == 1) & (k < k_stop)
                absorb[i, k] = ab
                s_removed[c] |= np.uint64(_ballot(ab))
            icon_sup[i] = flag
            icon_keep[i] = passed and k_stop == m
        removed |= s_removed
    bits = (removed[np.arange(m) >> 5] >> (np.arange(m) % 32).astype(np.uint64)) & np.uint64(1)
    ocr_keep = ocr_valid & (bits == 0)
    return icon_keep, ocr_keep, absorb, icon_sup


def _tensors(case):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in case]


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_merge_kernel_replay_matches_plain_bitwise(rng, name):
    icons, iv, ocr, ov = MERGE_CASES[name](rng)
    want = merge_masks_plain(*_tensors((icons, iv, ocr, ov)), 0.7)
    got = _replay_merge_kernel(icons, iv, ocr, ov, 0.7, rng)
    for g, w, what in zip(got, want, ("icon_keep", "ocr_keep", "absorb", "icon_suppressed")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=what)
    icon_keep, ocr_keep, absorb, sup = want
    # each case shows what it is named for
    if name == "kstop_0":
        assert not icon_keep.any() and not absorb.any()
    if name == "kstop_m":
        assert absorb[0, 39] and absorb[1, 3] and icon_keep.all()
    if name == "chains":
        assert absorb[:20, [2, 5, 31, 33, 35]].all() and icon_keep[:20].all()
        assert absorb[20].nonzero().flatten().tolist() == [1, 34, 36]
        assert absorb[21].nonzero().flatten().tolist() == [3]
        assert not icon_keep[20:].any()
    if name == "same_box":
        assert absorb[0].nonzero().flatten().tolist() == [1, 5] and icon_keep.all()
    if name == "ties_080":  # each OCR box inside its icon; no icon inside its OCR box
        assert icon_keep.all() and torch.equal(absorb, torch.eye(4, dtype=torch.bool))
    if name in ("all_invalid", "no_ocr_32"):
        assert not absorb.any() and not ocr_keep.any()
    if name == "512x256":
        assert absorb.any() and sup.any() and (~icon_keep & torch.from_numpy(iv) & ~sup).any()


@pytest.mark.parametrize("thr", [-0.1, 0.0])
def test_merge_kernel_replay_at_thresholds_without_the_disjoint_skip(rng, thr):
    """Below 0 a disjoint pair's ratio 0 passes the threshold, so the kernel
    must not skip it; at 0 it does not pass, and the skip holds."""
    icons, iv, ocr, ov = MERGE_CASES["zero_area"](rng)
    want = merge_masks_plain(*_tensors((icons, iv, ocr, ov)), thr)
    got = _replay_merge_kernel(icons, iv, ocr, ov, thr, rng)
    for g, w, what in zip(got, want, ("icon_keep", "ocr_keep", "absorb", "icon_suppressed")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=what)
    if thr < 0:
        assert want[3].sum() > 20  # every valid icon with a smaller one is suppressed


def test_merge_icons_and_ocr_takes_the_merge_wrapper(rng):
    """The port's merge is merge_masks: on CPU tensors its plain version,
    with no launch counted."""
    case = _tensors(MERGE_CASES["512x256"](rng))
    before = dict(hopper_kernels.launch_counts)
    got = merge_icons_and_ocr(*case, 0.7)
    want = merge_masks_plain(*case, 0.7)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(merge_masks(*case, 0.7), want))
    assert hopper_kernels.launch_counts == before


def test_merge_masks_at_zero_sizes(rng):
    """N = 0 gives what the plain version gives (every valid OCR box kept);
    M = 0 raises, on every device, as the plain version's argmax does."""
    icons, iv, ocr, ov = _tensors(MERGE_CASES["n0"](rng))
    keep, okeep, absorb, sup = merge_masks(icons, iv, ocr, ov, 0.7)
    assert keep.shape == (0,) and sup.shape == (0,) and absorb.shape == (0, 7)
    assert torch.equal(okeep, ov)
    with pytest.raises(ValueError):
        merge_masks(*_tensors((np.ones((3, 4), f32), np.ones(3, bool),
                               np.zeros((0, 4), f32), np.zeros(0, bool))), 0.7)
