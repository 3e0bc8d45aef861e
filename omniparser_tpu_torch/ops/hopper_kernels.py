"""The suppression kernels: greedy NMS keep mask, the merge matrices and the
fused merge.

Each wrapper launches its hand-written CUDA kernel (``csrc/nms.cu``,
``csrc/overlap.cu``) for CUDA tensors and takes the plain PyTorch version
beside it for CPU tensors, and only for those: on a CUDA tensor it
launches or raises.  ``launch_counts`` rises by one where a kernel is
launched, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from omniparser_tpu_torch.ops import cuda_build
from omniparser_tpu_torch.ops.boxes import (
    box_area,
    containment_ratio,
    pairwise_intersection,
    pairwise_max_overlap_ratio,
)

_INSIDE_THRESHOLD = 0.80

launch_counts: Dict[str, int] = {"nms_keep": 0, "overlap_matrices": 0, "merge_masks": 0}

_MAX_NMS_N = 65536  # the scan keeps 2 words per 64-box block in shared memory


def _check_boxes(t: torch.Tensor, name: str) -> None:
    """float32 [N,4], contiguous, and 16-byte aligned on the card (the
    kernels read a box as one float4)."""
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 4:
        raise ValueError(f"{name}: want float32 [N,4], got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.is_cuda and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


# ------------------------------------------------------------------ #
# Greedy NMS
# ------------------------------------------------------------------ #


def plain_pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """Symmetric IoU without the containment ratios (torchvision semantics):
    0 where the union is 0."""
    inter = pairwise_intersection(boxes, boxes)
    area = box_area(boxes)
    union = area[:, None] + area[None, :] - inter
    one = torch.ones((), dtype=union.dtype, device=union.device)
    zero = torch.zeros((), dtype=union.dtype, device=union.device)
    return torch.where(union > 0, inter / torch.where(union == 0, one, union), zero)


def nms_keep_plain(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch greedy NMS keep mask over score-sorted boxes: if box i
    survives, every later box j with IoU(i, j) > threshold is dropped.
    Returns the FULL keep mask [N] bool."""
    n = sorted_boxes.shape[0]
    over = plain_pairwise_iou(sorted_boxes) > iou_threshold
    over = torch.triu(over, diagonal=1)  # only later boxes
    keep = sorted_valid.clone()
    for i in range(n):
        # no host read of keep[i]: the row is applied under its condition
        keep = keep & ~(over[i] & keep[i])
    return keep


# the pipelined scan keeps every bitmask column of N <= 4096 in one stage
NMS_FAST_MAX_N = 4096


def nms_entries(n: int, lib=None):
    """The two C entries of nms.cu that nms_keep launches for N boxes, typed:
    (mask launch, scan launch).  The scan is the pipelined one for
    N <= NMS_FAST_MAX_N and the streaming one above.  `lib` is another build
    of nms.cu to take them from (scripts/kernel_variants.py)."""
    lib = lib or cuda_build.load("nms.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    mask = lib.nms_mask_launch
    mask.argtypes, mask.restype = [vp, vp, i32, ctypes.c_float, vp], i32
    scan = lib.nms_scan_fast_launch if n <= NMS_FAST_MAX_N else lib.nms_scan_stream_launch
    scan.argtypes, scan.restype = [vp, vp, vp, i32, vp], i32
    return mask, scan


def nms_mask_words(n: int) -> int:
    """Length of the kernels' bitmask scratch: column p of the
    column-major, triangle-packed mask holds 64(p+1) words."""
    cb = (n + 63) // 64
    return 32 * cb * (cb + 1)


def nms_keep(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask for score-sorted boxes (exact torchvision
    semantics).  sorted_boxes [N,4] float32 descending by score,
    sorted_valid [N] bool.  Returns keep [N] bool, the full greedy mask.

    On the card two kernels of csrc/nms.cu: the bitmask, then the scan over
    64-box blocks, chosen by N: N <= 4096 (the main path's window) takes the
    pipelined scan, whose bitmask columns each fit one shared-memory stage;
    4096 < N <= 65536 takes the streaming scan, which reads each column in
    2048-word chunks."""
    _check_boxes(sorted_boxes, "sorted_boxes")
    n = sorted_boxes.shape[0]
    if sorted_valid.dtype != torch.bool or sorted_valid.shape != (n,):
        raise ValueError(f"sorted_valid: want bool [{n}], got "
                         f"{sorted_valid.dtype} {tuple(sorted_valid.shape)}")
    if sorted_valid.device != sorted_boxes.device or not sorted_valid.is_contiguous():
        raise ValueError("sorted_valid: must be contiguous and on the boxes' device")
    if not sorted_boxes.is_cuda:
        return nms_keep_plain(sorted_boxes, sorted_valid, float(iou_threshold))
    if not 0 < n <= _MAX_NMS_N:
        raise ValueError(f"nms_keep: N={n} outside (0, {_MAX_NMS_N}]")
    mask_fn, scan_fn = nms_entries(n)
    keep = torch.empty((n,), dtype=torch.bool, device=sorted_boxes.device)
    mask = torch.empty((nms_mask_words(n),), dtype=torch.int64, device=sorted_boxes.device)
    with torch.cuda.device(sorted_boxes.device):
        stream = cuda_build.current_stream()
        err = mask_fn(sorted_boxes.data_ptr(), mask.data_ptr(), n, float(iou_threshold), stream)
        if err == 0:
            err = scan_fn(sorted_valid.data_ptr(), keep.data_ptr(), mask.data_ptr(), n, stream)
    launch_counts["nms_keep"] += 1
    cuda_build.check(err, "nms_keep")
    return keep


# ------------------------------------------------------------------ #
# Merge matrices
# ------------------------------------------------------------------ #


def overlap_matrices_plain(icon_boxes: torch.Tensor, ocr_boxes: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch (ratio [N,N] f32, a [N,M] bool, b [N,M] bool):
    ratio = max-overlap ratio between icons; a[i,k]: OCR k sits more than
    0.80 inside icon i; b[i,k]: icon i sits more than 0.80 inside OCR k."""
    ratio = pairwise_max_overlap_ratio(icon_boxes, icon_boxes)
    a = containment_ratio(ocr_boxes, icon_boxes).T > _INSIDE_THRESHOLD
    b = containment_ratio(icon_boxes, ocr_boxes) > _INSIDE_THRESHOLD
    return ratio, a, b


def overlap_matrices(icon_boxes: torch.Tensor, ocr_boxes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch -> (ratio [N,N] f32, a [N,M] bool, b [N,M] bool)."""
    _check_boxes(icon_boxes, "icon_boxes")
    _check_boxes(ocr_boxes, "ocr_boxes")
    if icon_boxes.device != ocr_boxes.device:
        raise ValueError("icon_boxes and ocr_boxes must share a device")
    if not icon_boxes.is_cuda:
        return overlap_matrices_plain(icon_boxes, ocr_boxes)
    n, m = icon_boxes.shape[0], ocr_boxes.shape[0]
    lib = cuda_build.load("overlap.cu")
    fn = lib.overlap_matrices_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = icon_boxes.device
    ratio = torch.empty((n, n), dtype=torch.float32, device=dev)
    a = torch.empty((n, m), dtype=torch.bool, device=dev)
    b = torch.empty((n, m), dtype=torch.bool, device=dev)
    if n == 0:
        return ratio, a, b
    with torch.cuda.device(dev):
        err = fn(icon_boxes.data_ptr(), ocr_boxes.data_ptr(), ratio.data_ptr(),
                 a.data_ptr(), b.data_ptr(), n, m, cuda_build.current_stream())
    launch_counts["overlap_matrices"] += 1
    cuda_build.check(err, "overlap_matrices")
    return ratio, a, b


# ------------------------------------------------------------------ #
# The fused merge
# ------------------------------------------------------------------ #

# every block stages all boxes in shared memory, 21 bytes each, and 20 bytes
# of bitmasks a 32 OCR boxes: N + M up to 10240 fits in the 227 KB a block
# can have
MERGE_MAX_BOXES = 10240

MergeMasks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def merge_masks_plain(icon_boxes: torch.Tensor, icon_valid: torch.Tensor,
                      ocr_boxes: torch.Tensor, ocr_valid: torch.Tensor,
                      iou_threshold: float) -> MergeMasks:
    """Plain PyTorch merge decision -> (icon_keep [N], ocr_keep [M],
    absorb [N,M], icon_suppressed [N]), all bool.  See ops/overlap.py for
    the rules."""
    n = icon_boxes.shape[0]
    m = ocr_boxes.shape[0]
    dev = icon_boxes.device

    ratio, a_geom, b_geom = overlap_matrices_plain(icon_boxes, ocr_boxes)
    a = a_geom & ocr_valid[None, :]
    b = b_geom & ocr_valid[None, :]

    # --- icon-vs-icon suppression (keep the smaller box) ---
    area = box_area(icon_boxes)
    not_self = ~torch.eye(n, dtype=torch.bool, device=dev)
    bigger = area[:, None] > area[None, :]
    suppressed_by = not_self & icon_valid[None, :] & (ratio > iou_threshold) & bigger
    icon_suppressed = suppressed_by.any(dim=1) & icon_valid
    icon_pass = icon_valid & ~icon_suppressed

    # the reference's elif only fires when the `a` branch didn't
    b = b & ~a

    ks = torch.arange(m, device=dev)
    any_b = b.any(dim=1)
    first_b = torch.argmax(b.to(torch.int8), dim=1)  # first True (lowest index)
    k_stop = torch.where(any_b, first_b, torch.full_like(first_b, m))

    absorb = icon_pass[:, None] & a & (ks[None, :] < k_stop[:, None])
    ocr_removed = absorb.any(dim=0)

    icon_keep = icon_pass & ~any_b
    ocr_keep = ocr_valid & ~ocr_removed
    return icon_keep, ocr_keep, absorb, icon_suppressed


# per (device, stream): the fused merge's bitmask and block ticket, which
# every launch leaves zeroed; two streams never share one
_merge_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _merge_scratch_for(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _merge_scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros((words,), dtype=torch.int32, device=dev)
        _merge_scratch[key] = buf
    return buf


def merge_masks(icon_boxes: torch.Tensor, icon_valid: torch.Tensor,
                ocr_boxes: torch.Tensor, ocr_valid: torch.Tensor,
                iou_threshold: float) -> MergeMasks:
    """The whole merge decision in one launch of csrc/overlap.cu's fused
    kernel -> (icon_keep [N], ocr_keep [M], absorb [N,M], icon_suppressed
    [N]), bool.  icon_boxes [N,4], ocr_boxes [M,4] float32; icon_valid [N],
    ocr_valid [M] bool.  N = 0 gives what the plain version gives; M = 0
    raises, as the plain version's argmax over an empty row does."""
    _check_boxes(icon_boxes, "icon_boxes")
    _check_boxes(ocr_boxes, "ocr_boxes")
    n, m = icon_boxes.shape[0], ocr_boxes.shape[0]
    dev = icon_boxes.device
    for t, name, size in ((icon_valid, "icon_valid", n), (ocr_valid, "ocr_valid", m)):
        if t.dtype != torch.bool or t.shape != (size,):
            raise ValueError(f"{name}: want bool [{size}], got {t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous and on the boxes' device")
    if ocr_boxes.device != dev:
        raise ValueError("icon_boxes and ocr_boxes must share a device")
    if m == 0:
        raise ValueError("merge_masks: M = 0 OCR slots (the first-stop index has no answer)")
    if not icon_boxes.is_cuda:
        return merge_masks_plain(icon_boxes, icon_valid, ocr_boxes, ocr_valid,
                                 float(iou_threshold))
    if n + m > MERGE_MAX_BOXES:
        raise ValueError(f"merge_masks: N + M = {n + m} above {MERGE_MAX_BOXES}")
    fn = cuda_build.load("overlap.cu").merge_masks_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [i32, i32, ctypes.c_float] + [vp] * 6
    fn.restype = i32
    icon_keep = torch.empty((n,), dtype=torch.bool, device=dev)
    ocr_keep = torch.empty((m,), dtype=torch.bool, device=dev)
    absorb = torch.empty((n, m), dtype=torch.bool, device=dev)
    icon_suppressed = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = cuda_build.current_stream()
        scratch = _merge_scratch_for(dev, stream.value, (m + 31) // 32 + 1)
        err = fn(icon_boxes.data_ptr(), icon_valid.data_ptr(), ocr_boxes.data_ptr(),
                 ocr_valid.data_ptr(), n, m, float(iou_threshold), icon_keep.data_ptr(),
                 ocr_keep.data_ptr(), absorb.data_ptr(), icon_suppressed.data_ptr(),
                 scratch.data_ptr(), stream)
    launch_counts["merge_masks"] += 1
    cuda_build.check(err, "merge_masks")
    return icon_keep, ocr_keep, absorb, icon_suppressed
