"""Decode attention of a beam search, read through the beams' ancestry table.

A beam decode keeps two key/value stores a layer: ``prefix`` [B, H, P, hd],
written once by the prefill and shared by a crop's K beams, and ``gen``
[B*K, H, T, hd], where decode step s writes the fed token of beam slot j at
``gen[b*K + j, :, s]``.  Nothing is moved when the beams are reordered:
``parents`` [B, K, T] int32 (``models/generate.beam_search``) says which
slot holds position p of current beam j, and attention reads the cache
through it.

The wrapper launches the hand-written CUDA kernel (``csrc/beam_attention.cu``)
for CUDA tensors and takes ``beam_attention_plain`` for CPU tensors, and
only for those: on a CUDA tensor it launches or raises.  ``launch_counts``
rises by one where the kernel is launched.  The recorder's
``beam.attn_bytes`` counts the key and value bytes each call reads, from
the shapes and the step alone.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from omniparser_tpu_torch.ops import cuda_build
from omniparser_tpu_torch.utils.profiling import recorder

__all__ = ["attend", "beam_attention", "beam_attention_plain", "beam_rows", "launch_counts"]

launch_counts: Dict[str, int] = {"beam_attention": 0}

MAX_BEAMS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def attend(q, k, v, mask=None):
    """q [B,H,Q,hd] (already scaled), k/v [B,H,L,hd]; the scores in the
    inputs' dtype, softmax in float32, the probabilities rounded to the
    dtype before the product with v; masked slots at the dtype's lowest
    value."""
    a = q @ k.transpose(-1, -2)
    if mask is not None:
        a = a.masked_fill(~mask, torch.finfo(a.dtype).min)
    return torch.softmax(a.float(), dim=-1).to(v.dtype) @ v


def beam_rows(prefix, gen, parents, step: int):
    """Each beam's positions as one cache: the prefix [B, H, P, hd], then its
    own rows 0..step of `gen` [B*K, H, T, hd] gathered through `parents`
    -> [B*K, H, P + step + 1, hd]."""
    b, k = parents.shape[:2]
    slots = (torch.arange(b, device=parents.device)[:, None, None] * k
             + parents[:, :, :step + 1].long()).reshape(b * k, step + 1)
    pos = torch.arange(step + 1, device=parents.device)
    own = gen[slots, :, pos].transpose(1, 2)  # [B*K, step+1, H, hd] -> [B*K, H, step+1, hd]
    return torch.cat([prefix.repeat_interleave(k, 0), own], dim=2)


def beam_attention_plain(q, prefix_k, prefix_v, gen_k, gen_v, parents, step: int):
    """`attend` over each beam's `beam_rows` -> [B*K, H, 1, hd]."""
    return attend(q, beam_rows(prefix_k, gen_k, parents, step),
                  beam_rows(prefix_v, gen_v, parents, step))


def read_bytes(prefix_k, gen_k, parents, step: int) -> int:
    """The key and value bytes one call reads: the prefix once per crop
    and each beam's own rows 0..step."""
    b, h, p, hd = prefix_k.shape
    k = parents.shape[1]
    return 2 * h * hd * gen_k.element_size() * (b * p + b * k * (step + 1))


def beam_attention(q, prefix_k, prefix_v, gen_k, gen_v, parents, step: int):
    """One decode step's attention: q [B*K, H, 1, hd] (already scaled),
    prefix_k/v [B, H, P, hd], gen_k/v [B*K, H, T, hd] holding steps
    0..step, parents [B, K, T] int32 with entries in [0, K) -> [B*K, H, 1,
    hd] in q's dtype."""
    b, h, p, hd = prefix_k.shape
    k, t = parents.shape[1], parents.shape[2]
    if parents.shape[0] != b or parents.dtype != torch.int32:
        raise ValueError(f"parents: want int32 [{b}, K, T], got {parents.dtype} "
                         f"{tuple(parents.shape)}")
    if not (1 <= k <= MAX_BEAMS and 0 <= step < t):
        raise ValueError(f"beam_attention: K = {k} (1..{MAX_BEAMS}), step {step} of T = {t}")
    want = {"q": (q, (b * k, h, 1, hd)), "prefix_v": (prefix_v, (b, h, p, hd)),
            "gen_k": (gen_k, (b * k, h, t, hd)), "gen_v": (gen_v, (b * k, h, t, hd))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape or x.dtype != prefix_k.dtype:
            raise ValueError(f"{name}: want {prefix_k.dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != prefix_k.device:
            raise ValueError(f"{name} must be on prefix_k's device")
    if recorder.on:
        recorder.count("beam.attn_bytes", read_bytes(prefix_k, gen_k, parents, step))
    if not prefix_k.is_cuda:
        return beam_attention_plain(q, prefix_k, prefix_v, gen_k, gen_v, parents, step)
    if prefix_k.dtype not in _DTYPES:
        raise ValueError(f"beam_attention: dtype {prefix_k.dtype} is not built")
    row = hd * prefix_k.element_size()
    if row % 16 or row > 512:
        raise ValueError(f"beam_attention: a head's row of {row} bytes; the kernel reads "
                         "rows in 16-byte pieces, at most 32 of them")
    tensors = (q, prefix_k, prefix_v, gen_k, gen_v, parents)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("beam_attention: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors[:5]):
        raise ValueError("beam_attention: q and the stores must be 16-byte aligned")
    lib = cuda_build.load("beam_attention.cu")
    fn = lib.beam_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(), gen_k.data_ptr(),
                 gen_v.data_ptr(), parents.data_ptr(), out.data_ptr(), b, k, h, p, t, hd,
                 step, _DTYPES[q.dtype], cuda_build.current_stream())
    launch_counts["beam_attention"] += 1
    cuda_build.check(err, "beam_attention")
    return out
