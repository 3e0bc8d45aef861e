"""BLIP-2's beam decode attention (csrc/beam_attention.cu), read through
the beams' ancestry table, as a traced run records it: one launch a layer
and decode step.  The interface is the one that ``kernels/nms_keep.py``
writes down.  The port's BLIP-2 module calls the kernel's wrapper by the
name it imported, so the wrapper is replaced there."""

from benchmark.harness import manifest as mf

MODULE, ATTR = "omniparser_tpu_torch.models.blip2", "beam_attention"
KERNELS = ("beam_attention_kernel",)
COUNT_BY = "beam_attention_kernel"

_flops = mf.load_module("flops", "beam_attention.py")


def keep(q, prefix_k, prefix_v, gen_k, gen_v, parents, step):
    """The shapes and the step: crops, beams, heads, prefix positions,
    generated positions the store holds, head width, element bytes."""
    b, h, p, hd = prefix_k.shape
    return (int(b), int(parents.shape[1]), int(h), int(p), int(hd),
            int(gen_k.element_size()), int(step))


def work(kept):
    return _flops.work(*kept)
