"""Joint train step: icon-detector fine-tune + captioner fine-tune.

One step over both objectives: YOLOv8 (train mode, BatchNorm statistics
updated as flax updates ``batch_stats``) on the detection loss, Florence-2
on the teacher-forced caption loss, one AdamW over both parameter sets
(optax's ``adamw(learning_rate)``: weight decay 1e-4, every parameter
decayed).  Only parameters get gradients; the running statistics are
buffers.  Parameters and optimiser state are float32; with ``dtype``
bfloat16 the networks run under autocast (convolutions and matmuls in
bfloat16, norms, heads and losses in float32), as the JAX modules' bfloat16
``dtype`` with float32 parameters.

PyTorch updates the modules in place: ``train_step`` returns only the
metrics, where the JAX step returns new parameters and optimiser state.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch

from omniparser_tpu_torch.models.florence2 import Florence2, FlorenceDims
from omniparser_tpu_torch.models.yolov8 import YOLOv8, Detector
from omniparser_tpu_torch.train.losses import caption_loss, detection_loss
from omniparser_tpu_torch.train.optim import AdamW
from omniparser_tpu_torch.utils.device import resolve_device
from omniparser_tpu_torch.weights.init import flax_init_

# the JAX make_train_state's default captioner: a tiny Florence-2
TINY_TRAIN_DIMS = FlorenceDims(
    embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8), num_groups=(1, 2, 4, 8),
    depths=(1, 1, 1, 1), window_size=4, d_model=32, encoder_layers=2,
    decoder_layers=2, attn_heads=4, ffn_dim=64, vocab_size=128, max_positions=64,
)


@dataclasses.dataclass
class TrainState:
    detector: Detector
    det_module: YOLOv8
    florence: Florence2
    optimizer: AdamW
    imgsz: int
    dtype: torch.dtype = torch.bfloat16  # the networks' compute dtype


def compute_autocast(device: torch.device, dtype: torch.dtype):
    """Autocast to `dtype` on `device`, or nothing for float32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def make_train_state(
    imgsz: int = 160,
    florence_dims: Optional[FlorenceDims] = None,
    learning_rate: float = 1e-4,
    generator: Optional[torch.Generator] = None,
    fast_init: bool = False,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> TrainState:
    """Both networks built on `device`, initialised from `generator` (on
    that device; seed 0 where None) with flax's defaults (``flax_init_``),
    detector first.  ``fast_init`` fills them as the JAX package's
    ``_materialize_shapes`` does instead (norm scales and variances one,
    every other float normal(0.02)): values that only keep the first loss
    finite."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    detector = Detector(variant="n", num_classes=1, imgsz=imgsz)
    dims = florence_dims or TINY_TRAIN_DIMS
    init = _materialize_ if fast_init else flax_init_
    with torch.device(dev):
        det_module = init(detector.make_module(), generator)
        florence = init(Florence2(dims), generator)
    params = list(det_module.parameters()) + list(florence.parameters())
    return TrainState(detector, det_module, florence, AdamW(params, learning_rate),
                      imgsz, dtype)


@torch.no_grad()
def _materialize_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """The JAX package's host-side fill of a shape tree: ones for norm
    scales and running variances, normal(0.02) for every other float."""
    from omniparser_tpu_torch.weights.init import _NORMS

    ones = set()
    for m in module.modules():
        if isinstance(m, _NORMS):
            ones.add(id(m.weight))
            if isinstance(m, torch.nn.BatchNorm2d):
                ones.add(id(m.running_var))
    for t in list(module.parameters()) + list(module.buffers()):
        if not t.is_floating_point():
            t.zero_()
        elif id(t) in ones:
            t.fill_(1.0)
        else:
            t.copy_(torch.randn(t.shape, generator=generator, device=generator.device) * 0.02)
    return module


def make_synthetic_batch(generator: torch.Generator, batch: int, imgsz: int, max_gt: int = 8,
                         crop: int = 32, prompt_len: int = 4, cap_len: int = 6
                         ) -> Dict[str, torch.Tensor]:
    """A small random batch exercising both objectives, on the generator's
    device (images and crops NHWC in [0, 1], boxes normalised xyxy)."""
    dev = generator.device
    u = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    xy = u(batch, max_gt, 2) * 0.55 + 0.05
    wh = u(batch, max_gt, 2) * 0.25 + 0.05
    return {
        "images": u(batch, imgsz, imgsz, 3),
        "gt_boxes": torch.cat([xy, xy + wh], dim=-1),
        "gt_mask": torch.ones((batch, max_gt), dtype=torch.bool, device=dev),
        "crops": u(batch, crop, crop, 3),
        "prompt_ids": torch.randint(4, 100, (batch, prompt_len), generator=generator,
                                    device=dev),
        "caption_ids": torch.randint(4, 100, (batch, cap_len), generator=generator,
                                     device=dev),
    }


def loss_fn(state: TrainState, batch):
    """(total, detection, caption) losses of `batch`; the detector in
    train mode updates its running statistics."""
    dev = batch["images"].device
    with compute_autocast(dev, state.dtype):
        outs = state.det_module(batch["images"].permute(0, 3, 1, 2))
    det_l = detection_loss(outs, batch["gt_boxes"], batch["gt_mask"], state.imgsz)
    ids = batch["caption_ids"]
    dec_in = torch.cat([torch.full_like(ids[:, :1], 2), ids[:, :-1]], dim=1)
    with compute_autocast(dev, state.dtype):
        logits = state.florence(batch["crops"], batch["prompt_ids"], dec_in)
    cap_l = caption_loss(logits, ids)
    return det_l + cap_l, det_l, cap_l


def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
    """One AdamW step on both networks, in place.  Returns the metrics
    (device scalars: reading them waits for the step)."""
    state.det_module.train()
    state.florence.train()
    state.optimizer.zero_grad()
    loss, det_l, cap_l = loss_fn(state, batch)
    loss.backward()
    state.optimizer.step()
    return {"loss": loss.detach(), "det_loss": det_l.detach(), "cap_loss": cap_l.detach()}


def make_sharded_train_step(state: TrainState, mesh):
    """The JAX package jits the step over a ('dp', 'tp') mesh; this
    package has no multi-device path yet."""
    raise NotImplementedError(
        "make_sharded_train_step: multi-device training is not ported (ROADMAP A.10)")
