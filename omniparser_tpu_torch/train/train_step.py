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
import copy
import dataclasses
import threading
from typing import Dict, Optional

import torch

from omniparser_tpu_torch.models.florence2 import Florence2, FlorenceDims
from omniparser_tpu_torch.models.norm import ShardAllReduce, dp_shard
from omniparser_tpu_torch.models.yolov8 import YOLOv8, Detector
from omniparser_tpu_torch.parallel.mesh import (
    batch_sharding, module_device, same_device, shard_params_fsdp_tp)
from omniparser_tpu_torch.train.losses import (
    caption_loss, caption_loss_sums, detection_loss, detection_loss_from_sums,
    detection_loss_sums)
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


def _forward(det_module: YOLOv8, florence: Florence2, batch, dtype: torch.dtype):
    """Both networks over `batch`: (the detector's level outputs, the
    teacher-forced caption logits)."""
    dev = batch["images"].device
    with compute_autocast(dev, dtype):
        outs = det_module(batch["images"].permute(0, 3, 1, 2))
    ids = batch["caption_ids"]
    dec_in = torch.cat([torch.full_like(ids[:, :1], 2), ids[:, :-1]], dim=1)
    with compute_autocast(dev, dtype):
        logits = florence(batch["crops"], batch["prompt_ids"], dec_in)
    return outs, logits


def loss_fn(state: TrainState, batch):
    """(total, detection, caption) losses of `batch`; the detector in
    train mode updates its running statistics."""
    outs, logits = _forward(state.det_module, state.florence, batch, state.dtype)
    det_l = detection_loss(outs, batch["gt_boxes"], batch["gt_mask"], state.imgsz)
    cap_l = caption_loss(logits, batch["caption_ids"])
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
    """``train_step`` over a ('dp', 'tp') mesh (``parallel/mesh.py``):
    returns ``step(batch) -> metrics``, which updates `state` in place and
    equals ``train_step(state, batch)`` on the whole batch.

    One process drives the mesh.  Each dp row's contiguous shard of the
    batch runs its forward on a thread of its own; train-mode BatchNorm
    takes its statistics from every shard through a barrier all-reduce
    (``models/norm.dp_shard``) and updates the running statistics once,
    with the global values; each shard returns loss sums and counts, and
    the loss is their quotient on the first row's device, so the box and
    DFL terms divide by the global positive count and the caption term by
    the global count of non-pad tokens.  One ``backward()`` reaches every
    shard.  Rows on one device share its networks, so autograd sums their
    gradients; a row on another device gets copies, whose gradients are
    summed onto the state's before the one AdamW step, and which get the
    new parameters and statistics back after it.  With tp > 1 Florence-2's
    large parameters are split over each row's tp devices in place
    (``shard_params_fsdp_tp``, gather on use; the optimiser's moments are
    split with them), as the JAX step shards the captioner's parameters.
    The state's networks must lie on the mesh's first row device.
    """
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    home = module_device(state.det_module)
    if not same_device(home, mesh.row_device(0)):
        raise ValueError(f"the state's networks lie on {home}, the mesh's first row "
                         f"computes on {mesh.row_device(0)}")
    nets, rows = [(state.det_module, state.florence, 0)], []
    for r in range(dp):
        dev = mesh.row_device(r)
        i = next((i for i, (d, _, _) in enumerate(nets)
                  if same_device(module_device(d), dev)), None)
        if i is None:
            nets.append((copy.deepcopy(state.det_module).to(dev),
                         copy.deepcopy(state.florence).to(dev), r))
            i = len(nets) - 1
        rows.append(nets[i])
    if tp > 1:
        before = dict(state.florence.named_parameters())
        for _, florence, r in nets:
            leaves = shard_params_fsdp_tp(florence, mesh, row=r)
        state.optimizer = _split_optimizer(state.optimizer, state.florence, leaves, before, tp)
    sums_keys = ("cls", "cls_n", "box", "dfl", "pos", "nll", "tokens")

    def shard_sums(r: int, part, reducer, out, errors):
        det_module, florence, _ = rows[r]
        try:
            with dp_shard(reducer, r):
                outs, logits = _forward(det_module, florence, part, state.dtype)
                sums = detection_loss_sums(outs, part["gt_boxes"], part["gt_mask"], state.imgsz)
                sums["nll"], sums["tokens"] = caption_loss_sums(logits, part["caption_ids"])
            out[r] = sums
        except BaseException as e:  # noqa: BLE001 - handed to the caller's thread
            errors.append(e)
            reducer.abort()

    def step(batch) -> Dict[str, torch.Tensor]:
        parts = {k: batch_sharding(mesh).shard(v) for k, v in batch.items()}
        for det_module, florence, _ in nets:
            det_module.train()
            florence.train()
            det_module.zero_grad(set_to_none=True)
            florence.zero_grad(set_to_none=True)
        state.optimizer.zero_grad()
        reducer, out, errors = ShardAllReduce(dp), [None] * dp, []
        threads = [threading.Thread(target=shard_sums,
                                    args=(r, {k: v[r] for k, v in parts.items()},
                                          reducer, out, errors))
                   for r in range(dp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        first = mesh.row_device(0)
        tot = {k: sum(o[k].to(first) for o in out) for k in sums_keys}
        det_l = detection_loss_from_sums(tot)
        cap_l = tot["nll"] / torch.clamp(tot["tokens"], min=1.0)
        loss = det_l + cap_l
        loss.backward()
        with torch.no_grad():
            for det_module, florence, _ in nets[1:]:  # copies on other devices
                for mine, theirs in ((state.det_module, det_module), (state.florence, florence)):
                    got = dict(theirs.named_parameters())
                    for name, p in mine.named_parameters():
                        g = got[name].grad
                        if g is not None:
                            p.grad = g.to(p.device) if p.grad is None else p.grad + g.to(p.device)
        state.optimizer.step()
        with torch.no_grad():
            for det_module, florence, _ in nets[1:]:
                for mine, theirs in ((state.det_module, det_module), (state.florence, florence)):
                    dst = dict(theirs.state_dict(keep_vars=True))
                    for name, t in mine.state_dict(keep_vars=True).items():
                        dst[name].copy_(t)
        return {"loss": loss.detach(), "det_loss": det_l.detach(), "cap_loss": cap_l.detach()}

    return step


def _split_optimizer(opt: AdamW, module: torch.nn.Module, leaves: Dict[str, int],
                     before: Dict[str, torch.nn.Parameter], tp: int) -> AdamW:
    """`opt` over `module`'s parameters after ``shard_params_fsdp_tp``
    split `leaves` (names that were parameters in `before`): each split
    parameter's place goes to its shards, and its moments are split the
    same way (Adam is elementwise, so the step is the same)."""
    shards = {}
    for name, dim in leaves.items():
        owner, _, leaf = name.rpartition(".")
        plist = module.get_submodule(owner).parametrizations[leaf]
        shards[id(before[name])] = ([getattr(plist, f"original{i}") for i in range(tp)], dim)
    params = []
    for p in opt.params:
        params += shards.get(id(p), ([p], 0))[0]
    group = opt.opt.param_groups[0]
    new = AdamW(params, opt.schedule, weight_decay=group["weight_decay"],
                clip_norm=opt.clip_norm, b1=group["betas"][0], b2=group["betas"][1],
                eps=group["eps"])
    new.count = opt.count
    for p in opt.params:
        st = opt.opt.state.get(p)
        if not st:
            continue
        if id(p) not in shards:
            new.opt.state[p] = st
            continue
        parts, dim = shards[id(p)]
        for i, s in enumerate(parts):
            new.opt.state[s] = {
                k: (v.chunk(tp, dim)[i].contiguous().to(s.device, copy=True)
                    if torch.is_tensor(v) and v.shape == p.shape else
                    (v.clone() if torch.is_tensor(v) else v))
                for k, v in st.items()}
    return new
