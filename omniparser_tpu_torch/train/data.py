"""What the trainers share around their steps: the data path's crop loop,
the OCR and captioner trainers' augmentation, and their step runner.

``crop_each`` runs a dataset's images through one inference crop call each
(``ops/preprocess.crop_lines_batch`` or ``crop_resize_batch``: K3 on the
card, its plain version on the CPU) and brings the crops back as uint8.
``augment_draws``/``apply_augment`` are the JAX ``train_ocr._augment``
split into its random draws and their use.  ``make_step_runner`` is the
JAX trainers' scan runner as a plain loop over a dataset resident on the
device; ``run_logged`` drives it in chunks of ``log_every`` steps with a
progress line after each.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from omniparser_tpu_torch.utils.device import resolve_device


def crop_each(images: np.ndarray, crop_one: Callable[[torch.Tensor, int], torch.Tensor],
              device="cuda") -> np.ndarray:
    """``crop_one(image, i) -> [1, h, w, 3]`` float crops of each of
    `images` [n, H, W, 3] u8, uploaded to `device` once; returns [n, h, w,
    3] u8 (values clamped, then truncated as the JAX package's
    ``astype``)."""
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(resolve_device(device))
    crops = torch.cat([crop_one(imgs[i], i) for i in range(imgs.shape[0])])
    return torch.clamp(crops, 0, 255).to(torch.uint8).cpu().numpy()


def augment_draws(generator: torch.Generator, shape) -> Dict[str, torch.Tensor]:
    """The random numbers of one ``_augment`` call for [B,H,W,3], drawn on
    the generator's device: scale U(0.8, 1.2), bias U(-0.1, 0.1), inversion
    with probability 0.25 per sample; noise N(0, 0.015) per value."""
    b, dev = shape[0], generator.device
    u = lambda: torch.rand((b, 1, 1, 1), generator=generator, device=dev)
    scale = u() * 0.4 + 0.8
    bias = u() * 0.2 - 0.1
    inv = u() < 0.25
    noise = torch.randn(tuple(shape), generator=generator, device=dev) * 0.015
    return {"scale": scale, "bias": bias, "inv": inv, "noise": noise}


def apply_augment(x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    x = torch.where(draws["inv"], 1.0 - x, x)
    x = x * draws["scale"] + draws["bias"] + draws["noise"]
    return torch.clamp(x, 0.0, 1.0)


def make_step_runner(step_fn: Callable, batch: int, data, gather, generator: torch.Generator,
                     on_step: Optional[Callable[[int, torch.Tensor], None]] = None):
    """`data` stays on the device; each step samples `batch` indices there
    from `generator`, ``gather(data, idx) -> (x, y)`` takes the batch, and
    ``step_fn(x, y, draws)`` runs the step with this step's
    ``augment_draws``.  ``run(n)`` runs n steps and returns their losses
    [n] (device)."""
    n_data = len(data[0])
    done = [0]

    def run(n: int) -> torch.Tensor:
        losses = []
        for _ in range(n):
            idx = torch.randint(0, n_data, (batch,), generator=generator,
                                device=generator.device)
            x, y = gather(data, idx)
            loss = step_fn(x, y, augment_draws(generator, x.shape))
            if on_step is not None:
                on_step(done[0], loss)
            done[0] += 1
            losses.append(loss)
        return torch.stack(losses)

    return run


def run_logged(run_chunk, steps: int, log_every: int, tag: str,
               after_chunk: Optional[Callable[[int], None]] = None) -> None:
    """``run_chunk(n)`` in chunks of `log_every` steps up to `steps`, a
    progress line after each chunk, then ``after_chunk(steps done)``."""
    t0, done = time.time(), 0
    while done < steps:
        n = min(log_every, steps - done)
        losses = run_chunk(n).cpu().numpy()
        done += n
        print(f"  {tag} step {done}/{steps} loss {losses[-1]:.4f} "
              f"mean {losses.mean():.4f} ({time.time() - t0:.0f}s)", flush=True)
        if after_chunk is not None:
            after_chunk(done)
