"""Font-free GUI screenshots from a seed: a title bar, a side panel of icon
rows with word bars, a grid of icon blocks with caption bars and a field of
paragraph bars.  Each is drawn with filled rectangles only, so the screens
need no font library and are the same on every machine.

A traffic file names this generator and gives its parameters:

  screen      [h, w] of every screenshot
  pool        number of distinct screenshots
  icon_blocks [lo, hi]: drawn icon blocks a screen; the pool takes every
              count of an even spread over [lo, hi], in an order drawn from
              the seed, so that every seed brings the same amount of work
  text_bars   [lo, hi]: paragraph bars a screen, spread the same way
  cell        [h, w] of one grid cell of the icon area (one block in a cell)
  block       side of an icon block in pixels
  content_seed  the screens are drawn from it and not from --seed: every
              seed serves the same screens, and the seed orders them (the
              clients' orders, the sampled requests and the captioner's
              weights come from --seed), so that a seed changes the order
              of the work and not its amount

Copied from the measured package's ``bench_torch.synthetic_screenshot`` and
parametrised; the layout of a 1080x1920 screen with the default cell is
that screenshot's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SIDE_W = 260  # side panel width
TITLE_H = 48


def spread(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n counts evenly over [lo, hi] (both ends included), shuffled."""
    counts = np.rint(np.linspace(lo, hi, n)).astype(np.int64) if n > 1 else np.array([lo])
    return rng.permutation(counts)


def screenshot(rng, h: int, w: int, n_blocks: int, n_bars: int, cell=(150, 88),
               block: int = 56) -> np.ndarray:
    """One screenshot with `n_blocks` icon blocks and `n_bars` paragraph bars."""
    img = np.full((h, w, 3), 236, np.uint8)
    img[:TITLE_H] = (40, 44, 52)                               # title bar
    img[TITLE_H:, :SIDE_W] = (250, 250, 250)                   # side panel
    for i in range(min(14, (h - 80) // 60)):                   # side-panel rows
        y = 80 + i * 60
        img[y:y + 28, 24:52] = rng.integers(30, 200, 3)        # icon block
        x = 70
        for _ in range(int(rng.integers(2, 5))):               # "words": dark bars
            ww = int(rng.integers(18, 60))
            img[y + 8:y + 20, x:x + ww] = 25
            x += ww + 8
    bar_rows = n_bars
    bar_top = h - 20 - 12 * bar_rows                           # paragraph field at the bottom
    ch, cw = cell
    rows = max((bar_top - 70) // ch, 1)
    cols = max((w - 300) // cw, 1)
    if n_blocks > rows * cols:
        raise ValueError(f"{n_blocks} icon blocks do not fit {rows}x{cols} cells of "
                         f"{ch}x{cw} on a {h}x{w} screen")
    inner = block // 4
    for k in sorted(rng.choice(rows * cols, size=n_blocks, replace=False)):
        r, c = divmod(int(k), cols)
        y, x = 70 + r * ch, 300 + c * cw
        col = rng.integers(0, 255, 3)
        img[y:y + block, x:x + block] = col
        img[y + inner:y + block - inner, x + inner:x + block - inner] = 255 - col
        xx = x
        for _ in range(int(rng.integers(1, 3))):               # caption bars
            ww = int(rng.integers(14, 34)) * block // 56
            img[y + block + 10:y + block + 20, xx:xx + ww] = 20
            xx += ww + 6
    for i in range(n_bars):                                    # paragraph lines
        y = bar_top + i * 12
        img[y:y + 7, 300:300 + int(rng.integers((w - 300) // 3, (w - 300) * 9 // 10))] = 60
    return img


def make_pool(params: Dict, seed: int) -> List[np.ndarray]:
    """The traffic's screenshots, from its content seed alone."""
    rng = np.random.default_rng(params["content_seed"])
    h, w = params["screen"]
    n = int(params["pool"])
    blocks = spread(*params["icon_blocks"], n, rng)
    bars = spread(*params["text_bars"], n, rng)
    return [screenshot(rng, h, w, int(b), int(t), tuple(params.get("cell", (150, 88))),
                       int(params.get("block", 56)))
            for b, t in zip(blocks, bars)]


def work(params: Dict, seed: int) -> List[int]:
    """Each pool screenshot's drawn icon blocks (the order of make_pool)."""
    rng = np.random.default_rng(params["content_seed"])
    return [int(b) for b in spread(*params["icon_blocks"], int(params["pool"]), rng)]
