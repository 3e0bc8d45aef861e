"""Synthetic GUI scenes with icon ground truth: the JAX package's
``train/synth_gui.py`` (``render_gui_scene``, ``render_icon_tile``, their
helpers, ``ICON_KINDS`` and ``DATA_VERSION``), copied so that the port's
eval harnesses render the same held-out scenes without importing JAX.

Scenes are themed (light, dark or random palettes), structured (menu
bars, toolbars, taskbars, icon rails, desktop grids) and drawn from 33
glyph families, with the text of ``train/synth_text.py``.  The same
generator state gives the same pixels, boxes, texts and kinds as the JAX
package's renderer on the same machine.
"""

from __future__ import annotations

import io
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from omniparser_tpu_torch.train.synth_text import (CARRIED_FONT_DIR, _FONT_FILES, _font,
                                                   matplotlib_font_dir, pick_font,
                                                   require_fonts, sample_text)

# bump to invalidate /tmp training-data caches when generators change
DATA_VERSION = 21

ICON_KINDS = (
    "button", "gear", "hamburger", "magnifier", "arrow", "star", "cross",
    "plus", "dots", "folder", "toggle", "ring", "thumbnail", "chevron",
    # families (matched to icons in the reference's screenshots)
    "bell", "chat", "calendar", "phone", "cloud", "smiley", "send",
    "refresh", "grid", "mic", "camera", "undo", "bold", "italic",
    "underline", "wifi", "battery", "music",
    # left-pointing arrows are their own family — real browser
    # back buttons ground against "back arrow icon", which a generic
    # "arrow icon" caption cannot exact-match (eval/real_gt.json)
    "back",
)

# real-GUI accent colors (material/fluent-ish)
_ACCENTS = (
    (0, 103, 192), (16, 124, 16), (196, 43, 28), (136, 23, 152),
    (0, 120, 212), (255, 140, 0), (43, 136, 216), (234, 67, 53),
    (52, 168, 83), (251, 188, 5), (66, 133, 244), (98, 100, 167),
)


class Theme:
    """Light/dark GUI palette; None theme = legacy random colors."""

    def __init__(self, rng, dark: bool):
        self.dark = dark
        j = lambda lo, hi: int(rng.integers(lo, hi))
        if dark:
            g = j(18, 50)
            self.base = (g + j(-4, 5), g + j(-4, 5), g + j(-4, 8))
            self.text = tuple(j(195, 250) for _ in range(3))
            self.icon = tuple(j(150, 235) for _ in range(3))
        else:
            g = j(232, 256)
            self.base = (g + j(-6, 1), g + j(-6, 1), g + j(-6, 1))
            self.text = tuple(j(5, 70) for _ in range(3))
            self.icon = tuple(j(40, 120) for _ in range(3))
        self.accent = _ACCENTS[j(0, len(_ACCENTS))]

    def panel(self, rng) -> Tuple[int, int, int]:
        d = int(rng.integers(6, 30)) * (1 if self.dark else -1)
        return tuple(int(np.clip(c + d, 0, 255)) for c in self.base)


def sample_theme(rng) -> Optional[Theme]:
    r = rng.random()
    if r < 0.40:
        return Theme(rng, dark=False)
    if r < 0.68:
        return Theme(rng, dark=True)
    return None  # legacy fully-random colors


def _rand_color(rng, base=None, min_contrast=70):
    c = rng.integers(0, 256, 3)
    if base is not None:
        while abs(int(c.mean()) - int(np.mean(base))) < min_contrast:
            c = rng.integers(0, 256, 3)
    return tuple(int(x) for x in c)


def _bold_font(size: int):
    bold = [f for f in _FONT_FILES if "Bold" in f]
    return _font((bold or _FONT_FILES)[0], size)


def _italic_font(size: int):
    """A slanted face for the italic-button glyph (real toolbar italics
    are oblique; an upright 'I' reads as a bar/digit in blurry crops).
    DejaVu ships no Oblique in the system dir — fall back to
    matplotlib's bundled mpl-data faces (the carried copy of them where
    matplotlib is absent), then upright."""
    import os

    candidates = [f for f in _FONT_FILES
                  if "Oblique" in f or "Italic" in f]
    mdir = matplotlib_font_dir() or os.path.join(CARRIED_FONT_DIR, "matplotlib")
    if not candidates and mdir is not None:
        for name in ("DejaVuSerif-Italic.ttf", "DejaVuSans-Oblique.ttf"):
            p = os.path.join(mdir, name)
            if os.path.exists(p):
                candidates.append(p)
    return _font((candidates or _FONT_FILES)[0], size)


def _draw_icon(draw, rng, x, y, s, fg, bg, kind: str | None = None) -> str:
    """One glyph inside the s x s box at (x, y).  Returns the kind drawn
    (captioner training labels — train/train_captioner.py)."""
    if kind is None:
        kind = ICON_KINDS[int(rng.integers(0, len(ICON_KINDS)))]
    x2, y2 = x + s, y + s
    m = max(s // 6, 1)  # inner margin
    # real GUI chrome favors thin strokes (Fluent/SF outline style):
    # sample thin ~40% of the time
    w = max(s // 14, 1) if rng.random() < 0.4 else max(s // 10, 1)
    cx, cy = x + s / 2, y + s / 2
    outline_style = rng.random() < 0.5  # outline vs filled glyph bodies
    if kind == "button":
        r = max(s // 5, 2)
        draw.rounded_rectangle([x, y, x2, y2], radius=r,
                               fill=fg if rng.random() < 0.5 else None,
                               outline=fg, width=w)
        if rng.random() < 0.6:  # inner dot/bar
            q = max(s // 5, 1)
            draw.ellipse([cx - q, cy - q, cx + q, cy + q], fill=bg)
    elif kind == "gear":
        pts = []
        for i in range(16):
            ang = i * np.pi / 8
            rad = s / 2 - 1 if i % 2 == 0 else s / 3
            pts.append((cx + rad * np.cos(ang), cy + rad * np.sin(ang)))
        draw.polygon(pts, fill=fg)
        q = max(s // 6, 1)
        draw.ellipse([cx - q, cy - q, cx + q, cy + q], fill=bg)
    elif kind == "hamburger":
        for i in range(3):
            yy = y + m + i * (s - 2 * m) // 2
            draw.rectangle([x + m, yy, x2 - m, min(yy + w, y2)], fill=fg)
    elif kind == "magnifier":
        d = int(s * 0.6)
        draw.ellipse([x + m, y + m, x + m + d, y + m + d], outline=fg, width=w)
        draw.line([x + m + d, y + m + d, x2 - 1, y2 - 1], fill=fg, width=w)
    elif kind == "arrow":
        # rightward only — leftward arrows are the 'back' family
        if rng.random() < 0.5:
            # browser-style forward arrow: shaft + thin chevron head
            hx, tx = x2 - m, x + m
            draw.line([hx, cy, tx, cy], fill=fg, width=w)
            q = s / 2 - m
            draw.line([hx, cy, hx - q, cy - q], fill=fg, width=w)
            draw.line([hx, cy, hx - q, cy + q], fill=fg, width=w)
        else:
            pts = [(x2 - m, y + s / 2), (x + m, y + m), (x + m, y2 - m)]
            draw.polygon(pts, fill=fg)
    elif kind == "back":
        # left-pointing back arrow (browser/app-bar): shaft + chevron
        # head, or filled triangle
        if rng.random() < 0.7:
            hx, tx = x + m, x2 - m
            draw.line([hx, cy, tx, cy], fill=fg, width=w)
            q = s / 2 - m
            draw.line([hx, cy, hx + q, cy - q], fill=fg, width=w)
            draw.line([hx, cy, hx + q, cy + q], fill=fg, width=w)
        else:
            pts = [(x + m, y + s / 2), (x2 - m, y + m), (x2 - m, y2 - m)]
            draw.polygon(pts, fill=fg)
    elif kind == "star":
        pts = []
        for i in range(10):
            ang = -np.pi / 2 + i * np.pi / 5
            rad = s / 2 - 1 if i % 2 == 0 else s / 5
            pts.append((cx + rad * np.cos(ang), cy + rad * np.sin(ang)))
        draw.polygon(pts, fill=fg)
    elif kind == "cross":
        draw.line([x + m, y + m, x2 - m, y2 - m], fill=fg, width=w)
        draw.line([x + m, y2 - m, x2 - m, y + m], fill=fg, width=w)
    elif kind == "plus":
        draw.rectangle([x + m, cy - w // 2, x2 - m, cy + w - w // 2], fill=fg)
        draw.rectangle([cx - w // 2, y + m, cx + w - w // 2, y2 - m], fill=fg)
    elif kind == "dots":
        # ellipsis (horizontal or vertical) — "more options".  The 3x3
        # array moved to the 'grid' family ("apps icon"): the two must be
        # visually distinct for the captioner to separate them.
        q = max(s // 8, 1)
        horiz = rng.random() < 0.5
        for i in range(3):
            t = m + q + i * (s - 2 * m - 2 * q) // 2
            px, py = (x + t, cy) if horiz else (cx, y + t)
            draw.ellipse([px - q, py - q, px + q, py + q], fill=fg)
    elif kind == "folder":
        draw.rectangle([x, y + s // 4, x2, y2], fill=fg)
        draw.rectangle([x, y + s // 8, x + s // 2, y + s // 4], fill=fg)
        if rng.random() < 0.5:
            # Windows-Explorer-style two-tone: lighter front face over the
            # darker back+tab, optional accent band across the lower front
            # (an audit of real crops: the yellow+blue-band folders in
            # demo_image.jpg/onenote.png read as 'image icon')
            front = tuple(int(np.clip(c * 1.25 + 25, 0, 255)) for c in fg)
            draw.rectangle([x, y + s * 3 // 8, x2, y2], fill=front)
            if rng.random() < 0.4:
                band = (int(rng.integers(30, 90)), int(rng.integers(90, 160)),
                        int(rng.integers(180, 240)))
                draw.rectangle([x + s // 6, y2 - s // 4, x2 - s // 6,
                                y2 - s // 12], fill=band)
    elif kind == "toggle":
        draw.rounded_rectangle([x, y + s // 4, x2, y2 - s // 4],
                               radius=s // 4, fill=fg)
        side = x2 - s // 2 if rng.random() < 0.5 else x
        draw.ellipse([side, y + s // 8, side + s // 2, y2 - s // 8], fill=bg,
                     outline=fg, width=1)
    elif kind == "ring":
        draw.ellipse([x + 1, y + 1, x2 - 1, y2 - 1], outline=fg, width=w)
    elif kind == "chevron":
        draw.line([x + m, y + m, cx, y + s / 2], fill=fg, width=w)
        draw.line([cx, y + s / 2, x + m, y2 - m], fill=fg, width=w)
        draw.line([cx, y + m, x2 - m, y + s / 2], fill=fg, width=w)
        draw.line([x2 - m, y + s / 2, cx, y2 - m], fill=fg, width=w)
    elif kind == "bell":
        # dome + flared skirt + clapper; outline style ~half the time
        # (Teams/OneNote bells are thin-stroke outlines)
        if outline_style:
            draw.arc([x + m, y + m // 2, x2 - m, y2 - m + s // 3],
                     180, 360, fill=fg, width=w)
            draw.line([x + m // 2, y2 - m - s // 8,
                       x2 - m // 2, y2 - m - s // 8], fill=fg, width=w)
            # flared skirt (real Fluent bells widen toward the base; the
            # a confusion bell->refresh came from reading the dome
            # arc as a refresh arc — the slanted sides break that)
            draw.line([x + m // 2, y2 - m - s // 8, x + m, cy],
                      fill=fg, width=w)
            draw.line([x2 - m // 2, y2 - m - s // 8, x2 - m, cy],
                      fill=fg, width=w)
        else:
            draw.pieslice([x + m, y + m // 2, x2 - m, y2 - m], 180, 360,
                          fill=fg)
            draw.polygon([(x + m, cy), (x2 - m, cy),
                          (x2 - m // 2, y2 - m - s // 8),
                          (x + m // 2, y2 - m - s // 8)], fill=fg)
        q = max(s // 10, 1)
        draw.ellipse([cx - q, y2 - m - q, cx + q, y2 - m + q], fill=fg)
    elif kind == "chat":
        r_chat = rng.random()
        if r_chat < 0.3:
            # Teams-launcher-style: filled circular bubble with 2-3
            # bg-colored text lines inside and a small tail (
            # the real teams.png chat icon is exactly this and the
            # outline-only training read it as 'emoji icon')
            draw.ellipse([x + 1, y + 1, x2 - 1, y2 - m // 2], fill=fg)
            draw.polygon([(x + s // 5, y2 - m - 2), (x + s // 2, y2 - m // 2),
                          (x + s // 7, y2 - 1)], fill=fg)
            ln = 2 + int(rng.random() < 0.5)
            for i in range(ln):
                ly_ = y + s // 3 + i * max(s // 6, 2)
                draw.line([x + s // 4, ly_, x2 - s // 4 - (s // 6 if i == ln - 1 else 0), ly_],
                          fill=bg, width=max(w // 2, 1))
        elif r_chat < 0.65:
            # Teams/Fluent-style bubble: rounded SQUARE outline with the
            # tail cut from the lower-left (the real-pixels
            # confusion was chat->menu; the rounded-rect body + clearly
            # exterior tail separates it from hamburger lines)
            r = max(s // 4, 2)
            draw.rounded_rectangle([x + 1, y + m // 2, x2 - 1, y2 - m - 1],
                                   radius=r,
                                   fill=fg if rng.random() < 0.4 else None,
                                   outline=fg, width=w)
            draw.polygon([(x + s // 4, y2 - m - 2), (x + s // 2, y2 - m - 2),
                          (x + s // 6, y2 - 1)], fill=fg)
        else:
            draw.ellipse([x + 1, y + m // 2, x2 - 1, y2 - m - 1],
                         fill=fg if rng.random() < 0.6 else None,
                         outline=fg, width=w)
            draw.polygon([(x + s // 4, y2 - m - 2), (x + s // 2, y2 - m - 2),
                          (x + s // 5, y2 - 1)], fill=fg)
    elif kind == "calendar":
        if outline_style:
            # Fluent outline calendar (teams.png rail): rounded-rect
            # outline, solid header band drawn as a thick line, dot grid
            draw.rounded_rectangle([x + 1, y + m // 2, x2 - 1, y2 - 1],
                                   radius=max(s // 8, 1), outline=fg,
                                   width=w)
            draw.line([x + 1, y + m + w, x2 - 1, y + m + w], fill=fg,
                      width=w)
        else:
            draw.rectangle([x + 1, y + m, x2 - 1, y2 - 1], outline=fg,
                           width=w)
            draw.rectangle([x + 1, y + m, x2 - 1, y + m + max(s // 5, 2)],
                           fill=fg)
            for hx in (x + s // 3, x + 2 * s // 3):  # binding hangers
                draw.rectangle([hx - w // 2, y, hx + w // 2, y + m + 1],
                               fill=fg)
        q = max(s // 12, 1)
        for i in range(2):
            for jj in range(3):
                px = x + s // 4 + jj * s // 4
                py = y + m + s // 3 + i * s // 4
                draw.ellipse([px - q, py - q, px + q, py + q], fill=fg)
    elif kind == "phone":
        if outline_style:
            # curved-handset outline (Teams/iOS call glyph): thick arc
            # from lower-left to upper-right with rounded end caps
            draw.arc([x + m - s // 3, y + m - s // 3, x2 - m + s // 8,
                      y2 - m + s // 8], 10, 100, fill=fg,
                     width=max(w * 2, 2))
            r = max(s // 7, 1)
            draw.ellipse([x + m - r, y2 - m - 2 * r, x + m + r, y2 - m],
                         fill=fg)
            draw.ellipse([x2 - m - 2 * r, y + m - r, x2 - m, y + m + r],
                         fill=fg)
        else:
            r = max(s // 4, 2)
            draw.ellipse([x + m, y2 - m - r * 2, x + m + 2 * r, y2 - m],
                         fill=fg)
            draw.ellipse([x2 - m - 2 * r, y + m, x2 - m, y + m + 2 * r],
                         fill=fg)
            draw.line([x + m + r, y2 - m - r, x2 - m - r, y + m + r],
                      fill=fg, width=max(w * 2, 3))
    elif kind == "cloud":
        # two bumps over a flat-bottomed base (real cloud glyphs are flat);
        # OneDrive-style outline variant
        base_y = y2 - m - max(s // 10, 1)

        def _cloud_body(ins, color):
            if base_y - ins <= cy + s // 8 + ins:  # degenerate at tiny s
                return
            draw.ellipse([x + m + ins, cy - s // 8 + ins, cx - ins,
                          base_y - ins], fill=color)
            draw.ellipse([cx - s // 4 + ins, y + m + ins,
                          x2 - m - s // 12 - ins, base_y - ins], fill=color)
            draw.rounded_rectangle([x + m + ins, cy + s // 8 + ins,
                                    x2 - m - ins, base_y - ins],
                                   radius=max(s // 8 - ins, 1), fill=color)

        _cloud_body(0, fg)
        if outline_style:  # carve the interior -> OneDrive-style outline
            _cloud_body(max(w, 1), bg)
    elif kind == "smiley":
        draw.ellipse([x + 1, y + 1, x2 - 1, y2 - 1], outline=fg, width=w)
        q = max(s // 10, 1)
        for ex in (cx - s // 5, cx + s // 5):
            draw.ellipse([ex - q, cy - s // 5 - q, ex + q, cy - s // 5 + q],
                         fill=fg)
        draw.arc([x + s // 4, y + s // 4, x2 - s // 4, y2 - s // 5],
                 20, 160, fill=fg, width=w)
    elif kind == "send":
        pts = [(x + m // 2, y + m), (x2 - m // 2, cy),
               (x + m // 2, y2 - m), (x + m + s // 4, cy)]
        if outline_style:
            # Teams' send glyph is a thin-stroke outline paper plane
            draw.polygon(pts, outline=fg, width=w)
            draw.line([x + m + s // 4, cy, x2 - m // 2, cy], fill=fg, width=w)
        else:
            draw.polygon(pts, fill=fg)
    elif kind == "refresh":
        # arc span 240-330 degrees: browser refresh glyphs are nearly a
        # full ring (an audit: the 270-only arc read as 'circle')
        span = int(rng.integers(240, 331))
        draw.arc([x + m, y + m, x2 - m, y2 - m], 300, (300 + span) % 360,
                 fill=fg, width=w)
        ax = cx + (s / 2 - m) * np.cos(-np.pi / 3)
        ay = cy + (s / 2 - m) * np.sin(-np.pi / 3)
        # prominent arrowhead: without it a refresh arc is just "an arc",
        # which the captioner then sees in every dome/bell/undo glyph
        q = max(s // 4, 3)
        draw.polygon([(ax + q, ay - q // 2), (ax - q // 2, ay - q // 2),
                      (ax + q // 4, ay + q)], fill=fg)
    elif kind == "grid":
        q = max(s // 10, 1)
        round_ = rng.random() < 0.6
        for i in range(3):
            for jj in range(3):
                px = x + m + jj * (s - 2 * m) // 2
                py = y + m + i * (s - 2 * m) // 2
                if round_:
                    draw.ellipse([px - q, py - q, px + q, py + q], fill=fg)
                else:
                    draw.rectangle([px - q, py - q, px + q, py + q], fill=fg)
    elif kind == "mic":
        r = max(s // 5, 2)
        if rng.random() < 0.3:
            # brand multicolor (the Google mic in google_page/demo_image:
            # blue capsule, red+yellow cradle, green stem) — single-color
            # training alone read it as texture
            jit = lambda c: tuple(int(np.clip(v + rng.integers(-25, 25),
                                              0, 255)) for v in c)
            c_body, c_arc, c_stem = (jit((66, 133, 244)),
                                     jit((234, 67, 53)), jit((52, 168, 83)))
        else:
            c_body = c_arc = c_stem = fg
        draw.rounded_rectangle([cx - r, y + m, cx + r, cy + r], radius=r,
                               fill=c_body)
        draw.arc([cx - 2 * r, y + m + r, cx + 2 * r, cy + 2 * r], 0, 180,
                 fill=c_arc, width=w)
        draw.line([cx, cy + 2 * r, cx, y2 - m], fill=c_stem, width=w)
        draw.line([cx - r, y2 - m, cx + r, y2 - m], fill=c_stem, width=w)
    elif kind == "camera":
        draw.rounded_rectangle([x + 1, y + m + 1, x2 - 1, y2 - m], radius=2,
                               outline=fg, width=w)
        draw.rectangle([cx - s // 6, y + m - s // 8, cx + s // 6, y + m + 1],
                       fill=fg)
        q = max(s // 5, 2)
        draw.ellipse([cx - q, cy - q + m // 2, cx + q, cy + q + m // 2],
                     outline=fg, width=w)
    elif kind == "undo":
        draw.arc([x + m, y + m, x2 - m, y2 - m], 90, 315, fill=fg, width=w)
        # Arrowhead at the arc's actual 315-degree endpoint (PIL angles are
        # clockwise from 3 o'clock with y down -> upper-right of the arc).
        r = (x2 - x) / 2 - m
        ax = cx + r * math.cos(math.radians(315))
        ay = cy + r * math.sin(math.radians(315))
        q = max(s // 5, 2)
        draw.polygon([(ax - q, ay), (ax + q // 2, ay - q), (ax + q // 2, ay + q)],
                     fill=fg)
    elif kind in ("bold", "italic", "underline"):
        ch = {"bold": "B", "italic": "I", "underline": "U"}[kind]
        f = (_bold_font(max(s - 2, 6)) if kind == "bold"
             else _italic_font(max(s - 2, 6)) if kind == "italic"
             else _font(_FONT_FILES[0], max(s - 2, 6)))
        bx0, by0, bx1, by1 = draw.textbbox((0, 0), ch, font=f)
        tw, th = bx1 - bx0, by1 - by0
        ox = x + (s - tw) // 2 - bx0
        oy = y + (s - (th if kind != "underline" else th + w + 2)) // 2 - by0
        draw.text((ox, oy), ch, fill=fg, font=f)
        if kind == "underline":
            uy = oy + by1 + 2
            draw.line([x + m, min(uy, y2 - 1), x2 - m, min(uy, y2 - 1)],
                      fill=fg, width=w)
    elif kind == "wifi":
        for i, rr in enumerate((s * 0.48, s * 0.33, s * 0.18)):
            draw.arc([cx - rr, cy - rr + s // 5, cx + rr, cy + rr + s // 5],
                     225, 315, fill=fg, width=w)
        q = max(s // 10, 1)
        draw.ellipse([cx - q, y2 - m - 2 * q, cx + q, y2 - m], fill=fg)
    elif kind == "battery":
        horiz = rng.random() < 0.7
        if horiz:
            draw.rectangle([x + 1, y + s // 4, x2 - m - 1, y2 - s // 4],
                           outline=fg, width=w)
            draw.rectangle([x2 - m, cy - s // 8, x2 - 1, cy + s // 8], fill=fg)
            lvl = rng.uniform(0.2, 1.0)
            draw.rectangle([x + 1 + w, y + s // 4 + w,
                            x + 1 + w + (s - m - 2 - 2 * w) * lvl,
                            y2 - s // 4 - w], fill=fg)
        else:
            draw.rectangle([x + s // 4, y + m, x2 - s // 4, y2 - 1],
                           outline=fg, width=w)
            draw.rectangle([cx - s // 8, y, cx + s // 8, y + m], fill=fg)
    elif kind == "music":
        q = max(s // 5, 2)
        draw.ellipse([x + m, y2 - m - 2 * q, x + m + 2 * q, y2 - m], fill=fg)
        draw.ellipse([x2 - m - 2 * q, y2 - m - 3 * q, x2 - m, y2 - m - q],
                     fill=fg)
        draw.line([x + m + 2 * q - w, y + m, x + m + 2 * q - w, y2 - m - q],
                  fill=fg, width=w)
        draw.line([x2 - m - w, y + m - q // 2, x2 - m - w, y2 - m - 2 * q],
                  fill=fg, width=w)
        draw.polygon([(x + m + 2 * q - w - 1, y + m),
                      (x2 - m - 1, y + m - q // 2),
                      (x2 - m - 1, y + m + q), (x + m + 2 * q - w - 1,
                                                y + m + q * 3 // 2)], fill=fg)
    else:  # thumbnail: structured noise patch
        noise = np.random.default_rng(int(rng.integers(1 << 31))).integers(
            0, 255, (max(s // 4, 2), max(s // 4, 2), 3), dtype=np.uint8)
        from PIL import Image

        tile = Image.fromarray(noise).resize((s, s))
        draw._image.paste(tile, (x, y))
    return kind


def _paste_icon(canvas, rng, x, y, s, fg, bg, kind=None, aa=None) -> str:
    """Draw one glyph, 2x supersampled + LANCZOS downscale (real renderers
    antialias; PIL primitives do not).  aa=None -> random 70%."""
    from PIL import Image, ImageDraw

    if aa is None:
        aa = rng.random() < 0.7
    if not aa or kind == "thumbnail" or s < 8:
        return _draw_icon(ImageDraw.Draw(canvas), rng, x, y, s, fg, bg, kind)
    up = canvas.crop((x, y, x + s, y + s)).resize((2 * s, 2 * s),
                                                  Image.NEAREST)
    kind = _draw_icon(ImageDraw.Draw(up), rng, 0, 0, 2 * s, fg, bg, kind)
    canvas.paste(up.resize((s, s), Image.LANCZOS), (x, y))
    return kind


def _postprocess(arr: np.ndarray, rng) -> np.ndarray:
    """Screenshot-domain artifacts: noise, JPEG roundtrip, slight blur."""
    from PIL import Image, ImageFilter

    if rng.random() < 0.4:
        arr = arr + rng.normal(0.0, rng.uniform(1.0, 5.0), arr.shape)
    out = np.clip(arr, 0, 255).astype(np.uint8)
    if rng.random() < 0.20:  # DPI-scaling blur
        im = Image.fromarray(out).filter(
            ImageFilter.GaussianBlur(rng.uniform(0.3, 0.8)))
        out = np.asarray(im)
    if rng.random() < 0.30:  # JPEG artifacts (demo_image.jpg is JPEG)
        buf = io.BytesIO()
        Image.fromarray(out).save(buf, "JPEG",
                                  quality=int(rng.integers(45, 92)))
        out = np.asarray(Image.open(buf).convert("RGB"))
    return out


def render_icon_tile(
    rng: np.random.Generator, tile: int = 96, kind: str | None = None,
) -> Tuple[np.ndarray, str, List[int]]:
    """One icon glyph on a GUI-ish background tile (captioner training).

    Returns (RGB uint8 [tile,tile,3], kind, glyph box xyxy px).  The
    glyph gets the same size/color/theme statistics as render_gui_scene
    icons; ~25% of tiles add a nearby text label (real crops often catch
    neighboring label text).
    """
    from PIL import Image, ImageDraw

    require_fonts()
    # 'thumbnail' (noise-patch -> "image icon") is down-weighted to ~0.4x
    # uniform: at full weight it absorbs too many real glyph crops
    # (an audit: 14/36 real misses answered 'image icon').  A
    # a "chrome fragment" junk-class experiment (draw partial
    # widgets, train them as 'image icon' so junk detector boxes stop
    # stealing glyph phrases) measured WORSE on the 36 real GT crops and
    # the full real bench in all three trainings — removed again.
    if kind is None:
        kind = ICON_KINDS[int(rng.integers(0, len(ICON_KINDS)))]
        if kind == "thumbnail" and rng.random() < 0.6:
            kind = ICON_KINDS[int(rng.integers(0, len(ICON_KINDS)))]

    theme = sample_theme(rng)
    base = theme.base if theme else tuple(int(x) for x in rng.integers(0, 256, 3))
    img = Image.new("RGB", (tile, tile), base)
    draw = ImageDraw.Draw(img)
    # panel edge / separator clutter like real scenes
    if rng.random() < 0.4:
        shade = theme.panel(rng) if theme else tuple(
            int(np.clip(c + rng.integers(-60, 60), 0, 255)) for c in base)
        if rng.random() < 0.5:
            y = int(rng.integers(0, tile))
            draw.rectangle([0, y, tile, tile], fill=shade)
        else:
            x = int(rng.integers(0, tile))
            draw.rectangle([x, 0, tile, tile], fill=shade)
    arr_probe = np.asarray(img)
    s = int(rng.integers(14, min(57, tile - 4)))
    x = int(rng.integers(2, tile - s - 1))
    y = int(rng.integers(2, tile - s - 1))
    local = tuple(int(c) for c in
                  arr_probe[y:y + s, x:x + s].reshape(-1, 3).mean(0))
    if theme and rng.random() < 0.8:
        fg = theme.accent if rng.random() < 0.25 else theme.icon
        if abs(int(np.mean(fg)) - int(np.mean(local))) < 60:
            fg = theme.text
    else:
        fg = _rand_color(rng, local)
    # LOW-CONTRAST variant (~25%): real rail/toolbar glyphs sit at
    # contrast ~50-90 against the chrome (Teams dark rail icons are
    # #8b8b95 on #1f1f23) — a failure analysis showed the
    # high-contrast-only captioner reads those as texture ('image icon')
    if rng.random() < 0.25:
        lm = np.mean(local)
        delta = float(rng.integers(45, 90)) * (1 if lm < 128 else -1)
        fg = tuple(int(np.clip(c + delta, 0, 255)) for c in local)
    # APP-ICON variant (~15%): iOS/Android launcher icons are a light
    # glyph on a saturated rounded-square plate that fills the detector
    # box (an audit of real crops: every ios.png icon — phone, chat,
    # music, wifi — is white-on-color; the plateless captioner read them
    # as 'image icon').  The plate becomes the glyph's background.
    app_plate = rng.random() < 0.15
    if app_plate:
        import colorsys

        hue = float(rng.uniform(0, 1))
        rr, gg, bb = colorsys.hsv_to_rgb(hue, float(rng.uniform(0.6, 1.0)),
                                         float(rng.uniform(0.55, 0.95)))
        plate = (int(rr * 255), int(gg * 255), int(bb * 255))
        pad = max(s // 8, 2)
        draw.rounded_rectangle(
            [x - pad, y - pad, x + s + pad, y + s + pad],
            radius=max((s + 2 * pad) // 4, 2), fill=plate)
        local = plate
        fg = tuple(int(rng.integers(235, 256)) for _ in range(3))
    kind = _paste_icon(img, rng, x, y, s, fg, local, kind=kind)
    # NOTIFICATION BADGE (~12%): Teams/OneNote rail bells and chat
    # bubbles carry a red counter badge overlapping the glyph's top-right
    # corner; untrained, the badge dominated the crop and broke the kind
    # (an audit of real crops: bell+«16» -> 'calendar icon').
    if rng.random() < 0.12:
        br = max(int(s * rng.uniform(0.22, 0.38)), 3)
        bcx = x + s - int(rng.uniform(-0.3, 0.5) * br)
        bcy = y + int(rng.uniform(-0.3, 0.5) * br)
        bcol = (int(rng.integers(200, 245)), int(rng.integers(16, 60)),
                int(rng.integers(16, 60)))
        draw.ellipse([bcx - br, bcy - br, bcx + br, bcy + br], fill=bcol)
        if br >= 5 and rng.random() < 0.8:
            num = str(rng.integers(1, 100 if br >= 7 else 10))
            bf = _font(_FONT_FILES[0], max(int(br * 1.3), 6))
            tx0, ty0, tx1, ty1 = draw.textbbox((0, 0), num, font=bf)
            draw.text((bcx - (tx1 - tx0) / 2 - tx0,
                       bcy - (ty1 - ty0) / 2 - ty0), num,
                      fill=(255, 255, 255), font=bf)
    # INK-TIGHT box (~55%): hand-annotated GT boxes (and detector boxes
    # on real screens) hug the drawn pixels, not the nominal glyph
    # square — a letter glyph like 'B' is half as wide as its square, so
    # square-box training shows side margins real crops never have.
    # Measured against the pre-glyph snapshot so panel clutter is
    # excluded; the plate/badge count as ink (real GT includes them).
    gx1, gy1, gx2, gy2 = x, y, x + s, y + s
    if rng.random() < 0.55:
        ext = int(0.6 * s)
        r0, c0 = max(y - ext, 0), max(x - ext, 0)
        r1, c1 = min(y + s + ext, tile), min(x + s + ext, tile)
        now = np.asarray(img, np.int16)
        diff = np.abs(now[r0:r1, c0:c1]
                      - arr_probe[r0:r1, c0:c1].astype(np.int16)).max(-1)
        ys_, xs_ = np.nonzero(diff > 18)
        if len(xs_) > 4:
            pw = int(rng.uniform(0, 0.12) * (xs_.max() - xs_.min() + 1)) + 1
            ph = int(rng.uniform(0, 0.12) * (ys_.max() - ys_.min() + 1)) + 1
            gx1 = max(c0 + int(xs_.min()) - pw, 0)
            gy1 = max(r0 + int(ys_.min()) - ph, 0)
            gx2 = min(c0 + int(xs_.max()) + 1 + pw, tile)
            gy2 = min(r0 + int(ys_.max()) + 1 + ph, tile)
    # rail/toolbar composite (~20%): real detector crops on an app rail
    # catch the NEIGHBOR glyphs' edges at the crop border (teams
    # diagnosis: every left-rail icon crop contains slices of the icons
    # above/below it).  Draw distractor glyphs one stride away — PIL
    # clips whatever falls outside the tile, leaving partial edges.
    if not app_plate and rng.random() < 0.2:
        gap = int(rng.integers(s // 2, s + 8))
        vertical = rng.random() < 0.6
        for sign in (-1, 1):
            if rng.random() < 0.25:
                continue
            nx = x if vertical else x + sign * (s + gap)
            ny = y + sign * (s + gap) if vertical else y
            # aa=False: the AA path crop/pastes an s x s patch, which
            # stamps black corners when the box hangs off the canvas
            _paste_icon(img, rng, nx, ny, s, fg, local, aa=False)
    if rng.random() < 0.35:  # neighboring label text in the tile
        label = sample_text(rng, max_chars=10)
        fsz = int(rng.integers(9, 14))
        f = pick_font(rng, label, fsz)
        tc = theme.text if theme else _rand_color(rng, base)
        if rng.random() < 0.55 and y + s + fsz + 4 < tile:
            # rail-style: label centered BENEATH the glyph and (usually)
            # INSIDE the returned box.  Round-5 teams.png audit: the
            # detector boxes rail icons WITH their caption text
            # ('Activity'/'Chat'/...), so inference crops are
            # glyph+label composites — the captioner must learn that the
            # small text row below does not change the glyph's kind.
            lw = f.getlength(label)
            lx = int(np.clip(x + s / 2 - lw / 2, 0, max(tile - lw - 1, 0)))
            ly = y + s + 2
            draw.text((lx, ly), label, fill=tc, font=f)
            if rng.random() < 0.65:
                gx1 = min(gx1, lx)
                gx2 = max(gx2, min(int(lx + lw) + 1, tile))
                gy2 = min(max(gy2, ly + fsz + 2), tile)
        else:
            ly = y + s + 2 if y + s + 14 < tile else max(y - 14, 0)
            draw.text((max(x - 4, 0), ly), label, fill=tc, font=f)
    # detector-overshoot box (~25%): real detector boxes run 1.3-2x the
    # glyph (teams rail: gt 24px vs det 50px) — pad each side
    # independently so the glyph sits off-center with extra context
    if rng.random() < 0.25:
        bw, bh = gx2 - gx1, gy2 - gy1
        gx1 = int(max(gx1 - rng.uniform(0.05, 0.4) * bw, 0))
        gy1 = int(max(gy1 - rng.uniform(0.05, 0.4) * bh, 0))
        gx2 = int(min(gx2 + rng.uniform(0.05, 0.4) * bw, tile))
        gy2 = int(min(gy2 + rng.uniform(0.05, 0.4) * bh, tile))
    arr = np.asarray(img, np.float32)
    # scale roundtrip (~45%): real crops come from screenshots that were
    # downscaled for upload (max_upload_side) and re-enlarged by the
    # 64px crop-gather — soft, slightly aliased strokes.  The factor
    # floor is 0.3: a 20 px real glyph blown up to the 64 px crop is a
    # ~0.3x roundtrip, well below the old 0.45 floor (an audit:
    # the blurriest real crops all missed as 'image icon').
    if rng.random() < 0.45:
        import cv2

        f_ = float(rng.uniform(0.22, 0.8))
        small = cv2.resize(arr, (max(int(tile * f_), 8),) * 2,
                           interpolation=cv2.INTER_AREA)
        arr = cv2.resize(small, (tile, tile),
                         interpolation=cv2.INTER_LINEAR)
    return _postprocess(arr, rng), kind, \
        [gx1, gy1, gx2, gy2]


def render_gui_scene(
    rng: np.random.Generator, size: int = 640, max_icons: int = 48,
    max_texts: int = 20, return_kinds: bool = False,
) -> Tuple[np.ndarray, List[List[int]], List[List[int]], List[str]]:
    """A GUI-like screen.

    Returns (RGB uint8 [size,size,3], icon boxes xyxy px, text boxes, texts)
    — plus the per-icon glyph kinds when return_kinds (captioner e2e gate).
    Icon boxes are the detector GT; text lines are negatives (the reference
    detector boxes icons, OCR owns text).
    """
    from PIL import Image, ImageDraw

    require_fonts()
    theme = sample_theme(rng)
    base = theme.base if theme else tuple(int(x) for x in rng.integers(0, 256, 3))
    canvas = Image.new("RGB", (size, size), base)
    draw = ImageDraw.Draw(canvas)

    occupied = np.zeros((size, size), bool)
    texts: List[str] = []
    text_boxes: List[List[int]] = []
    icon_boxes: List[List[int]] = []
    kinds: List[str] = []

    def free(x, y, w, h, g=4):
        ys, ye = max(y - g, 0), min(y + h + g, size)
        xs, xe = max(x - g, 0), min(x + w + g, size)
        return not occupied[ys:ye, xs:xe].any()

    def claim(x, y, w, h, g=4):
        occupied[max(y - g, 0):min(y + h + g, size),
                 max(x - g, 0):min(x + w + g, size)] = True

    def panel_color():
        if theme:
            return theme.panel(rng)
        return tuple(int(np.clip(c + rng.integers(-60, 60), 0, 255))
                     for c in base)

    def pick_fg(local):
        if theme and rng.random() < 0.8:
            fg = theme.accent if rng.random() < 0.2 else theme.icon
            if abs(int(np.mean(fg)) - int(np.mean(local))) < 60:
                fg = theme.text
            return fg
        return _rand_color(rng, local)

    def text_color(local_mean):
        if theme and rng.random() < 0.85:
            return theme.accent if rng.random() < 0.12 else theme.text
        return ((0, 0, 0) if local_mean > 128 else (255, 255, 255)) \
            if rng.random() < 0.7 else _rand_color(rng, base)

    def put_text(x, y, text, sizept) -> int:
        # Returns the rendered text width (>= 2, truthy) on success, 0 on
        # failure — callers that space subsequent elements must advance by
        # this width, not by a separately-measured probe (pick_font is
        # random, so a second measurement can use a different face).
        font = pick_font(rng, text, sizept)
        probe = ImageDraw.Draw(Image.new("L", (8, 8)))
        bx0, by0, bx1, by1 = probe.textbbox((0, 0), text, font=font)
        tw, th = bx1 - bx0, by1 - by0
        if tw < 2 or th < 2 or x + tw >= size - 1 or y + th >= size - 1:
            return 0
        if not free(x, y, tw, th):
            return 0
        local = np.asarray(canvas)[y:y + th, x:x + tw].mean()
        draw.text((x - bx0, y - by0), text, fill=text_color(local), font=font)
        claim(x, y, tw, th)
        # phrase-level GT (easyocr granularity; synth_text.split_phrases:
        # merge words whose pixel gap < width_ths * height)
        from omniparser_tpu_torch.train.synth_text import split_phrases

        wths = float(rng.uniform(0.45, 0.62))
        for phrase, wx0, wx1 in split_phrases(text, font, th, wths):
            texts.append(phrase)
            text_boxes.append([int(x - bx0 + wx0), y,
                               min(int(x - bx0 + wx1), x + tw), y + th])
        return tw

    def put_icon(x, y, s, kind=None) -> bool:
        if x + s >= size - 1 or y + s >= size - 1 or not free(x, y, s, s):
            return False
        local = tuple(int(c) for c in np.asarray(canvas)[
            y:y + s, x:x + s].reshape(-1, 3).mean(0))
        kinds.append(_paste_icon(canvas, rng, x, y, s, pick_fg(local),
                                 local, kind=kind))
        claim(x, y, s, s)
        icon_boxes.append([x, y, x + s, y + s])
        return True

    # ------------------------- panels / chrome ------------------------- #
    n_panels = int(rng.integers(2, 7 if theme else 9))
    for _ in range(n_panels):
        if theme and rng.random() < 0.6:
            # axis-aligned panes like real apps: sidebar / header / column
            kind = rng.integers(0, 4)
            if kind == 0:  # left sidebar
                x1, y1 = 0, int(rng.integers(0, size // 8))
                x2_, y2_ = int(rng.integers(size // 8, size // 3)), size
            elif kind == 1:  # header strip
                x1, y1 = 0, 0
                x2_, y2_ = size, int(rng.integers(size // 16, size // 6))
            elif kind == 2:  # bottom strip
                x1, y1 = 0, int(rng.integers(size * 7 // 8, size - 10))
                x2_, y2_ = size, size
            else:  # content card
                x1 = int(rng.integers(0, size // 2))
                y1 = int(rng.integers(0, size // 2))
                x2_ = int(rng.integers(x1 + 40, size))
                y2_ = int(rng.integers(y1 + 40, size))
        else:
            x1, y1 = int(rng.integers(0, size - 20)), int(rng.integers(0, size - 20))
            x2_ = int(rng.integers(x1 + 16, min(x1 + size, size)))
            y2_ = int(rng.integers(y1 + 16, min(y1 + size, size)))
        shade = panel_color()
        if rng.random() < 0.25:  # vertical gradient fill
            g2 = panel_color()
            h = max(y2_ - y1, 1)
            grad = np.linspace(0, 1, h)[:, None] * (np.array(g2, float)
                                                    - np.array(shade, float))
            block = (np.array(shade, float)[None, None]
                     + grad[:, None]).astype(np.uint8)
            block = np.broadcast_to(block, (h, max(x2_ - x1, 1), 3))
            canvas.paste(Image.fromarray(np.ascontiguousarray(block)),
                         (x1, y1))
        elif rng.random() < 0.7:
            draw.rectangle([x1, y1, x2_, y2_], fill=shade)
        else:
            draw.rectangle([x1, y1, x2_, y2_], outline=shade,
                           width=int(rng.integers(1, 4)))
    for _ in range(int(rng.integers(0, 4))):  # separators
        y = int(rng.integers(0, size))
        draw.line([(0, y), (size, y)], fill=panel_color(), width=1)

    # --------------------- structured element bands -------------------- #
    # menu bar: short words in a row near the top
    if rng.random() < 0.55:
        y = int(rng.integers(2, size // 12))
        x = int(rng.integers(2, size // 8))
        pt = int(rng.integers(10, 16))
        for _ in range(int(rng.integers(4, 9))):
            word = sample_text(rng, max_chars=9).split(" ")[0] or "File"
            tw = put_text(x, y, word, pt)
            if not tw:
                break
            x += tw + int(rng.integers(14, 34))
            if x >= size - 30:
                break

    # icon toolbar row / taskbar row / left rail / desktop grid
    if rng.random() < 0.55 and len(icon_boxes) < max_icons:
        s = int(rng.integers(14, 30))
        y = int(rng.integers(2, size // 3))
        x = int(rng.integers(2, size // 4))
        gap = int(rng.integers(s // 2, s * 2))
        for _ in range(int(rng.integers(4, 12))):
            if len(icon_boxes) >= max_icons or x + s >= size - 2:
                break
            put_icon(x, y, s)
            x += s + gap
    if rng.random() < 0.35 and len(icon_boxes) < max_icons:  # taskbar
        s = int(rng.integers(16, 34))
        y = size - s - int(rng.integers(3, 12))
        x = int(rng.integers(size // 4, size // 2))
        for _ in range(int(rng.integers(4, 10))):
            if len(icon_boxes) >= max_icons or x + s >= size - 2:
                break
            put_icon(x, y, s)
            x += s + int(rng.integers(6, 18))
    if rng.random() < 0.30 and len(icon_boxes) < max_icons:  # left rail
        s = int(rng.integers(16, 30))
        x = int(rng.integers(2, size // 10))
        y = int(rng.integers(size // 8, size // 3))
        for _ in range(int(rng.integers(3, 9))):
            if len(icon_boxes) >= max_icons or y + s + 16 >= size - 2:
                break
            if put_icon(x, y, s) and rng.random() < 0.7:
                put_text(max(x - 4, 0), y + s + 2,
                         sample_text(rng, max_chars=9).split(" ")[0] or "App",
                         int(rng.integers(8, 12)))
            y += s + int(rng.integers(22, 44))
    if rng.random() < 0.25 and len(icon_boxes) < max_icons:  # desktop grid
        s = int(rng.integers(22, 44))
        gx = int(rng.integers(4, size // 6))
        gy = int(rng.integers(4, size // 4))
        stepx = s + int(rng.integers(30, 70))
        stepy = s + int(rng.integers(26, 50))
        for iy in range(int(rng.integers(2, 4))):
            for ix in range(int(rng.integers(2, 5))):
                x = gx + ix * stepx
                y = gy + iy * stepy
                if len(icon_boxes) >= max_icons or x + s >= size - 2 \
                        or y + s + 16 >= size - 2:
                    continue
                if put_icon(x, y, s) and rng.random() < 0.8:
                    put_text(max(x - 6, 0), y + s + 2,
                             sample_text(rng, max_chars=11).split(" ")[0]
                             or "File", int(rng.integers(9, 13)))

    # ------------------- free-scatter texts and icons ------------------ #
    for _ in range(int(rng.integers(max_texts // 2, max_texts + 1))):
        if len(texts) >= max_texts:
            break
        text = sample_text(rng)
        put_text(int(rng.integers(1, size - 30)),
                 int(rng.integers(1, size - 20)), text,
                 int(rng.integers(10, 26)))

    for _ in range(int(rng.integers(max_icons // 2, max_icons + 1))):
        if len(icon_boxes) >= max_icons:
            break
        s = int(rng.integers(14, 56))
        put_icon(int(rng.integers(1, max(size - s - 1, 2))),
                 int(rng.integers(1, max(size - s - 1, 2))), s)

    out = _postprocess(np.asarray(canvas, np.float32), rng)
    if return_kinds:
        return out, icon_boxes, text_boxes, texts, kinds
    return out, icon_boxes, text_boxes, texts
