"""Synthetic GUI text: the text sampler, the font set and the line and
screenshot renderers of the JAX package's ``train/synth_text.py``, copied
so that the port renders the same scenes without importing JAX.

Everything is seeded: the same generator state gives the same pixels as
the JAX package's renderer on the same machine (the font set is globbed
from ``/usr/share/fonts`` and matplotlib's bundled faces, so two machines
with other fonts render other pixels).  A machine where the globs find
nothing reads the set that ``carry_fonts`` copied, with its order, weights
and bans, from ``weights/exported/fonts/``
(``scripts/export_torch_weights.py`` writes it; a Pillow without libraqm
still lays text out otherwise); with neither, this module imports but
raises at the first render.  The trainers' half
(``render_line_buffers``, ``crops_from_buffers``, ``render_lines_to_crops``,
``shrink_map``) follows the renderers; ``crops_from_buffers`` runs the
inference crop-gather (K3's line grid on the card).
"""

from __future__ import annotations

import glob
import importlib.util
import os
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from omniparser_tpu_torch.models.ocr import CHARSET

# ----------------------------- text sampling ----------------------------- #

GUI_WORDS = (
    "File Edit View Insert Format Tools Table Window Help Home Share Save "
    "Open Close Exit New Cut Copy Paste Undo Redo Find Replace Select All "
    "Print Settings Options Preferences Account Sign in Sign out Log in "
    "Search Cancel OK Apply Yes No Back Next Finish Done Submit Delete "
    "Remove Add Create Rename Download Upload Refresh Reload Stop Play "
    "Pause Mute Volume Brightness Network Wi-Fi Bluetooth Battery Power "
    "Restart Shut down Sleep Lock Update Install Uninstall Browse Folder "
    "Documents Desktop Downloads Pictures Music Videos Recycle Bin This PC "
    "Control Panel Task Manager Device Manager Properties Advanced General "
    "Security Privacy About Version License Terms Conditions Agreement "
    "Username Password Email Address Phone Name Date Time Zone Language "
    "Keyboard Mouse Display Sound Notifications Storage Apps Features "
    "Default Custom Automatic Manual Enabled Disabled On Off True False "
    "Chrome Firefox Edge Explorer Word Excel PowerPoint Outlook OneNote "
    "Teams Zoom Slack Discord Spotify Steam Visual Studio Code Terminal "
    "untitled readme config index main test data src docs build dist node "
    "Bookmarks History Extensions Profile Incognito Tab Window Zoom Page "
    "Copy link Open in new tab Inspect Translate Cast Share Screenshot "
).split()

PUNCT_TAIL = [":", "...", " >", " *", "?", "!", ""]


def _rand_word(rng: np.random.Generator) -> str:
    n = int(rng.integers(2, 10))
    letters = "abcdefghijklmnopqrstuvwxyz"
    word = "".join(letters[i] for i in rng.integers(0, 26, n))
    style = rng.integers(0, 4)
    if style == 0:
        return word.capitalize()
    if style == 1:
        return word.upper() if n <= 4 else word
    return word


def sample_text(rng: np.random.Generator, max_chars: int | None = None) -> str:
    """One GUI-plausible line: menu items, labels, filenames, numbers,
    URLs, shortcuts, sentences, or random charset coverage.  ~20% of lines
    are long (up to 52 chars) so full-sentence GUI strings are
    in-distribution for the aspect-compressing rec crop."""
    if max_chars is None:
        max_chars = 52 if rng.random() < 0.2 else 28
    kind = rng.integers(0, 10)
    if kind < 4:  # menu / button phrase
        n = int(rng.integers(1, 4 if max_chars <= 28 else 7))
        words = [GUI_WORDS[i] for i in rng.integers(0, len(GUI_WORDS), n)]
        text = " ".join(words) + PUNCT_TAIL[rng.integers(0, len(PUNCT_TAIL))]
    elif kind < 6:  # random words
        n = int(rng.integers(1, 4 if max_chars <= 28 else 8))
        text = " ".join(_rand_word(rng) for _ in range(n))
    elif kind == 6:  # number-ish: times, sizes, percents, versions
        style = rng.integers(0, 5)
        a, b = int(rng.integers(0, 60)), int(rng.integers(0, 60))
        if style == 0:
            text = f"{a % 24}:{b:02d}"
        elif style == 1:
            text = f"{int(rng.integers(1, 999))}.{a % 10} {['KB','MB','GB','%','px'][rng.integers(0,5)]}"
        elif style == 2:
            text = f"v{a % 12}.{b % 30}.{int(rng.integers(0, 9))}"
        elif style == 3:
            text = f"{int(rng.integers(1, 12))}/{int(rng.integers(1, 28))}/{int(rng.integers(2015, 2027))}"
        else:
            text = str(int(rng.integers(0, 100000)))
    elif kind == 7:  # filename / url / path
        w = _rand_word(rng).lower()
        style = rng.integers(0, 4)
        if style == 0:
            text = f"{w}.{['txt','png','pdf','docx','py','json'][rng.integers(0,6)]}"
        elif style == 1:
            text = f"www.{w}.com"
        elif style == 2:
            text = f"https://{w}.org/{_rand_word(rng).lower()}"
        else:
            text = f"C:\\Users\\{w.capitalize()}"
    elif kind == 8:  # keyboard shortcut
        text = f"Ctrl+{'ABCDEFXZSVNPQW'[rng.integers(0, 14)]}"
    else:  # random charset coverage (keeps rare punctuation trainable)
        n = int(rng.integers(1, 12))
        chars = [CHARSET[i] for i in rng.integers(1, len(CHARSET), n)]
        text = "".join(chars).strip()
        if not text:
            text = "+"
    text = text[:max_chars].strip()
    return text if text else "OK"


def encode_text(text: str, max_len: int) -> np.ndarray:
    """CTC labels: CHARSET index + 1 (0 = blank/pad), 0-padded to max_len."""
    out = np.zeros(max_len, np.int32)
    for i, c in enumerate(text[:max_len]):
        out[i] = CHARSET.index(c) + 1
    return out


# ----------------------------- line rendering ---------------------------- #

# where the renderers find faces: the system's TTFs and matplotlib's bundled
# ones; a machine with neither reads the faces that
# scripts/export_torch_weights.py copies beside the exported weights
SYSTEM_FONT_DIR = "/usr/share/fonts"
CARRIED_FONT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "weights", "exported", "fonts")
FONT_MANIFEST = "fonts.json"

# chars a font's TTF cmap maps to TeX glyphs instead of ASCII (verified
# by rendering: cmss10/cmr10 draw <>|\{} as upside-down-!/dashes/quotes);
# render_line re-picks a DejaVu face when the text needs a banned char
_TEX_BAN = frozenset("<>|\\{}")

# one face of the set: (path, repeat weight, banned chars, 'system' or 'matplotlib')
FontEntry = Tuple[str, int, frozenset, str]


def matplotlib_font_dir() -> Optional[str]:
    """matplotlib's bundled TTF directory, found without importing
    matplotlib (its import pulls in PIL), or None without matplotlib."""
    spec = importlib.util.find_spec("matplotlib")
    if spec is None or not spec.submodule_search_locations:
        return None
    return os.path.join(spec.submodule_search_locations[0], "mpl-data") + "/fonts/ttf"


def glob_fonts() -> List[FontEntry]:
    """The font set this machine's globs find, in render order: the system
    faces first (``pick_font`` re-picks among the first six), then
    matplotlib's."""
    entries = [(f, 1, frozenset(), "system") for f in
               sorted(glob.glob(SYSTEM_FONT_DIR + "/**/*.ttf", recursive=True))]
    # matplotlib bundles STIX (full-Unicode serif), DejaVu oblique faces,
    # and the Computer Modern TTFs.  cmss10 matters most: its lowercase
    # 'g' is SINGLE-STORY like Segoe UI / SF — recognizers trained on
    # DejaVu/STIX alone read real GUI 'g' as 'q' (Design->Desiqn) because
    # they only ever saw the double-story form.  cmss10 is weighted 4x for
    # that reason.
    mpl = matplotlib_font_dir()
    if mpl is None:  # no matplotlib: the system faces alone
        return entries
    for f in sorted(glob.glob(mpl + "/*.ttf")):
        name = f.rsplit("/", 1)[-1]
        if "Sym" in name or "NonUni" in name or "Display" in name:
            # the *Display.ttf faces are glyph-less stubs (textbbox returns
            # zero height; drawing produces no ink)
            continue
        if name.startswith(("STIXGeneral", "DejaVu")):
            entries.append((f, 1, frozenset(), "matplotlib"))
    for name, ban, weight in (("cmss10.ttf", _TEX_BAN, 4),
                              ("cmtt10.ttf", frozenset(), 1),
                              ("cmr10.ttf", _TEX_BAN, 1)):
        path = f"{mpl}/{name}"
        if os.path.exists(path):
            entries.append((path, weight, ban, "matplotlib"))
    return entries


def carried_fonts(root: str = CARRIED_FONT_DIR) -> List[FontEntry]:
    """The font set ``carry_fonts`` copied into `root`, read from its
    manifest in its order, or [] where there is no manifest."""
    import json

    manifest = os.path.join(root, FONT_MANIFEST)
    if not os.path.exists(manifest):
        return []
    with open(manifest) as f:
        fonts = sorted(json.load(f)["fonts"], key=lambda e: e["order"])
    return [(os.path.join(root, e["file"]), int(e["weight"]), frozenset(e["ban"]), e["half"])
            for e in fonts]


def carry_fonts(dest: str = CARRIED_FONT_DIR) -> List[FontEntry]:
    """Copy the globbed font set into `dest` (``system/`` and
    ``matplotlib/``: the two halves hold faces of the same name) with a
    manifest of each face's order, repeat weight, banned chars and half,
    so a machine without the faces renders from the same set.  Returns the
    set as ``carried_fonts`` reads it back; raises where the globs find
    nothing."""
    import json
    import shutil

    entries = glob_fonts()
    if not entries:
        raise RuntimeError("no TTF font found to carry; searched " + " and ".join(_font_dirs()))
    fonts = []
    for order, (path, weight, ban, half) in enumerate(entries):
        rel = os.path.join(half, os.path.relpath(path, SYSTEM_FONT_DIR) if half == "system"
                           else os.path.basename(path))
        os.makedirs(os.path.dirname(os.path.join(dest, rel)), exist_ok=True)
        shutil.copyfile(path, os.path.join(dest, rel))
        fonts.append({"order": order, "file": rel, "weight": weight,
                      "ban": "".join(sorted(ban)), "half": half})
    with open(os.path.join(dest, FONT_MANIFEST), "w") as f:
        json.dump({"fonts": fonts}, f, indent=1)
    return carried_fonts(dest)


def _collect_fonts(root: str = CARRIED_FONT_DIR):
    """(font files in render order with repeats, {path: banned chars}):
    the globbed set, else the carried one."""
    files, ban = [], {}
    for path, weight, chars, _half in glob_fonts() or carried_fonts(root):
        if chars:
            ban[path] = chars
        files.extend([path] * weight)
    return files, ban


_FONT_FILES, _FONT_BAN = _collect_fonts()


def _font_dirs() -> Tuple[str, ...]:
    return (SYSTEM_FONT_DIR + "/**/*.ttf", "matplotlib's mpl-data/fonts/ttf",
            os.path.join(CARRIED_FONT_DIR, FONT_MANIFEST)
            + " (written by scripts/export_torch_weights.py)")


def require_fonts() -> None:
    """Raise where no TTF face was found (the renderers index the set)."""
    if not _FONT_FILES:
        raise RuntimeError("no TTF font found to render text with; searched "
                           + " and ".join(_font_dirs()))


@lru_cache(maxsize=256)
def _font(path: str, size: int):
    from PIL import ImageFont

    return ImageFont.truetype(path, size)


def split_words(text: str, font):
    """Per-word horizontal extents inside a rendered line, via prefix
    advance widths (the same metric PIL uses to place glyphs).  Returns
    [(word, x0, x1)] relative to the line's draw origin.

    The reference's easyocr returns word/phrase-level boxes, not whole
    visual lines (behavior surface: util/utils.py:504-540) — training
    the text detector on word boxes makes our components match that
    granularity, which word-level grounding instructions depend on
    (a 'Layout' click must not land on the centroid of
    'Layout References Mailings')."""
    out = []
    pos = 0
    for word in text.split(" "):
        if word:
            x0 = font.getlength(text[:pos])
            x1 = font.getlength(text[:pos + len(word)])
            out.append((word, x0, x1))
        pos += len(word) + 1
    return out


def split_phrases(text: str, font, height: float, width_ths: float = 0.5):
    """easyocr-granularity grouping of a rendered line: consecutive words
    merge into one phrase box while the inter-word PIXEL gap stays under
    ``width_ths * height`` (easyocr's width_ths default is 0.5 and its
    grouping compares horizontal gaps to box height).  Returns
    [(phrase, x0, x1)] relative to the draw origin.

    Single-space prose ('Microsoft Teams', chat names) renders with
    ~0.25-0.35x-height spaces -> ONE phrase, exactly what the reference's
    easyocr returns for it (util/utils.py:504-540).  Wide-tracked runs
    (menu/toolbar items, tab strips) exceed the threshold -> split.
    Round-5 lesson: strict per-word GT (the first word-level attempt)
    made every multi-word instruction ambiguous — 'Microsoft' matched
    five elements — and real-pixels text accuracy DROPPED 75.6->67.7;
    phrase grouping restores it while keeping wide toolbar items apart."""
    words = split_words(text, font)
    if not words:
        return []
    out = []
    cur_t, cur_x0, cur_x1 = words[0]
    for w, x0, x1 in words[1:]:
        if x0 - cur_x1 < width_ths * height:
            cur_t += " " + w
            cur_x1 = x1
        else:
            out.append((cur_t, cur_x0, cur_x1))
            cur_t, cur_x0, cur_x1 = w, x0, x1
    out.append((cur_t, cur_x0, cur_x1))
    return out


def pick_font(rng: np.random.Generator, text: str, size: int):
    """Random face honoring per-font banned chars (_FONT_BAN): TeX-cmap
    faces fall back to a DejaVu face when the text needs <>|\\{}."""
    path = _FONT_FILES[int(rng.integers(0, len(_FONT_FILES)))]
    ban = _FONT_BAN.get(path)
    if ban and (set(text) & ban):
        path = _FONT_FILES[int(rng.integers(0, 6))]  # system DejaVu faces
    return _font(path, size)


def _pick_colors(rng: np.random.Generator) -> Tuple[int, int]:
    """(bg, fg) grayscale with GUI-like contrast; both polarities."""
    if rng.random() < 0.65:  # dark text on light bg (dominant in GUIs)
        bg = int(rng.integers(180, 256))
        fg = int(rng.integers(0, 110))
    else:
        bg = int(rng.integers(0, 80))
        fg = int(rng.integers(160, 256))
    return bg, fg


def _pick_colors_rgb(rng: np.random.Generator):
    """(bg RGB, fg RGB) matching train/synth_gui.render_gui_scene's text
    color statistics: panels are arbitrary colors; 70% of text is pure
    black/white picked against local luminance, 30% random colors with
    >=70 mean-channel contrast."""
    bg = rng.integers(0, 256, 3)
    if rng.random() < 0.7:
        fg = np.array([0, 0, 0] if bg.mean() > 128 else [255, 255, 255])
    else:
        fg = rng.integers(0, 256, 3)
        while abs(int(fg.mean()) - int(bg.mean())) < 70:
            fg = rng.integers(0, 256, 3)
    return tuple(int(c) for c in bg), tuple(int(c) for c in fg)


def render_line(
    rng: np.random.Generator,
    text: Optional[str] = None,
    min_size: int = 10,
    max_size: int = 40,
) -> Tuple[np.ndarray, str]:
    """Render one text line -> (RGB uint8 [h,w,3] tight-ish crop, text).

    Geometry mirrors what the detector stage hands the recognizer: random
    margins around the glyphs (extract_text_boxes unclips boxes by
    ~0.4*min_side) and random vertical offset (component boxes are at 1/4
    map resolution, so up to ~4 px of slop at det scale).

    Half the renders are COLORED (random RGB panels/fg like
    train/synth_gui scenes, including mid-line background changes and
    stray panel-edge strokes in the margins) — an end-to-end quality
    gate showed a grayscale-only-trained recognizer garbles colored GUI
    text.
    """
    from PIL import Image, ImageDraw

    require_fonts()
    if text is None:
        text = sample_text(rng)
    size = int(rng.integers(min_size, max_size + 1))
    font = pick_font(rng, text, size)
    colored = rng.random() < 0.5
    if colored:
        bg, fg = _pick_colors_rgb(rng)
    else:
        bg, fg = _pick_colors(rng)

    # measure; a degenerate bbox (height < 2) means the face has no real
    # glyphs for this text — fall back to a system DejaVu face rather
    # than emit a labeled-but-blank render (training-data poison)
    probe = Image.new("L", (8, 8))
    d = ImageDraw.Draw(probe)
    x0, y0, x1, y1 = d.textbbox((0, 0), text, font=font)
    if y1 - y0 < 2:
        font = _font(_FONT_FILES[0], size)
        x0, y0, x1, y1 = d.textbbox((0, 0), text, font=font)
    tw, th = max(x1 - x0, 1), max(y1 - y0, 1)

    # detector-box jitter: margins 0..60% of text height per side
    ml = int(rng.integers(0, max(th * 6 // 10, 2)))
    mr = int(rng.integers(0, max(th * 6 // 10, 2)))
    mt = int(rng.integers(0, max(th * 6 // 10, 2)))
    mb = int(rng.integers(0, max(th * 6 // 10, 2)))
    w, h = tw + ml + mr, th + mt + mb
    img = Image.new("RGB" if colored else "L", (w, h), bg)
    idraw = ImageDraw.Draw(img)
    if colored:
        # panel boundary under part of the line (gui scenes paint text
        # across panel edges: background color can change mid-line)
        if rng.random() < 0.3:
            bg2, _ = _pick_colors_rgb(rng)
            if rng.random() < 0.7:  # vertical split
                xs = int(rng.integers(0, w))
                idraw.rectangle([xs, 0, w, h], fill=bg2)
            else:
                ys = int(rng.integers(0, h))
                idraw.rectangle([0, ys, w, h], fill=bg2)
        # stray separator / chrome stroke through the unclip margin
        if rng.random() < 0.25:
            shade = tuple(int(np.clip(c + rng.integers(-60, 60), 0, 255))
                          for c in bg)
            if rng.random() < 0.5:
                yy = int(rng.integers(0, h))
                idraw.line([(0, yy), (w, yy)], fill=shade,
                           width=int(rng.integers(1, 3)))
            else:
                xx = int(rng.integers(0, w))
                idraw.line([(xx, 0), (xx, h)], fill=shade,
                           width=int(rng.integers(1, 3)))
    idraw.text((ml - x0, mt - y0), text, fill=fg, font=font)
    arr = np.asarray(img, np.float32)

    # photometric augmentation: mild noise / blur (screens are clean)
    if rng.random() < 0.5:
        arr = arr + rng.normal(0.0, rng.uniform(1.0, 6.0), arr.shape)
    if rng.random() < 0.3:
        import cv2

        arr = cv2.GaussianBlur(arr, (3, 3), rng.uniform(0.3, 0.9))
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    # horizontal condensation: UI fonts (Segoe/SF) run ~10-25% narrower
    # than DejaVu; squeeze teaches the recognizer those letterforms
    if rng.random() < 0.45 and arr.shape[1] > 8:
        import cv2

        sx = rng.uniform(0.72, 0.98)
        arr = cv2.resize(arr, (max(int(arr.shape[1] * sx), 4), arr.shape[0]),
                         interpolation=cv2.INTER_AREA)
    # screenshot-domain artifacts (the real-pixels gap): ClearType-ish
    # subpixel fringing and JPEG blocking — real Windows/mac text is not
    # the clean grayscale PIL emits
    if rng.random() < 0.2 and arr.shape[1] > 2:
        fr = arr.astype(np.float32)
        fr[:, 1:, 0] = 0.5 * fr[:, 1:, 0] + 0.5 * fr[:, :-1, 0]
        fr[:, :-1, 2] = 0.5 * fr[:, :-1, 2] + 0.5 * fr[:, 1:, 2]
        arr = np.clip(fr, 0, 255).astype(np.uint8)
    if rng.random() < 0.25:
        import io as _io

        buf = _io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG",
                                  quality=int(rng.integers(45, 92)))
        arr = np.asarray(Image.open(buf).convert("RGB"))
    return arr, text


def render_line_buffers(
    rng: np.random.Generator,
    n: int,
    max_label_len: int = 56,
    buf_hw: Tuple[int, int] = (64, 1536),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """The host half of the recogniser's data path: n natural-size line
    renders packed top-left into fixed buffers.  Returns (bufs [n,bh,bw,3]
    uint8, hws [n,2] int32, labels [n,L] int32, texts)."""
    bh, bw = buf_hw
    bufs = np.zeros((n, bh, bw, 3), np.uint8)
    hws = np.zeros((n, 2), np.int32)
    labels = np.zeros((n, max_label_len), np.int32)
    texts: List[str] = []
    for i in range(n):
        while True:
            img, text = render_line(rng)
            h, w = img.shape[:2]
            if h <= bh and w <= bw:
                break
        bufs[i, :h, :w] = img
        hws[i] = (h, w)
        labels[i] = encode_text(text, max_label_len)
        texts.append(text)
    return bufs, hws, labels, texts


def crops_from_buffers(bufs, hws, out_hw: Tuple[int, int] = (32, 320),
                       device="cuda") -> np.ndarray:
    """Run buffered renders through the inference path's line-crop
    geometry (``ops/preprocess.crop_lines_batch``): one crop a buffer, its
    box the whole natural-size render.  On the card each is one launch of
    K3's line grid (``csrc/crop.cu``); on the CPU its plain version.
    Returns [n, out_h, out_w, 3] uint8 (values truncated, as the JAX
    package's ``astype``)."""
    import torch

    from omniparser_tpu_torch.ops.preprocess import crop_lines_batch
    from omniparser_tpu_torch.train.data import crop_each

    one_box = torch.tensor([[0.0, 0.0, 1.0, 1.0]], dtype=torch.float32)
    return crop_each(bufs, lambda buf, i: crop_lines_batch(
        buf, (int(hws[i][0]), int(hws[i][1])), one_box.to(buf.device), out_hw), device)


def render_lines_to_crops(
    rng: np.random.Generator,
    n: int,
    out_hw: Tuple[int, int] = (32, 320),
    max_label_len: int = 32,
    buf_hw: Tuple[int, int] = (64, 1024),
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """n rendered lines -> (crops [n,H,W,3] uint8, labels [n,L] int32,
    texts), the crops through the inference-path geometry."""
    bufs, hws, labels, texts = render_line_buffers(rng, n, max_label_len, buf_hw)
    return crops_from_buffers(bufs, hws, out_hw, device), labels, texts


# --------------------------- screenshot rendering ------------------------ #


def render_screenshot(
    rng: np.random.Generator, size: int = 640, max_lines: int = 40
) -> Tuple[np.ndarray, List[List[int]], List[str]]:
    """A GUI-like screenshot: panels, buttons, separators + text lines.

    Returns (RGB uint8 [size,size,3], text boxes [x1,y1,x2,y2] px, texts).
    Boxes are tight around glyphs (what the det shrink-map labels encode).
    """
    from PIL import Image, ImageDraw

    require_fonts()
    base = int(rng.integers(0, 256))
    canvas = Image.new("L", (size, size), base)
    draw = ImageDraw.Draw(canvas)

    # panels / window chrome rectangles
    for _ in range(int(rng.integers(2, 8))):
        x1, y1 = int(rng.integers(0, size - 20)), int(rng.integers(0, size - 20))
        x2 = int(rng.integers(x1 + 10, min(x1 + size, size)))
        y2 = int(rng.integers(y1 + 10, min(y1 + size, size)))
        shade = int(np.clip(base + rng.integers(-70, 70), 0, 255))
        if rng.random() < 0.5:
            draw.rectangle([x1, y1, x2, y2], fill=shade)
        else:
            draw.rectangle([x1, y1, x2, y2], outline=shade,
                           width=int(rng.integers(1, 4)))
    # thin separators
    for _ in range(int(rng.integers(0, 5))):
        y = int(rng.integers(0, size))
        shade = int(np.clip(base + rng.integers(-60, 60), 0, 255))
        draw.line([(0, y), (size, y)], fill=shade, width=1)

    arr = np.asarray(canvas, np.float32)

    boxes: List[List[int]] = []
    texts: List[str] = []
    occupied = np.zeros((size, size), bool)
    for _ in range(int(rng.integers(max_lines // 2, max_lines + 1))):
        text = sample_text(rng)
        sizept = int(rng.integers(10, 30))
        font = pick_font(rng, text, sizept)
        probe = ImageDraw.Draw(Image.new("L", (8, 8)))
        bx0, by0, bx1, by1 = probe.textbbox((0, 0), text, font=font)
        tw, th = bx1 - bx0, by1 - by0
        if tw < 2 or th < 2 or tw >= size - 2 or th >= size - 2:
            continue
        x = int(rng.integers(1, size - tw - 1))
        y = int(rng.integers(1, size - th - 1))
        # reject overlapping placements (plus a 3px guard band)
        g = 3
        ys, ye = max(y - g, 0), min(y + th + g, size)
        xs, xe = max(x - g, 0), min(x + tw + g, size)
        if occupied[ys:ye, xs:xe].any():
            continue
        # local contrast: text color against the local mean
        local = arr[y : y + th, x : x + tw].mean()
        if local > 128:
            fg = int(rng.integers(0, max(int(local) - 80, 1)))
        else:
            fg = int(rng.integers(min(int(local) + 80, 254), 256))
        tile = Image.new("L", (tw + 2, th + 2), 0)
        ImageDraw.Draw(tile).text((-bx0 + 1, -by0 + 1), text, fill=255, font=font)
        mask = np.asarray(tile, np.float32)[: th + 2, : tw + 2] / 255.0
        region = arr[y - 1 : y - 1 + mask.shape[0], x - 1 : x - 1 + mask.shape[1]]
        region[:] = region * (1 - mask) + fg * mask
        occupied[ys:ye, xs:xe] = True
        # phrase-level GT (easyocr granularity — see split_phrases);
        # draw origin is x - bx0, so phrase extents shift by -bx0
        wths = float(rng.uniform(0.45, 0.62))
        for phrase, wx0, wx1 in split_phrases(text, font, th, wths):
            boxes.append([int(x - bx0 + wx0), y,
                          min(int(x - bx0 + wx1), x + tw), y + th])
            texts.append(phrase)

    if rng.random() < 0.4:
        arr = arr + rng.normal(0.0, rng.uniform(1.0, 4.0), arr.shape)
    arr = np.clip(arr, 0, 255).astype(np.uint8)
    return np.repeat(arr[:, :, None], 3, axis=2), boxes, texts


def shrink_map(
    boxes: Sequence[Sequence[int]], size: int, factor: int = 2, shrink: float = 0.4
) -> np.ndarray:
    """DBNet-style shrink-map target at 1/factor scale (factor matches
    TextDetector.out_scale): each text rect is shrunk by the offset
    d = area*(1-r^2)/perimeter (r = 0.4), capped at 25% of the short side
    (the uncapped DBNet offset erases 8-14 px GUI text lines), before
    painting, so that adjacent lines stay apart in the map."""
    s = size // factor
    out = np.zeros((s, s), np.float32)
    for x1, y1, x2, y2 in boxes:
        w, h = x2 - x1, y2 - y1
        if w <= 0 or h <= 0:
            continue
        d = min(w * h * (1 - shrink**2) / (2 * (w + h)), 0.25 * min(w, h))
        sx1 = int(round((x1 + d) / factor))
        sy1 = int(round((y1 + d) / factor))
        sx2 = int(round((x2 - d) / factor))
        sy2 = int(round((y2 - d) / factor))
        # never shrink to nothing: keep at least the centre cell
        if sx2 <= sx1:
            cx = (x1 + x2) / 2 / factor
            sx1, sx2 = int(cx), int(cx) + 1
        if sy2 <= sy1:
            cy = (y1 + y2) / 2 / factor
            sy1, sy2 = int(cy), int(cy) + 1
        out[max(sy1, 0) : min(sy2, s), max(sx1, 0) : min(sx2, s)] = 1.0
    return out
