"""The captioner trainer's caption table: one phrase per glyph family of
``train/synth_gui.ICON_KINDS``.  The eval harnesses phrase their icon
instructions with it (``eval/synth_bench.make_dataset``); the trainer
itself joins it with ROADMAP A.11.
"""

from __future__ import annotations

from typing import Dict

# one caption phrase per glyph family; all fit greedy max_new_tokens=20
# (CaptionerConfig default) with bos/eos under the char-level fallback
# tokenizer
CAPTIONS: Dict[str, str] = {
    "button": "button icon",
    "gear": "settings icon",
    "hamburger": "menu icon",
    "magnifier": "search icon",
    "arrow": "arrow icon",
    "star": "favorite icon",
    "cross": "close icon",
    "plus": "add icon",
    "dots": "more options icon",
    "folder": "folder icon",
    "toggle": "toggle icon",
    "ring": "circle icon",
    "thumbnail": "image icon",
    "chevron": "expand icon",
    # families (train/synth_gui.ICON_KINDS additions, matched to
    # the icons annotated in eval/real_gt.json); every phrase fits MAX_T
    # (<= 18 chars + bos/eos)
    "bell": "notifications icon"[:18],
    "chat": "chat icon",
    "calendar": "calendar icon",
    "phone": "phone icon",
    "cloud": "cloud icon",
    "smiley": "emoji icon",
    "send": "send icon",
    "refresh": "refresh icon",
    "grid": "apps icon",
    "mic": "microphone icon",
    "camera": "camera icon",
    "undo": "undo icon",
    "bold": "bold icon",
    "italic": "italic icon",
    "underline": "underline icon",
    "wifi": "wifi icon",
    "battery": "battery icon",
    "music": "music icon",
    # left arrows are their own family (real back buttons
    # ground against this exact phrase — eval/real_gt.json)
    "back": "back arrow icon",
}
