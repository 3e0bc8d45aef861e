"""Byte-level BPE tokenizer (BART/GPT2 family), self-contained.

Florence-2 uses a BART tokenizer (vocab.json + merges.txt, byte-level BPE
with the GPT-2 pre-tokenization pattern).  This from-scratch implementation
loads standard HF files when a checkpoint directory is given, and degrades
to a structural fallback otherwise (random-weight runs don't need
linguistic fidelity, only a total encode/decode).  The ``regex`` package
is imported only when a ``ByteLevelBPE`` first encodes: the fallback
tokenizer needs nothing beyond the standard library.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional

# GPT-2 pre-tokenization pattern (used by BART/RoBERTa byte-level BPE)
_PAT_SRC = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@lru_cache()
def _pattern():
    import regex

    return regex.compile(_PAT_SRC)


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(
        range(ord("\xae"), ord("\xff") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class ByteLevelBPE:
    """Standard byte-level BPE: encode/decode matching HF slow tokenizers."""

    def __init__(self, vocab: Dict[str, int], merges: List[tuple],
                 special_tokens: Optional[Dict[str, int]] = None,
                 bos: int = 0, eos: int = 2, pad: int = 1):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.special = special_tokens or {}
        self.inv_special = {v: k for k, v in self.special.items()}
        self.bos, self.eos, self.pad = bos, eos, pad
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self._bpe_cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPE":
        """Load from an HF checkpoint dir: tokenizer.json, or
        vocab.json + merges.txt."""
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            data = json.load(open(tj))
            vocab = data["model"]["vocab"]
            merges = [tuple(m.split(" ") if isinstance(m, str) else m)
                      for m in data["model"]["merges"]]
            special = {t["content"]: t["id"] for t in data.get("added_tokens", [])}
            return cls(vocab, merges, special)
        vocab = json.load(open(os.path.join(path, "vocab.json")))
        merges = []
        with open(os.path.join(path, "merges.txt")) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#version"):
                    merges.append(tuple(line.split(" ")))
        special = {}
        at = os.path.join(path, "added_tokens.json")
        if os.path.exists(at):
            special = json.load(open(at))
        return cls(vocab, merges, special)

    def _bpe(self, token: str) -> List[str]:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        parts = list(token)
        while len(parts) > 1:
            pairs = [(self.ranks.get((parts[i], parts[i + 1]), 1 << 30), i)
                     for i in range(len(parts) - 1)]
            best_rank, i = min(pairs)
            if best_rank == 1 << 30:
                break
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
        self._bpe_cache[token] = parts
        return parts

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = []
        for tok in _pattern().findall(text):
            mapped = "".join(self.byte_enc[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.vocab.get(piece, self.vocab.get("<unk>", 3)))
        if add_special:
            ids = [self.bos] + ids + [self.eos]
        return ids

    def decode(self, ids: List[int], skip_special: bool = True) -> str:
        out = []
        for i in ids:
            if skip_special and i in (self.bos, self.eos, self.pad):
                continue
            if i in self.inv_special:
                if not skip_special:
                    out.append(self.inv_special[i])
                continue
            out.append(self.inv_vocab.get(i, ""))
        text = "".join(out)
        data = bytearray(self.byte_dec[c] for c in text if c in self.byte_dec)
        return bytes(data).decode("utf-8", errors="replace")


class FallbackTokenizer:
    """Structural stand-in when no tokenizer files exist (random-weight
    runs): reversible for ASCII, arbitrary ids decode deterministically."""

    bos, eos, pad = 0, 2, 1
    _OFFSET = 10  # ids 0..9 reserved for specials

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = [ord(c) % 0x4000 + self._OFFSET for c in text]
        return [self.bos] + ids + [self.eos] if add_special else ids

    def decode(self, ids: List[int], skip_special: bool = True) -> str:
        chars = []
        for i in ids:
            if i < self._OFFSET:
                continue
            c = (i - self._OFFSET) % 0x4000
            chars.append(chr(c) if 32 <= c < 0xD800 else "?")
        return "".join(chars)


def load_tokenizer(path: Optional[str]):
    """BPE from an HF checkpoint dir if available, else the fallback."""
    if path:
        if os.path.exists(os.path.join(path, "tokenizer.json")) or os.path.exists(
            os.path.join(path, "vocab.json")
        ):
            return ByteLevelBPE.from_dir(path)
    return FallbackTokenizer()
