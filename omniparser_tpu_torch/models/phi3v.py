"""Phi-3-Vision-class captioner in PyTorch.

The reference's other icon captioner (``get_parsed_content_icon_phi3v``):
a chat prompt around the image, batches of 5, greedy decoding of 25 new
tokens.  The architecture (phi-3-vision-128k-instruct shapes):

  * CLIP-ViT-L/14 @ 336 vision tower (pre-LN, quickGELU, class token);
    patch features of the penultimate layer, class token dropped.  Only
    the layers that feed that output are built: 23 of the checkpoint's 24;
  * each 2x2 neighbourhood of patch features concatenated into 4C channels,
    then the two-linear GELU projector (``img_projection``): 144 image
    tokens for one 336 crop;
  * Phi-3 decoder: RMSNorm, fused ``qkv_proj``, rotate-half RoPE over the
    full head dim, fused ``gate_up_proj`` with SiLU, untied ``lm_head``,
    over [prompt prefix ++ image tokens ++ prompt suffix] with a static
    [B, H, L, hd] KV cache of prompt + max_new_tokens positions.

The numerics are the JAX package's (``omniparser_tpu/models/phi3v.py``),
not upstream's where the two differ: every norm has flax's default epsilon
(1e-6), the projector's GELU is the tanh form, RoPE is plain theta = 10000
(no ``su`` scaling), one 336 crop with no HD tiling.  Norms, softmaxes and
the LM head compute in float32, and the token table and ``lm_head`` stay
float32 under a bfloat16 build (rows cast per lookup).  Attribute names
follow the JAX parameter tree, so ``weights/convert.py`` carries its trees
over by name.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from omniparser_tpu_torch.config import CaptionerConfig
from omniparser_tpu_torch.models.blip2 import _attend, _ln

NORM_EPS = 1e-6  # flax's default, for the LayerNorms and the RMSNorms


@dataclasses.dataclass(frozen=True)
class Phi3VDims:
    # vision tower (CLIP ViT-L/14 @ 336)
    image_size: int = 336
    patch_size: int = 14
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    vision_mlp: int = 4096
    feature_layer: int = -2  # penultimate-layer patch features (HF phi3v)
    # language model (phi-3-mini)
    lm_width: int = 3072
    lm_layers: int = 32
    lm_heads: int = 32
    lm_mlp: int = 8192
    vocab_size: int = 32064
    max_positions: int = 4096
    rope_theta: float = 10000.0
    # special ids (phi-3 tokenizer)
    pad_token_id: int = 32000
    eos_token_id: int = 32000  # <|endoftext|>; <|end|> = 32007 also stops
    end_token_id: int = 32007

    @property
    def vision_layers_run(self) -> int:
        """The tower layers that feed the selected feature layer."""
        return self.vision_layers + self.feature_layer + 1


PHI3V_BASE = Phi3VDims()

TINY_PHI3V = Phi3VDims(
    image_size=28, patch_size=14, vision_width=16, vision_layers=2,
    vision_heads=2, vision_mlp=32, lm_width=32, lm_layers=2, lm_heads=4,
    lm_mlp=64, vocab_size=96, max_positions=128,
    pad_token_id=93, eos_token_id=94, end_token_id=95,
)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _rms(x: torch.Tensor, norm: nn.RMSNorm, dtype) -> torch.Tensor:
    return F.rms_norm(x.float(), norm.normalized_shape, norm.weight, norm.eps).to(dtype)


class ClipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        sp = lambda t: t.reshape(b, n, self.heads, hd).transpose(1, 2)
        out = _attend(sp(self.q_proj(x)) * hd ** -0.5, sp(self.k_proj(x)), sp(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class ClipLayer(nn.Module):
    def __init__(self, d: Phi3VDims):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(d.vision_width, eps=NORM_EPS)
        self.self_attn = ClipAttention(d.vision_width, d.vision_heads)
        self.layer_norm2 = nn.LayerNorm(d.vision_width, eps=NORM_EPS)
        self.fc1 = nn.Linear(d.vision_width, d.vision_mlp)
        self.fc2 = nn.Linear(d.vision_mlp, d.vision_width)

    def forward(self, x):
        x = x + self.self_attn(_ln(x, self.layer_norm1, x.dtype))
        return x + self.fc2(quick_gelu(self.fc1(_ln(x, self.layer_norm2, x.dtype))))


class ClipViT(nn.Module):
    """CLIP vision tower: [B, 3, S, S] -> patch features [B, (S/P)^2,
    width] of the layer dims.feature_layer selects (class token dropped)."""

    def __init__(self, d: Phi3VDims):
        super().__init__()
        n = (d.image_size // d.patch_size) ** 2
        self.layers = d.vision_layers_run
        self.patch_embedding = nn.Conv2d(3, d.vision_width, d.patch_size, d.patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d.vision_width))
        self.position_embedding = nn.Parameter(torch.zeros(1 + n, d.vision_width))
        self.pre_layrnorm = nn.LayerNorm(d.vision_width, eps=NORM_EPS)  # HF's spelling
        for i in range(self.layers):
            setattr(self, f"layers_{i}", ClipLayer(d))

    def forward(self, pixel_values):
        dt = self.patch_embedding.weight.dtype
        x = self.patch_embedding(pixel_values.to(dt)).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.to(dt).expand(x.shape[0], 1, -1), x], dim=1)
        x = _ln(x + self.position_embedding.to(dt), self.pre_layrnorm, dt)
        for i in range(self.layers):
            x = getattr(self, f"layers_{i}")(x)
        return x[:, 1:]


def rope_inv_freq(head_dim: int, theta: float) -> torch.Tensor:
    """[head_dim // 2] float32 inverse frequencies (computed in float64)."""
    return torch.from_numpy((1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim)))
                            .astype(np.float32))


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor, dtype):
    """[P] int positions -> (cos, sin) [P, head_dim // 2], computed in
    float32 and cast to `dtype`."""
    ang = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(t, cos, sin):
    """t [..., P, D]; the rotate-half convention (HF Phi-3); cos and sin
    [P, D // 2] in t's dtype."""
    d2 = t.shape[-1] // 2
    t1, t2 = t[..., :d2], t[..., d2:]
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)


class Phi3Layer(nn.Module):
    def __init__(self, d: Phi3VDims):
        super().__init__()
        self.heads = d.lm_heads
        self.input_layernorm = nn.RMSNorm(d.lm_width, eps=NORM_EPS)
        self.qkv_proj = nn.Linear(d.lm_width, 3 * d.lm_width, bias=False)
        self.o_proj = nn.Linear(d.lm_width, d.lm_width, bias=False)
        self.post_attention_layernorm = nn.RMSNorm(d.lm_width, eps=NORM_EPS)
        self.gate_up_proj = nn.Linear(d.lm_width, 2 * d.lm_mlp, bias=False)
        self.down_proj = nn.Linear(d.lm_mlp, d.lm_width, bias=False)

    def forward(self, x, cos, sin, cache: List[torch.Tensor], start: int):
        """x [B, n, D] at positions start..start+n-1: its keys and values
        go into cache = [k, v] ([B, H, L, hd]) there, and it attends to
        the cache's first start+n positions (causally within x)."""
        b, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv_proj(_rms(x, self.input_layernorm, x.dtype))
        # [3, B, H, n, hd]; q and k rotate in one pass
        qkv = qkv.reshape(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        qk = apply_rope(qkv[:2], cos, sin)
        end = start + n
        cache[0][:, :, start:end] = qk[1]
        cache[1][:, :, start:end] = qkv[2]
        mask = None
        if n > 1:
            mask = (torch.arange(end, device=x.device)[None, :]
                    <= torch.arange(start, end, device=x.device)[:, None])
        o = _attend(qk[0] * hd ** -0.5, cache[0][:, :, :end], cache[1][:, :, :end], mask)
        x = x + self.o_proj(o.transpose(1, 2).reshape(b, n, c))
        gate, up = self.gate_up_proj(_rms(x, self.post_attention_layernorm, x.dtype)).chunk(2, -1)
        return x + self.down_proj(F.silu(gate) * up)


class Phi3V(nn.Module):
    """Vision tower + projector + Phi-3 decoder, with a prefill and a
    one-token decode over a static cache."""

    def __init__(self, dims: Phi3VDims = PHI3V_BASE):
        super().__init__()
        d = self.dims = dims
        self.vision = ClipViT(d)
        self.proj_1 = nn.Linear(4 * d.vision_width, d.lm_width)
        self.proj_2 = nn.Linear(d.lm_width, d.lm_width)
        self.embed_tokens = nn.Embedding(d.vocab_size, d.lm_width)  # float32
        for i in range(d.lm_layers):
            setattr(self, f"layers_{i}", Phi3Layer(d))
        self.final_norm = nn.RMSNorm(d.lm_width, eps=NORM_EPS)
        self.lm_head = nn.Linear(d.lm_width, d.vocab_size, bias=False)  # float32
        self._inv_freq = {}  # RoPE inverse frequencies by device

    @property
    def dtype(self):
        return self.proj_1.weight.dtype

    def image_embeds(self, pixel_values):
        """[B, 3, S, S] -> [B, (n/2)^2, lm_width]: each 2x2 neighbourhood of
        the n x n patch grid concatenated row-major into 4C channels (the
        checkpoint's img_projection input), then Linear-GELU-Linear."""
        d = self.dims
        f = self.vision(pixel_values)
        n, b = d.image_size // d.patch_size, f.shape[0]
        f = f.reshape(b, n // 2, 2, n // 2, 2, d.vision_width).permute(0, 1, 3, 2, 4, 5)
        f = f.reshape(b, (n // 2) ** 2, 4 * d.vision_width)
        return self.proj_2(F.gelu(self.proj_1(f), approximate="tanh"))

    def new_caches(self, batch: int, length: int, device) -> List[List[torch.Tensor]]:
        d = self.dims
        shape = (batch, d.lm_heads, length, d.lm_width // d.lm_heads)
        return [[torch.zeros(shape, dtype=self.dtype, device=device) for _ in range(2)]
                for _ in range(d.lm_layers)]

    def _embed(self, ids):
        return self.embed_tokens(ids).to(self.dtype)

    def _run(self, x, start: int, caches):
        """The decoder over x [B, n, D] at positions start.. -> final-normed
        hidden states [B, n, D] in float32."""
        d = self.dims
        inv = self._inv_freq.get(x.device)
        if inv is None:  # once a device: a host copy would wait for the queue
            inv = self._inv_freq[x.device] = rope_inv_freq(
                d.lm_width // d.lm_heads, d.rope_theta).to(x.device)
        cos, sin = rope_tables(torch.arange(start, start + x.shape[1], device=x.device), inv,
                               x.dtype)
        for i, cache in enumerate(caches):
            x = getattr(self, f"layers_{i}")(x, cos, sin, cache, start)
        return _rms(x, self.final_norm, torch.float32)

    def logits(self, h):
        return h.float() @ self.lm_head.weight.float().T

    def prefill(self, pixel_values, prefix_ids, suffix_ids, extra: int):
        """[prefix ++ image tokens ++ suffix] into fresh caches of P + extra
        positions -> (final-normed hidden states [B, P, D], caches, P).
        prefix_ids / suffix_ids: [p] / [s] token ids shared by the batch."""
        img = self.image_embeds(pixel_values)
        b = img.shape[0]
        x = torch.cat([self._embed(prefix_ids)[None].expand(b, -1, -1), img,
                       self._embed(suffix_ids)[None].expand(b, -1, -1)], dim=1)
        caches = self.new_caches(b, x.shape[1] + extra, x.device)
        return self._run(x, 0, caches), caches, x.shape[1]

    def forward_prompt(self, pixel_values, prefix_ids, suffix_ids, extra: int = 0):
        """Logits [B, P, V] of every prompt position, and (caches of P +
        extra positions, P)."""
        h, caches, p = self.prefill(pixel_values, prefix_ids, suffix_ids, extra)
        return self.logits(h), (caches, p)

    def decode_one(self, token_ids, pos_index: int, caches):
        """One token per row, token_ids [B], at absolute position pos_index
        -> logits [B, V]; the caches gain that position."""
        return self.logits(self._run(self._embed(token_ids[:, None]), pos_index, caches))[:, 0]


@torch.no_grad()
def phi3v_generate(model: Phi3V, pixel_values, prefix_ids, suffix_ids,
                   max_new_tokens: int = 25) -> torch.Tensor:
    """Greedy generation (the reference's do_sample=False) -> [B,
    max_new_tokens] int32: token 0 from the prefill's last logits, then one
    decode step a token; after eos or <|end|> every token is pad.  argmax
    takes the first of equal maxima, as jnp.argmax does."""
    d = model.dims
    h, caches, p = model.prefill(pixel_values, prefix_ids, suffix_ids, max_new_tokens)
    tok = model.logits(h[:, -1]).argmax(-1)
    done = (tok == d.eos_token_id) | (tok == d.end_token_id)
    out = [tok]
    for i in range(max_new_tokens - 1):
        nxt = model.decode_one(tok, p + i, caches).argmax(-1)
        nxt = torch.where(done, torch.full_like(nxt, d.pad_token_id), nxt)
        done = done | (nxt == d.eos_token_id) | (nxt == d.end_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).to(torch.int32)


# CLIP normalisation (HF Phi3VProcessor / CLIPImageProcessor)
_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)
# the chat template around the image placeholder, then the generation prompt
PROMPT_PREFIX = "<|user|>\n"
PROMPT_SUFFIX = "\ndescribe the icon in one sentence<|end|>\n<|assistant|>\n"
# float32 parameters under a bfloat16 build: the token table and the LM head
KEEP_F32 = ("embed_tokens", "lm_head")


def build_phi3v(dims: Phi3VDims, state, dtype: torch.dtype, device, seed: int = 0) -> Phi3V:
    """A Phi3V on `device` in `dtype`: from `state` (strict), or seeded with
    a generator on `device` itself, so that a full-width model (4.1 G
    parameters) never takes its float32 draw on the host.  The module is
    made on the meta device first and takes its memory once."""
    from omniparser_tpu_torch.weights.init import cast_compute_dtype, seeded_init_, to_tensor_state

    with torch.device("meta"):
        model = Phi3V(dims)
    if state is None:
        model = model.to_empty(device=device)
        seeded_init_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(to_tensor_state(state), strict=True, assign=True)
    cast_compute_dtype(model, dtype, KEEP_F32)
    return model.to(device).eval()


class Phi3VCaptioner:
    """Pipeline captioner (the caption_crops protocol, outside the fused
    step): crops are resized bilinearly to 336 (antialiased where they
    shrink), CLIP normalised, zero-padded to a multiple of `batch_size`
    (the reference's 5) and decoded greedily, min(max_new_tokens, 25) new
    tokens.  The prompt ids are the tokenizer's ids modulo the vocabulary:
    like the JAX package, this one has no Phi-3 SentencePiece tokenizer,
    so a real checkpoint's captions are token ids through the fallback
    tokenizer.  ``generate_calls`` counts the batched decodes."""

    fusable = False  # the greedy decode runs outside the fused device step

    def __init__(self, config: CaptionerConfig, dims: Phi3VDims = PHI3V_BASE, state=None,
                 tokenizer=None, batch_size: int = 5, seed: int = 0, device="cuda"):
        from omniparser_tpu_torch.utils.device import resolve_device

        self.config = config
        self.dims = dims
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.generate_calls = 0
        if tokenizer is None:
            from omniparser_tpu_torch.models.tokenizer import load_tokenizer

            tokenizer = load_tokenizer(None)
        self.tokenizer = tokenizer
        enc = lambda s: np.asarray([t % dims.vocab_size
                                    for t in tokenizer.encode(s, add_special=False)], np.int64)
        self.prefix_ids, self.suffix_ids = enc(PROMPT_PREFIX), enc(PROMPT_SUFFIX)
        self.max_new_tokens = min(config.max_new_tokens, 25) or 25
        self.model = build_phi3v(dims, state, getattr(torch, config.dtype), self.device, seed)
        self._mean = torch.tensor(_MEAN, dtype=torch.float32, device=self.device)[:, None, None]
        self._std = torch.tensor(_STD, dtype=torch.float32, device=self.device)[:, None, None]

    @classmethod
    def from_checkpoint(cls, path: str, config: CaptionerConfig,
                        dims: Optional[Phi3VDims] = None, device="cuda"):
        """An HF microsoft/Phi-3-vision directory (every ``*.safetensors``
        shard; ``weights/convert_phi3v.py``) at `dims`, default the
        published dims at the checkpoint's own depth."""
        from omniparser_tpu_torch.weights.convert_phi3v import load_phi3v_state

        state, dims = load_phi3v_state(path, dims)
        return cls(config, dims, state, device=device)

    def preprocess(self, crops_f255: torch.Tensor) -> torch.Tensor:
        """[N, s, s, 3] float crops in [0,255] -> [N, 3, S, S] CLIP-normalised."""
        s = self.dims.image_size
        x = F.interpolate(crops_f255.permute(0, 3, 1, 2).float(), size=(s, s),
                          mode="bilinear", align_corners=False, antialias=True)
        return (x / 255.0 - self._mean) / self._std

    def generate(self, crops_f255: torch.Tensor) -> torch.Tensor:
        """Tokens [N, max_new] int32 for N crops (one batch)."""
        self.generate_calls += 1
        ids = lambda a: torch.from_numpy(a).to(self.device)
        return phi3v_generate(self.model, self.preprocess(crops_f255), ids(self.prefix_ids),
                              ids(self.suffix_ids), self.max_new_tokens)

    def tokens_to_text(self, token_row) -> str:
        d = self.dims
        ids = []
        for t in np.asarray(token_row):
            if int(t) in (d.pad_token_id, d.eos_token_id, d.end_token_id):
                break
            ids.append(int(t))
        return self.tokenizer.decode(ids).strip("\n").strip()

    def caption_crops(self, crops, valid) -> List[str]:
        """crops [N, s, s, 3] float in [0,255]; valid [N] bool.  Captions for
        the valid slots, in order.  A batch of 5 with no valid slot is not
        decoded (the JAX package decodes it and drops its captions)."""
        n, bs = crops.shape[0], self.batch_size
        valid = np.asarray(valid, bool)
        pad_n = -(-n // bs) * bs
        if pad_n != n:
            crops = torch.cat([crops, crops.new_zeros((pad_n - n,) + tuple(crops.shape[1:]))])
        out: List[str] = []
        for s in range(0, n, bs):
            if valid[s:s + bs].any():
                toks = self.generate(crops[s:s + bs]).cpu().numpy()
                out.extend(self.tokens_to_text(t) for t, v in zip(toks, valid[s:s + bs]) if v)
        return out
