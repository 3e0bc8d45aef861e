"""BLIP-2-class captioner in PyTorch: EVA-ViT-g + Q-Former + OPT.

The reference's other caption model (Salesforce/blip2-opt-2.7b), generated
with the prompt "The image shows", num_beams=5, no_repeat_ngram_size=2:

  * EVA-CLIP ViT vision tower: pre-LN blocks, packed-QKV attention, a class
    token and learned positions;
  * Q-Former: BERT-family (post-LN) layers over 32 learned query tokens,
    with cross-attention to the image features every ``cross_frequency``
    layers;
  * OPT decoder: pre-LN, ReLU FFN, learned positions with the +2 offset,
    the LM head tied to the token table, over [projected queries ++ prompt
    embeds], with a static KV cache of prefix + max_new_tokens;
  * beam decoding through ``models/generate.beam_search``.

Attribute names follow the JAX package's parameter tree so that
``weights/convert.py`` carries its trees over by name; norms (flax's
default epsilon, 1e-6, as the JAX package has them), softmaxes and the LM
head compute in float32, and the token table stays float32 (the JAX
package keeps its parameters in float32 and computes in the module dtype).
Attention is written out.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from omniparser_tpu_torch.config import CaptionerConfig
from omniparser_tpu_torch.models.generate import beam_search

LN_EPS = 1e-6  # flax LayerNorm's default


@dataclasses.dataclass(frozen=True)
class Blip2Dims:
    """blip2-opt-2.7b dims (HF Blip2Config defaults)."""

    image_size: int = 224
    patch_size: int = 14
    vision_width: int = 1408
    vision_layers: int = 39
    vision_heads: int = 16
    vision_mlp: int = 6144
    num_query_tokens: int = 32
    qformer_width: int = 768
    qformer_layers: int = 12
    qformer_heads: int = 12
    qformer_mlp: int = 3072
    cross_frequency: int = 2
    lm_width: int = 2560
    lm_layers: int = 32
    lm_heads: int = 32
    lm_mlp: int = 10240
    vocab_size: int = 50272
    max_positions: int = 2048
    bos_token_id: int = 2
    eos_token_id: int = 50118  # OPT caption models stop at '\n'
    pad_token_id: int = 1


BLIP2_OPT_2_7B = Blip2Dims()

TINY_BLIP2 = Blip2Dims(
    image_size=28, patch_size=14, vision_width=16, vision_layers=2,
    vision_heads=2, vision_mlp=32, num_query_tokens=4, qformer_width=16,
    qformer_layers=2, qformer_heads=2, qformer_mlp=32, cross_frequency=2,
    lm_width=32, lm_layers=2, lm_heads=4, lm_mlp=64, vocab_size=96,
    max_positions=128, eos_token_id=95,  # an in-vocabulary eos for the tiny dims
)


def _ln(x: torch.Tensor, ln: nn.LayerNorm, dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dtype)


def _attend(q, k, v, mask=None):
    """q [B,H,Q,hd] (already scaled), k/v [B,H,K,hd]; softmax in float32,
    masked slots at the dtype's lowest value."""
    a = q @ k.transpose(-1, -2)
    if mask is not None:
        a = a.masked_fill(~mask, torch.finfo(a.dtype).min)
    return torch.softmax(a.float(), dim=-1).to(v.dtype) @ v


class EvaAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.projection = nn.Linear(width, width)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        sp = lambda t: t.reshape(b, n, self.heads, hd).transpose(1, 2)
        out = _attend(sp(q) * hd ** -0.5, sp(k), sp(v))
        return self.projection(out.transpose(1, 2).reshape(b, n, c))


class EvaViT(nn.Module):
    """Pre-LN CLIP-family tower: [B, 3, S, S] -> [B, 1 + (S/P)^2, width]."""

    def __init__(self, d: Blip2Dims):
        super().__init__()
        self.layers = d.vision_layers
        self.patch_embedding = nn.Conv2d(3, d.vision_width, d.patch_size, d.patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(d.vision_width))
        self.position_embedding = nn.Parameter(
            torch.zeros((d.image_size // d.patch_size) ** 2 + 1, d.vision_width))
        for i in range(d.vision_layers):
            setattr(self, f"l{i}_ln1", nn.LayerNorm(d.vision_width, eps=LN_EPS))
            setattr(self, f"l{i}_attn", EvaAttention(d.vision_width, d.vision_heads))
            setattr(self, f"l{i}_ln2", nn.LayerNorm(d.vision_width, eps=LN_EPS))
            setattr(self, f"l{i}_fc1", nn.Linear(d.vision_width, d.vision_mlp))
            setattr(self, f"l{i}_fc2", nn.Linear(d.vision_mlp, d.vision_width))
        self.post_layernorm = nn.LayerNorm(d.vision_width, eps=LN_EPS)

    def forward(self, pixel_values):
        dt = self.patch_embedding.weight.dtype
        x = self.patch_embedding(pixel_values.to(dt)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding[: x.shape[1]].to(dt)
        for i in range(self.layers):
            g = lambda name: getattr(self, f"l{i}_{name}")
            x = x + g("attn")(_ln(x, g("ln1"), dt))
            y = F.gelu(g("fc1")(_ln(x, g("ln2"), dt)))
            x = x + g("fc2")(y)
        return _ln(x, self.post_layernorm, dt)


class BertAttention(nn.Module):
    """BERT-family (post-LN) self or cross attention block half."""

    def __init__(self, width: int, heads: int, kv_width: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(kv_width or width, width)
        self.value = nn.Linear(kv_width or width, width)
        self.output_dense = nn.Linear(width, width)
        self.output_ln = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, x, kv=None):
        b, n, c = x.shape
        kv = x if kv is None else kv
        hd = c // self.heads
        sp = lambda t: t.reshape(b, -1, self.heads, hd).transpose(1, 2)
        out = _attend(sp(self.query(x)) * hd ** -0.5, sp(self.key(kv)), sp(self.value(kv)))
        out = self.output_dense(out.transpose(1, 2).reshape(b, n, c))
        return _ln(out + x, self.output_ln, x.dtype)


class QFormer(nn.Module):
    """Learned queries attending to the image features (the caption path
    has no text input)."""

    def __init__(self, d: Blip2Dims):
        super().__init__()
        self.layers, self.cross_frequency = d.qformer_layers, d.cross_frequency
        self.query_tokens = nn.Parameter(torch.zeros(1, d.num_query_tokens, d.qformer_width))
        self.layernorm = nn.LayerNorm(d.qformer_width, eps=LN_EPS)
        for i in range(d.qformer_layers):
            setattr(self, f"l{i}_self", BertAttention(d.qformer_width, d.qformer_heads))
            if i % d.cross_frequency == 0:
                setattr(self, f"l{i}_cross", BertAttention(d.qformer_width, d.qformer_heads,
                                                           d.vision_width))
            setattr(self, f"l{i}_fc1", nn.Linear(d.qformer_width, d.qformer_mlp))
            setattr(self, f"l{i}_fc2", nn.Linear(d.qformer_mlp, d.qformer_width))
            setattr(self, f"l{i}_ffn_ln", nn.LayerNorm(d.qformer_width, eps=LN_EPS))

    def forward(self, image_embeds):
        dt = image_embeds.dtype
        x = self.query_tokens.to(dt).expand(image_embeds.shape[0], -1, -1)
        x = _ln(x, self.layernorm, dt)
        for i in range(self.layers):
            g = lambda name: getattr(self, f"l{i}_{name}")
            x = g("self")(x)
            if i % self.cross_frequency == 0:
                x = g("cross")(x, kv=image_embeds)
            y = g("fc2")(F.gelu(g("fc1")(x)))
            x = _ln(x + y, g("ffn_ln"), dt)
        return x


class OptLayer(nn.Module):
    def __init__(self, d: Blip2Dims):
        super().__init__()
        self.heads = d.lm_heads
        self.self_attn_layer_norm = nn.LayerNorm(d.lm_width, eps=LN_EPS)
        self.q_proj = nn.Linear(d.lm_width, d.lm_width)
        self.k_proj = nn.Linear(d.lm_width, d.lm_width)
        self.v_proj = nn.Linear(d.lm_width, d.lm_width)
        self.out_proj = nn.Linear(d.lm_width, d.lm_width)
        self.final_layer_norm = nn.LayerNorm(d.lm_width, eps=LN_EPS)
        self.fc1 = nn.Linear(d.lm_width, d.lm_mlp)
        self.fc2 = nn.Linear(d.lm_mlp, d.lm_width)

    def forward(self, x, mask, cache: List[torch.Tensor], start: int):
        """x [B, n, D] at positions start..start+n-1; its keys and values
        are written into cache = [k, v] ([B, H, L, hd]) at those positions,
        and attention reads the whole cache under `mask` [.., n, L]."""
        b, n, c = x.shape
        hd = c // self.heads
        y = _ln(x, self.self_attn_layer_norm, x.dtype)
        sp = lambda t: t.reshape(b, n, self.heads, hd).transpose(1, 2)
        cache[0][:, :, start:start + n] = sp(self.k_proj(y))
        cache[1][:, :, start:start + n] = sp(self.v_proj(y))
        o = _attend(sp(self.q_proj(y)) * hd ** -0.5, cache[0], cache[1], mask)
        x = x + self.out_proj(o.transpose(1, 2).reshape(b, n, c))
        y = F.relu(self.fc1(_ln(x, self.final_layer_norm, x.dtype)))
        return x + self.fc2(y)


class OptDecoder(nn.Module):
    """OPT decoder over a static KV cache (one [k, v] pair a layer, each
    [B, H, L, hd], so that attention reads it without a copy)."""

    def __init__(self, d: Blip2Dims):
        super().__init__()
        self.dims = d
        self.embed_tokens = nn.Embedding(d.vocab_size, d.lm_width)  # float32: the LM head
        self.embed_positions = nn.Embedding(d.max_positions + 2, d.lm_width)
        self.final_layer_norm = nn.LayerNorm(d.lm_width, eps=LN_EPS)
        for i in range(d.lm_layers):
            setattr(self, f"layer{i}", OptLayer(d))

    @property
    def dtype(self):
        return self.layer0.q_proj.weight.dtype

    def new_caches(self, batch: int, length: int, device) -> List[List[torch.Tensor]]:
        d = self.dims
        shape = (batch, d.lm_heads, length, d.lm_width // d.lm_heads)
        return [[torch.zeros(shape, dtype=self.dtype, device=device) for _ in range(2)]
                for _ in range(d.lm_layers)]

    def _run(self, h, mask, caches, start: int):
        for i, cache in enumerate(caches):
            h = getattr(self, f"layer{i}")(h, mask, cache, start)
        h = _ln(h, self.final_layer_norm, h.dtype)
        return h[:, -1:].float() @ self.embed_tokens.weight.float().T

    def prefill(self, inputs_embeds, caches):
        """The prefix (image queries ++ prompt) into the caches' first
        positions -> logits of the last position [B, 1, V]."""
        b, p, _ = inputs_embeds.shape
        L = caches[0][0].shape[2]
        dev = inputs_embeds.device
        pos = self.embed_positions(torch.arange(p, device=dev) + 2).to(self.dtype)
        h = (inputs_embeds + pos[None]).to(self.dtype)
        # causal over the prefix; cache slots past it hold nothing yet
        mask = torch.arange(L, device=dev)[None, :] <= torch.arange(p, device=dev)[:, None]
        return self._run(h, mask[None, None], caches, 0)

    def decode_one(self, token_ids, pos_index: int, caches):
        """One token [B, 1] at absolute position pos_index -> logits [B, 1, V]."""
        dev = token_ids.device
        L = caches[0][0].shape[2]
        h = (self.embed_tokens(token_ids).to(self.dtype)
             + self.embed_positions.weight[pos_index + 2].to(self.dtype))
        visible = (torch.arange(L, device=dev) <= pos_index)[None, None, None, :]
        return self._run(h, visible, caches, pos_index)


class Blip2(nn.Module):
    def __init__(self, dims: Blip2Dims = BLIP2_OPT_2_7B):
        super().__init__()
        self.dims = dims
        self.vision_model = EvaViT(dims)
        self.qformer = QFormer(dims)
        self.language_projection = nn.Linear(dims.qformer_width, dims.lm_width)
        self.language_model = OptDecoder(dims)

    def encode_and_prefill(self, pixel_values, prompt_ids, cache_len: int):
        """Image [B, 3, S, S] -> queries -> projected embeds ++ prompt
        embeds; prefill the LM.  Returns (last-position logits [B, 1, V],
        caches of length cache_len, prefix length)."""
        lm = self.language_model
        q_emb = self.language_projection(self.qformer(self.vision_model(pixel_values)))
        t_emb = lm.embed_tokens(prompt_ids).to(q_emb.dtype)
        embeds = torch.cat([q_emb, t_emb], dim=1)
        caches = lm.new_caches(embeds.shape[0], cache_len, embeds.device)
        return lm.prefill(embeds, caches), caches, embeds.shape[1]

    def decode_one(self, token_ids, step: int, prefix_len: int, caches):
        """Decode index `step`: absolute cache position prefix_len + step."""
        return self.language_model.decode_one(token_ids, prefix_len + step, caches)


@torch.no_grad()
def blip2_generate(model: Blip2, pixel_values, prompt_ids, max_new_tokens: int = 100,
                   num_beams: int = 5, no_repeat_ngram_size: int = 2,
                   length_penalty: float = 1.0):
    """Beam generation with the reference's arguments -> (tokens [B,
    max_new_tokens] int32, scores [B])."""
    d = model.dims
    b = pixel_values.shape[0]
    prefix = d.num_query_tokens + prompt_ids.shape[1]
    last_logits, caches, _ = model.encode_and_prefill(pixel_values, prompt_ids,
                                                      prefix + max_new_tokens)
    k = num_beams
    for entry in caches:  # beams fold into the batch, beam-major within a row
        for j, c in enumerate(entry):
            entry[j] = c.repeat_interleave(k, dim=0)

    def decode_step(flat_tokens, s, caches):
        return model.decode_one(flat_tokens, s, prefix, caches), caches

    return beam_search(
        decode_step, last_logits[:, -1], caches, b, k, max_new_tokens, d.vocab_size,
        eos_token_id=d.eos_token_id, pad_token_id=d.pad_token_id,
        length_penalty=length_penalty, no_repeat_ngram_size=no_repeat_ngram_size,
        # decoder-only semantics: the text prompt joins the n-gram scan and
        # the length normalisation (the query embeds have no token ids)
        prompt_tokens=prompt_ids, length_offset=prompt_ids.shape[1])


# CLIP normalisation (HF Blip2Processor)
_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)
PROMPT = "The image shows"
# float32 parameters under a bfloat16 build: the tied token table (LM head)
KEEP_F32 = ("language_model.embed_tokens",)


def build_blip2(dims: Blip2Dims, state, dtype: torch.dtype, device, seed: int = 0) -> Blip2:
    """A Blip2 on `device` in `dtype`: from `state` (strict), or seeded with
    a generator on `device` itself, so that a full-width model never takes
    its float32 draw on the host.  The module is made on the meta device
    first and takes its memory once."""
    from omniparser_tpu_torch.weights.init import cast_compute_dtype, seeded_init_, to_tensor_state

    with torch.device("meta"):
        model = Blip2(dims)
    if state is None:
        model = model.to_empty(device=device)
        seeded_init_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(to_tensor_state(state), strict=True, assign=True)
    cast_compute_dtype(model, dtype, KEEP_F32)
    return model.to(device).eval()


class Blip2Captioner:
    """Pipeline captioner (the FlorenceCaptioner interface without the fused
    step): crops are resized bilinearly to the vision tower's size, CLIP
    normalised, and beam-decoded with the prompt "The image shows", 5
    beams and min(max_new_tokens, 100) new tokens.  ``generate_calls``
    counts the batched decodes."""

    fusable = False  # the beam decode runs outside the fused device step

    def __init__(self, config: CaptionerConfig, dims: Blip2Dims = BLIP2_OPT_2_7B, state=None,
                 tokenizer=None, num_beams: int = 5, seed: int = 0, device="cuda"):
        from omniparser_tpu_torch.utils.device import resolve_device

        self.config = config
        self.dims = dims
        self.num_beams = num_beams
        self.device = resolve_device(device)
        self.generate_calls = 0
        if tokenizer is None:
            from omniparser_tpu_torch.models.tokenizer import load_tokenizer

            tokenizer = load_tokenizer(None)
        self.tokenizer = tokenizer
        ids = tokenizer.encode(PROMPT, add_special=False)
        self.prompt_ids = np.asarray([dims.bos_token_id] + list(ids), np.int64)
        self.max_new_tokens = min(config.max_new_tokens, 100)
        self.model = build_blip2(dims, state, getattr(torch, config.dtype), self.device, seed)
        self._mean = torch.tensor(_MEAN, dtype=torch.float32, device=self.device)[:, None, None]
        self._std = torch.tensor(_STD, dtype=torch.float32, device=self.device)[:, None, None]

    @classmethod
    def from_checkpoint(cls, path: str, config: CaptionerConfig,
                        dims: Blip2Dims = BLIP2_OPT_2_7B, device="cuda"):
        """An HF blip2-opt directory (``*.safetensors`` and the tokenizer
        files; ``weights/convert_blip2.py``)."""
        from omniparser_tpu_torch.models.tokenizer import load_tokenizer
        from omniparser_tpu_torch.weights.convert_blip2 import load_blip2_state

        state = load_blip2_state(path, dims)
        return cls(config, dims, state, tokenizer=load_tokenizer(path), device=device)

    def preprocess(self, crops_f255: torch.Tensor) -> torch.Tensor:
        """[N, s, s, 3] float crops in [0,255] -> [N, 3, S, S] CLIP-normalised
        at the tower's size: bilinear with half-pixel centres (antialiased
        where it shrinks, as the JAX package's resize is)."""
        s = self.dims.image_size
        x = F.interpolate(crops_f255.permute(0, 3, 1, 2).float(), size=(s, s),
                          mode="bilinear", align_corners=False, antialias=True)
        return (x / 255.0 - self._mean) / self._std

    def generate(self, crops_f255: torch.Tensor):
        """(tokens [N, max_new] int32, scores [N]) for N crops."""
        n = crops_f255.shape[0]
        self.generate_calls += 1
        prompt = torch.from_numpy(np.tile(self.prompt_ids[None], (n, 1))).to(self.device)
        return blip2_generate(self.model, self.preprocess(crops_f255), prompt,
                              self.max_new_tokens, self.num_beams)

    def tokens_to_text(self, token_row) -> str:
        d = self.dims
        ids = [int(t) for t in token_row
               if t not in (d.pad_token_id, d.eos_token_id, d.bos_token_id)]
        return self.tokenizer.decode(ids).strip()

    def caption_crops(self, crops, valid) -> List[str]:
        """crops [N,s,s,3] float in [0,255]; valid [N] bool.  Captions for
        the valid slots, in order."""
        tokens = self.generate(crops)[0].cpu().numpy()
        return [self.tokens_to_text(tokens[i]) for i in range(len(tokens)) if valid[i]]
