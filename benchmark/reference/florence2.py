"""Florence-2-base in plain PyTorch: DaViT vision tower, BART encoder and
decoder, tied LM head.  A frozen copy of the measured package's module
code (attribute names and all), without its int8 path or decode loop, so
that the same state_dict loads into both; the reference reads its logits
teacher-forced along the tokens that the program served."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import LN_EPS, float32_region, layer_norm_f32


@dataclasses.dataclass(frozen=True)
class FlorenceDims:
    """florence-2-base dims (HF config.json of microsoft/Florence-2-base)."""

    embed_dims: Tuple[int, ...] = (128, 256, 512, 1024)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    num_groups: Tuple[int, ...] = (4, 8, 16, 32)
    depths: Tuple[int, ...] = (1, 1, 9, 1)
    patch_size: Tuple[int, ...] = (7, 3, 3, 3)
    patch_stride: Tuple[int, ...] = (4, 2, 2, 2)
    patch_padding: Tuple[int, ...] = (3, 1, 1, 1)
    # True = LayerNorm the stage INPUT before its conv (the genuine
    # Florence-2 DaViT); False = post-norm the conv output.
    patch_prenorm: Tuple[bool, ...] = (False, True, True, True)
    window_size: int = 12
    mlp_ratio: float = 4.0
    d_model: int = 768
    encoder_layers: int = 6
    decoder_layers: int = 6
    attn_heads: int = 12
    ffn_dim: int = 3072
    vocab_size: int = 51289
    max_positions: int = 1024
    pos_embed_grid: int = 50  # learned 2D image pos-embed table side
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2


BASE = FlorenceDims()


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# --------------------------------------------------------------------- #
# DaViT vision tower
# --------------------------------------------------------------------- #


class ConvPosEnc(nn.Module):
    """3x3 depthwise conv positional encoding."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x, hw):
        h, w = hw
        b, n, c = x.shape
        y = _conv_nhwc(self.proj, x.reshape(b, h, w, c))
        return x + y.reshape(b, n, c)


class WindowAttention(nn.Module):
    """Spatial attention in non-overlapping windows (global if map fits)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, hw):
        h, w = hw
        b, n, c = x.shape
        ws = min(self.window, h, w)
        pad_h, pad_w = (-h) % ws, (-w) % ws
        hp, wp = h + pad_h, w + pad_w
        y = F.pad(x.reshape(b, h, w, c), (0, 0, 0, pad_w, 0, pad_h))
        nh, nw = hp // ws, wp // ws
        y = y.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b * nh * nw, ws * ws, c)

        q, k, v = self.qkv(y).chunk(3, dim=-1)
        hd = c // self.heads
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, hd).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        attn = (q * (hd ** -0.5)) @ k.transpose(-1, -2)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = (attn @ v).transpose(1, 2).reshape(-1, ws * ws, c)
        y = self.proj(y)

        y = y.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, hp, wp, c)[:, :h, :w, :]
        return y.reshape(b, n, c)


class ChannelAttention(nn.Module):
    """DaViT channel-group attention: softmax over channel-channel pairs."""

    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.groups = groups
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        gd = c // self.groups
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        grp = lambda t: t.reshape(b, n, self.groups, gd).transpose(1, 2)  # [B,G,N,gd]
        q, k, v = grp(q), grp(k), grp(v)
        attn = (q * (gd ** -0.5)).transpose(-1, -2) @ k  # [B,G,gd,gd]
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = (attn @ v.transpose(-1, -2)).transpose(-1, -2)  # [B,G,N,gd]
        y = y.transpose(1, 2).reshape(b, n, c)
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, ratio: float):
        super().__init__()
        self.fc1 = nn.Linear(dim, int(dim * ratio))
        self.fc2 = nn.Linear(int(dim * ratio), dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _DualBlock(nn.Module):
    """conv-pos-enc -> norm -> attention -> conv-pos-enc -> norm -> MLP,
    with the attention being windowed-spatial or channel-group."""

    def __init__(self, dim: int, attn: nn.Module, ratio: float, spatial: bool):
        super().__init__()
        self.spatial = spatial
        self.cpe1 = ConvPosEnc(dim)
        self.norm1 = _ln(dim)
        self.attn = attn
        self.cpe2 = ConvPosEnc(dim)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, ratio)

    def forward(self, x, hw):
        x = self.cpe1(x, hw)
        y = layer_norm_f32(x, self.norm1).to(x.dtype)
        x = x + (self.attn(y, hw) if self.spatial else self.attn(y))
        x = self.cpe2(x, hw)
        y = layer_norm_f32(x, self.norm2).to(x.dtype)
        return x + self.mlp(y)


class DaViT(nn.Module):
    """4-stage dual-attention vision tower: [B,H,W,3] -> [B, N, C4]."""

    def __init__(self, dims: FlorenceDims = BASE):
        super().__init__()
        self.dims = d = dims
        cin = 3
        for s in range(4):
            c = d.embed_dims[s]
            setattr(self, f"patch_embed{s}_norm", _ln(cin if d.patch_prenorm[s] else c))
            setattr(self, f"patch_embed{s}_conv",
                    nn.Conv2d(cin, c, d.patch_size[s], d.patch_stride[s], d.patch_padding[s]))
            for blk in range(d.depths[s]):
                setattr(self, f"stage{s}_blk{blk}_spatial", _DualBlock(
                    c, WindowAttention(c, d.num_heads[s], d.window_size), d.mlp_ratio, True))
                setattr(self, f"stage{s}_blk{blk}_channel", _DualBlock(
                    c, ChannelAttention(c, d.num_groups[s]), d.mlp_ratio, False))
            cin = c

    def forward(self, x):
        d = self.dims
        dt = self.patch_embed0_conv.weight.dtype
        x = x.to(dt)
        for s in range(4):
            norm = getattr(self, f"patch_embed{s}_norm")
            if d.patch_prenorm[s]:
                x = layer_norm_f32(x, norm).to(dt)
            x = _conv_nhwc(getattr(self, f"patch_embed{s}_conv"), x)
            b, h, w, c = x.shape
            x = x.reshape(b, h * w, c)
            if not d.patch_prenorm[s]:
                x = layer_norm_f32(x, norm).to(dt)
            for blk in range(d.depths[s]):
                x = getattr(self, f"stage{s}_blk{blk}_spatial")(x, (h, w))
                x = getattr(self, f"stage{s}_blk{blk}_channel")(x, (h, w))
            if s < 3:
                x = x.reshape(b, h, w, c)
        return x  # [B, N, C4]


class Florence2VisionEncoder(nn.Module):
    """DaViT + pos embeds + (spatial, temporal) pooled features + projection
    to d_model."""

    def __init__(self, dims: FlorenceDims = BASE):
        super().__init__()
        self.dims = d = dims
        c = d.embed_dims[-1]
        self.davit = DaViT(d)
        self.image_pos_embed_row = nn.Parameter(torch.zeros(d.pos_embed_grid, c))
        self.image_pos_embed_col = nn.Parameter(torch.zeros(d.pos_embed_grid, c))
        self.visual_temporal_embed = nn.Parameter(torch.zeros(1, c))
        self.image_projection = nn.Parameter(torch.zeros(c, d.d_model))
        self.image_proj_norm = _ln(d.d_model)

    def forward(self, pixel_values):
        x = self.davit(pixel_values)  # [B, N, C4]
        b, n, c = x.shape
        side = int(round(n ** 0.5))
        row, col = self.image_pos_embed_row, self.image_pos_embed_col
        pos = (row[:side, None, :] + col[None, :side, :]).reshape(1, n, c)
        x = x + pos + self.visual_temporal_embed[None]
        # feature sources: spatial_avg_pool (1 token) + temporal_avg_pool (N tokens)
        feats = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        y = feats @ self.image_projection
        return layer_norm_f32(y, self.image_proj_norm).to(x.dtype)


# --------------------------------------------------------------------- #
# BART-family language model
# --------------------------------------------------------------------- #


class BartAttention(nn.Module):
    """Multi-head attention with optional KV cache (decode) and cross-attn.
    For cross-attention during decode, pass `kv_heads=(k, v)` (head-split,
    computed once from the encoder states via `project_kv`)."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.d_model, self.heads = d_model, heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def _split(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.heads, self.d_model // self.heads)

    def project_kv(self, kv_in):
        return self._split(self.k_proj(kv_in)), self._split(self.v_proj(kv_in))

    def forward(self, x, kv=None, mask=None, cache=None, cache_index=None, kv_heads=None):
        hd = self.d_model // self.heads
        q = self._split(self.q_proj(x))
        if kv_heads is not None:
            k, v = kv_heads
        else:
            k, v = self.project_kv(x if kv is None else kv)
        if cache is not None:
            # decode step: write this step's k/v in place at cache_index;
            # positions beyond it are not visible, so they are not read
            ck, cv = cache
            ck[:, cache_index:cache_index + 1] = k
            cv[:, cache_index:cache_index + 1] = v
            k, v = ck[:, :cache_index + 1], cv[:, :cache_index + 1]
        attn = torch.einsum("bqhd,bkhd->bhqk", q * (hd ** -0.5), k)
        if mask is not None:
            attn = attn.masked_fill(~mask, torch.finfo(attn.dtype).min)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], self.d_model))


class BartEncoderLayer(nn.Module):
    def __init__(self, d: FlorenceDims):
        super().__init__()
        self.self_attn = BartAttention(d.d_model, d.attn_heads)
        self.self_attn_layer_norm = _ln(d.d_model)
        self.fc1 = nn.Linear(d.d_model, d.ffn_dim)
        self.fc2 = nn.Linear(d.ffn_dim, d.d_model)
        self.final_layer_norm = _ln(d.d_model)

    def forward(self, x, mask):
        dt = x.dtype
        x = layer_norm_f32(x + self.self_attn(x, mask=mask), self.self_attn_layer_norm).to(dt)
        y = self.fc2(F.gelu(self.fc1(x)))
        return layer_norm_f32(x + y, self.final_layer_norm).to(dt)


class BartDecoderLayer(nn.Module):
    def __init__(self, d: FlorenceDims):
        super().__init__()
        self.self_attn = BartAttention(d.d_model, d.attn_heads)
        self.self_attn_layer_norm = _ln(d.d_model)
        self.encoder_attn = BartAttention(d.d_model, d.attn_heads)
        self.encoder_attn_layer_norm = _ln(d.d_model)
        self.fc1 = nn.Linear(d.d_model, d.ffn_dim)
        self.fc2 = nn.Linear(d.ffn_dim, d.d_model)
        self.final_layer_norm = _ln(d.d_model)

    def forward(self, x, enc, self_mask, cross_mask, cache=None, cache_index=None,
                cross_kv=None):
        dt = x.dtype
        y = self.self_attn(x, mask=self_mask, cache=cache, cache_index=cache_index)
        x = layer_norm_f32(x + y, self.self_attn_layer_norm).to(dt)
        y = self.encoder_attn(x, kv=enc, mask=cross_mask, kv_heads=cross_kv)
        x = layer_norm_f32(x + y, self.encoder_attn_layer_norm).to(dt)
        y = self.fc2(F.gelu(self.fc1(x)))
        return layer_norm_f32(x + y, self.final_layer_norm).to(dt)


class Florence2LM(nn.Module):
    """BART-style encoder/decoder over (image tokens ++ prompt tokens)."""

    def __init__(self, dims: FlorenceDims = BASE):
        super().__init__()
        self.dims = d = dims
        self.shared = nn.Embedding(d.vocab_size, d.d_model)
        # BART's learned positions start at offset 2
        self.encoder_embed_positions = nn.Embedding(d.max_positions + 2, d.d_model)
        self.decoder_embed_positions = nn.Embedding(d.max_positions + 2, d.d_model)
        self.encoder_layernorm_embedding = _ln(d.d_model)
        self.decoder_layernorm_embedding = _ln(d.d_model)
        for i in range(d.encoder_layers):
            setattr(self, f"encoder_layer{i}", BartEncoderLayer(d))
        for i in range(d.decoder_layers):
            setattr(self, f"decoder_layer{i}", BartDecoderLayer(d))
        self.final_logits_bias = nn.Parameter(torch.zeros(d.vocab_size))

    def _dec_layers(self) -> List[BartDecoderLayer]:
        return [getattr(self, f"decoder_layer{i}") for i in range(self.dims.decoder_layers)]

    def encode(self, inputs_embeds, attn_mask):
        """inputs_embeds [B,S,D] (image features ++ token embeds);
        attn_mask [B,S] bool."""
        s = inputs_embeds.shape[1]
        pos = self.encoder_embed_positions(
            torch.arange(s, device=inputs_embeds.device) + 2)
        h = layer_norm_f32(inputs_embeds + pos[None],
                           self.encoder_layernorm_embedding).to(inputs_embeds.dtype)
        m = attn_mask[:, None, None, :]
        for i in range(self.dims.encoder_layers):
            h = getattr(self, f"encoder_layer{i}")(h, m)
        return h

    def _dtype(self) -> torch.dtype:
        """The module dtype (the position tables are cast to it)."""
        return self.decoder_embed_positions.weight.dtype

    def embed_tokens(self, ids):
        # the table may be kept in float32 for the head: rows in the module dtype
        return self.shared(ids).to(self._dtype())

    def cross_kvs(self, enc):
        return [layer.encoder_attn.project_kv(enc) for layer in self._dec_layers()]

    def lm_head(self) -> torch.Tensor:
        """The head — take it once per generate: [D, V] float32, tied to
        ``shared``."""
        return self.shared.weight.float().t()

    def _logits(self, h, head=None):
        head = self.lm_head() if head is None else head
        with float32_region(h):
            return h.float() @ head + self.final_logits_bias.float()

    def decode_step(self, token_ids, step: int, enc_mask, caches, cross_kvs, head=None):
        """One greedy step: token_ids [B,1] at position `step`; caches are
        per-layer (k, v) [B, max_len, H, hd], updated in place."""
        pos = self.decoder_embed_positions(
            torch.tensor([step + 2], device=token_ids.device))
        h = self.embed_tokens(token_ids) + pos[None]
        h = layer_norm_f32(h, self.decoder_layernorm_embedding).to(pos.dtype)
        cross_mask = enc_mask[:, None, None, :]
        for layer, cache, ckv in zip(self._dec_layers(), caches, cross_kvs):
            h = layer(h, None, None, cross_mask, cache=cache, cache_index=step,
                      cross_kv=ckv)
        return self._logits(h, head)

    def decode_train(self, token_ids, enc, enc_mask):
        """Teacher-forced decode: token_ids [B, T] -> logits [B, T, V]."""
        t = token_ids.shape[1]
        dev = token_ids.device
        pos = self.decoder_embed_positions(torch.arange(t, device=dev) + 2)
        h = layer_norm_f32(self.embed_tokens(token_ids) + pos[None],
                           self.decoder_layernorm_embedding).to(pos.dtype)
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None, None]
        cross = enc_mask[:, None, None, :]
        for layer in self._dec_layers():
            h = layer(h, enc, causal, cross)
        return self._logits(h)


class Florence2(nn.Module):
    """Vision encoder + language model."""

    def __init__(self, dims: FlorenceDims = BASE):
        super().__init__()
        self.dims = dims
        self.vision = Florence2VisionEncoder(dims)
        self.language_model = Florence2LM(dims)

    def forward(self, pixel_values, prompt_ids, decoder_ids):
        """Teacher-forced forward.  pixel_values [B,H,W,3]; prompt_ids
        [B,P]; decoder_ids [B,T]."""
        embeds, mask = self._build_encoder_inputs(pixel_values, prompt_ids)
        enc = self.language_model.encode(embeds, mask)
        return self.language_model.decode_train(decoder_ids, enc, mask)

    def _build_encoder_inputs(self, pixel_values, prompt_ids):
        img = self.vision(pixel_values)  # [B, I, D]
        txt = self.language_model.embed_tokens(prompt_ids)  # [B, P, D]
        embeds = torch.cat([img, txt.to(img.dtype)], dim=1)
        img_mask = torch.ones(img.shape[:2], dtype=torch.bool, device=img.device)
        txt_mask = prompt_ids != self.dims.pad_token_id
        return embeds, torch.cat([img_mask, txt_mask], dim=1)

    def encode_inputs(self, pixel_values, prompt_ids):
        """Encoder half of generate: (per-layer cross K/V, encoder mask)."""
        embeds, mask = self._build_encoder_inputs(pixel_values, prompt_ids)
        enc = self.language_model.encode(embeds, mask)
        return self.language_model.cross_kvs(enc), mask

