"""Weight-only int8 quantization for the caption decode path.

Only the decoder and the LM head are quantized: the vision tower and the
BART encoder run once per generate, while the decoder re-reads its
weights max_new_tokens times per caption batch.

  * weights are stored int8 with per-output-channel float32 scales
    (symmetric: ``max|w| / 127``, the max floored at 1e-8);
  * a product takes the input in the module dtype against the weight
    converted to that dtype, accumulated and returned in float32, then
    multiplied by the scale, cast to the module dtype, and the bias added;
  * the float embedding table is dropped: token lookups read int8 rows of
    the LM head's table and multiply by their row scale.

A PyTorch ``nn.Linear`` weight is ``[out, in]``, so the per-output-channel
scale of an ``[in, out]`` kernel is a per-row scale of the torch weight.

Eager PyTorch converts the int8 weight to the module dtype in a pass of
its own on every call (no fused operand load), so the weight traffic per
step is not halved here; the resident weights are.  ``product_f32`` is
looked up at call time, so a measurement may swap in another form.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Union

import torch
import torch.nn as nn

def _quantize(w: torch.Tensor, dim: int):
    w = w.detach().to(torch.float32)
    s = torch.clamp(w.abs().amax(dim=dim), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / s.unsqueeze(dim)), -127, 127).to(torch.int8)
    return q, s


def quantize_columns(w: torch.Tensor):
    """float kernel [in, out] -> (int8 [in, out], float32 scale [out])."""
    return _quantize(w, 0)


def quantize_rows(w: torch.Tensor):
    """float matrix [out, in] -> (int8 [out, in], float32 scale [out]):
    a torch Linear weight, or the vocabulary-major embedding table."""
    return _quantize(w, 1)


def product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [out, in]^T, both in the module dtype, accumulated
    and returned in float32.  On the card a bfloat16 (or half) product runs
    on the tensor cores with a float32 output (``torch.mm``'s ``out_dtype``).
    That form has no CPU kernel; there the float32 product of the same
    values is taken, which is the same product: a product of two bfloat16
    values is exact in float32."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.float(), w.float().t())


class QLinear(nn.Module):
    """An ``nn.Linear`` with an int8 weight [out, in] and a float32
    per-row scale [out]; the bias stays float32.  ``compute_dtype`` is the
    module dtype (``weights.init.cast_compute_dtype`` sets it)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.register_buffer("weight", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones((out_features,), dtype=torch.float32))
        self.register_buffer("bias", torch.zeros((out_features,), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = product_f32(x.to(dt), self.weight.to(dt))
        return (y * self.scale).to(dt) + self.bias.to(dt)


# the decoder's projections: 'decoder_layer{i}' only (the decoder's
# 'decoder_layernorm_embedding' shares the prefix)
_QUANTIZED = re.compile(r"language_model\.decoder_layer\d+\."
                        r"(?:(?:self_attn|encoder_attn)\.(?:q|k|v|out)_proj|fc1|fc2)\.weight")


def quantize_florence_state(state: Union[nn.Module, Mapping[str, torch.Tensor]]
                            ) -> Dict[str, torch.Tensor]:
    """Float Florence-2 state (a ``Florence2`` module or its state_dict) ->
    the state_dict ``Florence2(dims, quant=True)`` loads.

    Every decoder layer's attention and FFN weights become int8 + scale;
    an int8 LM head ``lm_head_kernel [V, D]`` + ``lm_head_scale [V]`` is
    made from the tied ``shared`` table, which is then dropped.  The
    vision tower and the encoder keep their float weights.  The input is
    not changed."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    out = {k: v.detach().clone() for k, v in state.items()}
    for key in [k for k in out if _QUANTIZED.fullmatch(k)]:
        prefix = key[:-len(".weight")]
        q, s = quantize_rows(out[key])
        out[prefix + ".weight"] = q
        out[prefix + ".scale"] = s
        out[prefix + ".bias"] = out[prefix + ".bias"].to(torch.float32)
    q, s = quantize_rows(out.pop("language_model.shared.weight"))
    out["language_model.lm_head_kernel"] = q
    out["language_model.lm_head_scale"] = s
    return out


def resident_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))
