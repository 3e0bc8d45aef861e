"""Beam search as an eager loop over preallocated buffers.

The reference's BLIP-2 path generates with num_beams=5,
no_repeat_ngram_size=2 and early stopping.  Beams fold into the batch
axis, the KV caches are gathered by source beam after every step, and the
bigram ban is a fixed-shape scatter into a [B, K, V] mask.  The loop reads
no device value, so its launches queue without a synchronise.

Semantics of the JAX package's ``beam_search`` (HF's decoder-only rules):
  * the n-gram ban scans the full running sequence, prompt tokens
    included, so bigrams across the prompt/generation boundary are banned;
  * a finished beam extends only with pad, at no cost;
  * top-k over K*V candidates breaks ties by the lower flat index, as
    ``jax.lax.top_k`` does (a stable descending sort, then a slice);
  * the final ranking divides by the full hypothesis length (generated
    non-pad tokens + ``length_offset``) to the power ``length_penalty``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

NEG_INF = -1e9


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim, ties broken by the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def ban_repeated_bigrams(tokens: torch.Tensor, last: torch.Tensor, length: int,
                         vocab: int) -> torch.Tensor:
    """Mask [B, K, V]: token v is banned where (last, v) already occurs in
    the first `length` tokens of the running sequence `tokens` [B, K, T].
    Pairs that are not valid scatter nothing (a 0 count into slot 0)."""
    b, k, t = tokens.shape
    pos = torch.arange(t, device=tokens.device)
    second = torch.cat([tokens[..., 1:], torch.zeros_like(tokens[..., :1])], dim=-1)
    pair_valid = (pos + 1 < length) & (tokens == last[..., None])
    ban = torch.where(pair_valid, second, torch.zeros_like(second))
    counts = torch.zeros((b, k, vocab), dtype=torch.int32, device=tokens.device)
    counts.scatter_add_(2, ban, pair_valid.to(torch.int32))
    return counts > 0


def reorder_caches_(caches: List, index: torch.Tensor) -> None:
    """Gather every cache tensor's leading (beam-flattened) dim by `index`,
    in place in the list: each entry is a list of tensors, replaced one at
    a time so that only one old tensor is alive beside its copy."""
    for entry in caches:
        for j, c in enumerate(entry):
            entry[j] = c.index_select(0, index)


@torch.no_grad()
def beam_search(decode_step: Callable, init_logits: torch.Tensor, caches: List,
                batch: int, num_beams: int, max_new_tokens: int, vocab_size: int,
                eos_token_id: int, pad_token_id: int, length_penalty: float = 1.0,
                no_repeat_ngram_size: int = 0, prompt_tokens: Optional[torch.Tensor] = None,
                length_offset: int = 0):
    """Generic beam search.

    init_logits [B, V]: the prefill's last-position logits; token 0 of every
    beam is drawn from them.  decode_step(flat_tokens [B*K, 1], s, caches)
    -> (logits [B*K, 1, V], caches) is then called for s = 0 ..
    max_new_tokens - 2, feeding token s and returning the logits of token
    s + 1.  caches: a list of lists of tensors whose leading dim is already
    B*K (beam-major within a batch row); they are reordered by source beam
    after every step.  prompt_tokens [B, P] (optional): the text prompt of
    a decoder-only model, which joins the n-gram ban; length_offset: tokens
    added to each hypothesis' length in the final ranking.

    Returns (tokens [B, max_new_tokens] int32 of the best beam, its
    length-normalised score [B])."""
    k = num_beams
    dev = init_logits.device
    p = 0 if prompt_tokens is None else prompt_tokens.shape[1]
    logp0 = torch.log_softmax(init_logits.float(), dim=-1)
    buf = torch.full((batch, k, p + max_new_tokens), pad_token_id, dtype=torch.int64,
                     device=dev)
    if p:
        prompt = prompt_tokens.to(device=dev, dtype=torch.int64)
        buf[:, :, :p] = prompt[:, None, :]
        if no_repeat_ngram_size == 2:
            banned0 = ban_repeated_bigrams(buf, prompt[:, -1:].expand(batch, k), p,
                                           vocab_size)[:, 0]  # beams identical at t=0
            logp0 = logp0.masked_fill(banned0, NEG_INF)
    scores, last = stable_top_k(logp0, k)  # [B, K]
    buf[:, :, p] = last
    done = last == eos_token_id
    pad_only = torch.full((vocab_size,), NEG_INF, dtype=torch.float32, device=dev)
    pad_only[pad_token_id] = 0.0
    beam_base = torch.arange(batch, device=dev)[:, None] * k

    for s in range(max_new_tokens - 1):
        t = p + s + 1  # buffer index of the token chosen in this step
        logits, caches = decode_step(last.reshape(batch * k, 1), s, caches)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(batch, k, vocab_size)
        if no_repeat_ngram_size == 2:
            logp = logp.masked_fill(ban_repeated_bigrams(buf, last, t, vocab_size), NEG_INF)
        logp = torch.where(done[..., None], pad_only, logp)
        cand = (scores[..., None] + logp).reshape(batch, k * vocab_size)
        scores, top_idx = stable_top_k(cand, k)
        src = torch.div(top_idx, vocab_size, rounding_mode="floor")
        last = top_idx % vocab_size
        src_done = torch.gather(done, 1, src)
        buf = torch.gather(buf, 1, src[..., None].expand(-1, -1, buf.shape[-1]))
        buf[:, :, t] = torch.where(src_done, torch.full_like(last, pad_token_id), last)
        done = src_done | (last == eos_token_id)
        reorder_caches_(caches, (beam_base + src).reshape(-1))

    gen = buf[:, :, p:]
    lengths = (gen != pad_token_id).sum(-1).float() + length_offset
    norm = scores / torch.clamp(lengths, min=1.0) ** length_penalty
    best = torch.argmax(norm, dim=1)
    rows = torch.arange(batch, device=dev)
    return gen[rows, best].to(torch.int32), norm[rows, best]
