"""BLIP-2 opt on one caption: EVA ViT-g over the 224 image (patches and a
class token), the Q-Former (self-attention of the queries, cross-attention
to the image every cross_frequency layers, FFN), the language projection,
the OPT prefill over (queries ++ prompt) and a beam decode: num_beams
beams, each step one token a beam through every layer (attention over the
cache so far) and the LM head.  flops(cfg) -> FLOPs of one caption that is
needed (never of a padded slot)."""

PROMPT = "The image shows"


def macs(d: dict, prompt_len: int, new_tokens: int, beams: int) -> int:
    vw, n_img = d["vision_width"], (d["image_size"] // d["patch_size"]) ** 2 + 1
    total = d["patch_size"] ** 2 * 3 * vw * (n_img - 1)
    total += d["vision_layers"] * n_img * (4 * vw * vw + 2 * n_img * vw + 2 * vw * d["vision_mlp"])
    qw, q = d["qformer_width"], d["num_query_tokens"]
    for i in range(d["qformer_layers"]):
        total += q * (4 * qw * qw + 2 * q * qw + 2 * qw * d["qformer_mlp"])
        if i % d["cross_frequency"] == 0:
            total += 2 * n_img * vw * qw + q * (2 * qw * qw + 2 * n_img * qw)
    lw, L, mlp, v = d["lm_width"], d["lm_layers"], d["lm_mlp"], d["vocab_size"]
    total += q * qw * lw
    prefix = q + prompt_len
    per_token = 4 * lw * lw + 2 * lw * mlp
    total += L * (prefix * per_token + prefix * (prefix + 1) * lw)  # causal QK and AV
    total += lw * v                                                 # first token's head
    for step in range(1, new_tokens):
        pos = prefix + step + 1
        total += beams * (L * (per_token + 2 * pos * lw) + lw * v)
    return total


def flops(cfg) -> int:
    cap = cfg["pipeline"]["captioner"]
    prompt_len = 1 + len(PROMPT)  # bos + one id a character
    return 2 * macs(cfg["captioner_dims"], prompt_len, min(cap.get("max_new_tokens", 100), 100),
                    cfg.get("beams", 5))
