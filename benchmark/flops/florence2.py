"""Florence-2 on one caption crop: the DaViT tower (patch convolutions,
depthwise position convolutions, windowed and channel-group attention,
MLPs, with windows padded as the architecture pads them), the projection
of the pooled and per-patch features, the BART encoder over image tokens
and the prompt, and max_new_tokens decode steps (self-attention over the
tokens so far, cross-attention, FFN, tied LM head).  flops(cfg) -> FLOPs
of one caption that is needed."""

import math

PROMPT = "What does the image describe?"


def macs(dims: dict, crop: int, prompt_len: int, new_tokens: int) -> int:
    total = 0
    h = w = crop
    cin = 3
    for s in range(4):
        c = dims["embed_dims"][s]
        k, st, p = dims["patch_size"][s], dims["patch_stride"][s], dims["patch_padding"][s]
        h, w = (h + 2 * p - k) // st + 1, (w + 2 * p - k) // st + 1
        n = h * w
        total += k * k * cin * c * n
        ws = min(dims["window_size"], h, w)
        windows = math.ceil(h / ws) * math.ceil(w / ws)
        gd = c // dims["num_groups"][s]
        ratio = dims.get("mlp_ratio", 4.0)
        for _ in range(dims["depths"][s]):
            for spatial in (True, False):
                total += 2 * 9 * c * n                               # two position convs
                total += 2 * int(c * ratio) * c * n                  # MLP
                if spatial:
                    t = windows * ws * ws                            # padded window tokens
                    total += 4 * c * c * t + 2 * windows * ws * ws * ws * ws * c
                else:
                    total += 4 * c * c * n + 2 * c * gd * n
        cin = c
    d, f, v = dims["d_model"], dims["ffn_dim"], dims["vocab_size"]
    img_tokens = h * w + 1
    total += img_tokens * dims["embed_dims"][-1] * d                # image projection
    s = img_tokens + prompt_len
    total += dims["encoder_layers"] * s * (4 * d * d + 2 * s * d + 2 * d * f)
    dec = dims["decoder_layers"]
    total += dec * 2 * s * d * d                                    # cross K/V, once
    for t in range(1, new_tokens + 1):
        total += dec * (4 * d * d + 2 * t * d + 2 * d * d + 2 * s * d + 2 * d * f)
        total += d * v                                              # LM head
    return total


def flops(cfg) -> int:
    cap = cfg["pipeline"]["captioner"]
    prompt_len = len(PROMPT) + 2  # the structural tokenizer: one id a character + bos/eos
    return 2 * macs(cfg["captioner_dims"], cap.get("crop_size", 64), prompt_len,
                    cap.get("max_new_tokens", 20))
