"""Faults planted under the timed path, for the test that sees `correct`
come out false (never used by a measured run):

  token       the captioner's first generated token of every caption is
              altered where it is produced
  half_batch  parse_batch parses only the first half of each batch and
              hands the rest the first image's answer
  detector    the detector's class logits are raised where they are
              produced, so that its scores and keep set change
  components  the OCR components' boxes are moved two map pixels right
              where they are produced
  captions    each request's model captions are handed on, each to the
              next captioned icon, where the elements are filled
"""

from __future__ import annotations


def plant(name: str, pipe) -> None:
    if name == "token":
        cap = pipe.captioner
        generate = cap.generate
        vocab = cap.dims.vocab_size

        def altered(crops):
            tokens, scores = generate(crops)
            tokens = tokens.clone()
            tokens[:, 0] = (tokens[:, 0] + 1) % vocab
            return tokens, scores

        cap.generate = altered
    elif name == "half_batch":
        parse_batch = pipe.parse_batch

        def half(images):
            keep = max(len(images) // 2, 1)
            res = parse_batch(images[:keep])
            return res + [res[0]] * (len(images) - keep)

        pipe.parse_batch = half
    elif name == "detector":
        def raise_cls(module, args, out):
            return [(box, cls + 2.0) for box, cls in out]

        pipe.det_module.register_forward_hook(raise_cls)
    elif name == "components":
        det_cc_full = pipe.ocr.det_cc_full

        def moved(padded, hw, max_cc=1024):
            cc = dict(det_cc_full(padded, hw, max_cc))
            boxes = cc["boxes"].clone()
            boxes[:, 0::2] += 2
            cc["boxes"] = boxes
            return cc

        pipe.ocr.det_cc_full = moved
    elif name == "captions":
        fill = pipe._fill_captions

        def handed_on(ctx, icon_plain):
            fill(ctx, icon_plain)
            caps = [e["content"] for _, e in icon_plain]
            for (_, e), c in zip(icon_plain, caps[1:] + caps[:1]):
                e["content"] = c

        pipe._fill_captions = handed_on
    else:
        raise ValueError(f"unknown fault {name!r}")
