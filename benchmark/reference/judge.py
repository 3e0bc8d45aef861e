"""The comparison that decides `correct`.

It judges what the timed path produced for a sample of the requests the
window finished (drawn from the seed, the heaviest screenshot among them),
layer by layer, against the plain networks beside this file, computed in
float32 with TF32 off.  Each stage of the reference starts from the
program's own input to that stage (its detector head for NMS, its boxes for
the merge, the recogniser and the crops, its tokens for the captioner), so
that a decision taken one way at a threshold does not carry over into every
later number; the stage before it is judged by itself.

Numbers (each the worst over the sample; `Judge.check` names them):

  det_score_gap   largest |score| gap over the detector's anchors
  det_head_gap    largest gap of the detector head's raw outputs (box
                  distribution and class logits, each level and head apart)
                  over the largest magnitude of the reference's
  nms_mismatch    keep decisions or kept boxes of the NMS (K1) that differ
                  from greedy NMS over the program's own head (exact: 0)
  ocr_map_rms_gap root-mean-square gap of the text detector's probability map
                  over the root-mean-square of the reference's
  components_mismatch  line-candidate slots (validity or pixel box) that
                  differ from the plain components and unclip over the
                  program's own text map (exact: 0)
  rec_logit_gap   root-mean-square gap of the recogniser's logits over the
                  candidate lines, over the root-mean-square of the reference's
  merge_mismatch  merge decisions (K2) that differ from the plain merge
                  over the program's own boxes and validity (exact: 0)
  crop_gap        largest gap of a caption crop's pixel (K3)
  (the captioner's numbers below are read by its own file,
  benchmark/captioners/<backend>.py, through `readings`)
  caption_score_rms_gap  Florence-2: root-mean-square over the captions of
                  the batched decode (the first K of each screenshot) of the
                  gap between a caption's score (the mean log-probability of
                  its greedy tokens up to the end token) and the reference's
                  score of the same tokens, teacher-forced
  caption_overflow_score_rms_gap  the same over the captions of the
                  per-screenshot overflow decode (icons past K)
  caption_score_gap  BLIP-2: largest gap between a served beam's
                  length-normalised score and the reference's score of the
                  same tokens, teacher-forced
  results_mismatch  served elements that differ from those rebuilt from the
                  request's own download and caption tokens: type, box and
                  source of each element in order, and the caption of each
                  icon captioned by the model (exact: 0)

The control (`readings(..., control=True)`) puts the reference computed
with float8 products (``lowp.py``) in the program's place, and crops
rounded to bfloat16; its numbers must fail at least one limit.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import manifest as mf
from benchmark.reference import components as cc
from benchmark.reference import convert, lowp, ops, orbax_read
from benchmark.reference.ocr import TextDetector, TextRecognizer
from benchmark.reference.yolov8 import YOLOv8, decode_predictions

CAPTION_BLOCK = 16  # captions per reference forward


def fallback_ids(text: str, special: bool) -> List[int]:
    """The structural tokenizer the seeded captioners run with: ids 0..9 are
    specials (bos 0, pad 1, eos 2), a character c is ord(c) % 0x4000 + 10."""
    ids = [ord(c) % 0x4000 + 10 for c in text]
    return [0] + ids + [2] if special else ids


@contextlib.contextmanager
def strict_float32():
    """float32 products as float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _sub(flat: Dict, prefix: str) -> Dict:
    p = prefix + "/"
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def _load(module, state, device):
    module.load_state_dict({k: v.float() if torch.is_floating_point(v) else v
                            for k, v in state.items()}, strict=True)
    return module.to(device).float().eval()


def relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def rms_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The root-mean-square of got - ref over the root-mean-square of ref."""
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm().clamp_min(1e-12))


class Networks:
    """The reference's networks in float32 (or, for the control, with
    float8 products)."""

    def __init__(self, cfg: Dict, captioner_state: Dict, device, trees: Dict[str, str]):
        self.device = device
        det = cfg["pipeline"]["detector"]
        ocr = cfg["pipeline"]["ocr"]
        det_flat = convert.flatten(orbax_read.read_orbax_tree(trees["detector"]))
        ocr_flat = convert.flatten(orbax_read.read_orbax_tree(trees["ocr"]))
        yolo = YOLOv8(det.get("variant", "n"), det.get("num_classes", 1))
        self.yolo = _load(yolo, convert.convert_variables(_sub(det_flat, "det"), yolo), device)
        tdet = TextDetector()
        self.textdet = _load(tdet, convert.convert_variables(_sub(ocr_flat, "det"), tdet), device)
        trec = TextRecognizer(seq_len=ocr.get("rec_max_width", 480) // 4)
        self.textrec = _load(trec, convert.convert_variables(_sub(ocr_flat, "rec"), trec), device)
        # the captioner's own file, benchmark/captioners/<backend>.py
        self.caption = mf.captioner(cfg)
        self.dims, make_module, _ = self.caption.reference(cfg)
        with torch.device("meta"):
            cap = make_module()
        cap = cap.to_empty(device=device)
        with torch.no_grad():
            for name, t in list(cap.state_dict().items()):
                t.copy_(captioner_state[name])
        self.captioner = cap.float().eval()

    def lower(self) -> "Networks":
        """A copy with float8 products (the control)."""
        other = copy.copy(self)
        for name in ("yolo", "textdet", "textrec", "captioner"):
            setattr(other, name, lowp.to_fp8_products(copy.deepcopy(getattr(self, name))))
        return other


class Judge:
    def __init__(self, cfg: Dict, nets: Networks):
        self.cfg = cfg
        self.nets = nets
        self.dev = nets.device
        p = cfg["pipeline"]
        self.det = p["detector"]
        self.ocr = p["ocr"]
        self.cap = p["captioner"]
        self.merge_iou = p.get("iou_threshold", 0.7)
        self.limits = cfg["limits"]

    # ----------------------------------------------------------- #
    def padded(self, image: np.ndarray):
        h, w = image.shape[:2]
        hb, wb = -(-h // 128) * 128, -(-w // 128) * 128
        out = np.zeros((hb, wb, 3), np.uint8)
        out[:h, :w] = image
        return torch.from_numpy(out).to(self.dev), (h, w)

    @torch.no_grad()
    def image_readings(self, sample: Dict, lower: Optional[Networks]) -> Dict[str, float]:
        """The numbers of one sampled screenshot.  sample: the program's
        outputs for it (see ``harness/samples.py``).  With `lower`, the
        control's numbers: `lower`'s outputs stand in for the program's."""
        nets = self.nets
        padded, hw = self.padded(sample["image"])
        out = sample["out"]
        r: Dict[str, float] = {}

        # detector
        imgsz = self.det.get("default_imgsz", 1280)
        lb, lr, lpad = ops.letterbox(padded, hw, imgsz)
        x = lb.permute(2, 0, 1)[None]
        ref_levels = nets.yolo(x)
        levels = lower.yolo(x) if lower is not None else sample["det"]
        _, ref_scores = decode_predictions(ref_levels)
        _, got_scores = decode_predictions(levels)
        r["det_score_gap"] = float((got_scores[0].max(dim=-1).values
                                    - ref_scores[0].max(dim=-1).values).abs().max())
        r["det_head_gap"] = max(relative_gap(g, f) for gl, fl in zip(levels, ref_levels)
                                for g, f in zip(gl, fl))
        if lower is None:
            r["nms_mismatch"] = float(self.nms_mismatch(sample["det"], lr, lpad, hw, out))

        # text detector
        lb2, _, _ = ops.letterbox(padded, hw, self.ocr.get("det_imgsz", 1920))
        x2 = lb2.permute(2, 0, 1)[None]
        ref_map = torch.clamp(nets.textdet(x2)[0, 0].float(), 0.0, 1.0)
        got_map = (lower.textdet(x2) if lower is not None else sample["ocr_map"])
        got_map = torch.clamp(got_map[0, 0].float(), 0.0, 1.0)
        r["ocr_map_rms_gap"] = rms_gap(got_map, ref_map)
        if lower is None:
            r["components_mismatch"] = float(self.components_mismatch(sample["ocr_map"], hw, out))

        # recogniser over the program's candidate lines
        valid = out["ocr_cand_valid"]
        if valid.any():
            boxes = torch.from_numpy(np.ascontiguousarray(out["ocr_boxes"][valid],
                                                          np.float32)).to(self.dev)
            rec_hw = (self.ocr.get("rec_height", 32), self.ocr.get("rec_max_width", 480))
            lines = ops.bilinear_crops_plain(padded, hw, boxes, rec_hw, grid="line")
            xin = (lines / 255.0).permute(0, 3, 1, 2)
            if lower is not None:
                got = lower.textrec(xin)
            else:  # the blocks the program ran, over its candidate slots
                got = torch.cat(sample["rec"])[torch.from_numpy(np.nonzero(valid)[0]).to(
                    self.dev)]
            r["rec_logit_gap"] = rms_gap(got, nets.textrec(xin))

        if lower is None:
            r["merge_mismatch"] = float(self.merge_mismatch(out))

        # caption crops and captions
        segs = sample["captions"]
        if segs:
            boxes = torch.from_numpy(np.concatenate([s["boxes"] for s in segs])).to(self.dev)
            cs = self.cap.get("crop_size", 64)
            ref_crops = ops.bilinear_crops_plain(padded, hw, boxes.contiguous(), cs)
            got = (lowp.bf16_round(ref_crops) if lower is not None
                   else torch.cat([s["crops"].float() for s in segs]))
            r["crop_gap"] = float((got - ref_crops).abs().max())
            tokens = torch.from_numpy(np.concatenate([s["tokens"] for s in segs])).to(self.dev)
            scores = np.concatenate([s["scores"] for s in segs])
            overflow = np.concatenate([np.full(len(s["tokens"]), s["overflow"]) for s in segs])
            r.update(self.nets.caption.readings(self, ref_crops, tokens.long(), scores,
                                                overflow, lower))
        if lower is None:
            r["results_mismatch"] = float(self.results_mismatch(sample))
        return r

    # -------------------------- OCR components ------------------------ #
    def components_mismatch(self, raw_map, hw, out) -> int:
        """The plain components and unclip over the program's own text map,
        against the candidate slots it downloaded."""
        comps = cc.components(cc.quantized_map(raw_map))
        boxes, valid = cc.candidates(comps["boxes"], hw, self.ocr.get("det_imgsz", 1920),
                                     out["ocr_cand_valid"].shape[0])
        h, w = hw
        wh = np.array([w, h, w, h], np.float32)
        got_valid = out["ocr_cand_valid"].astype(bool)
        differ = got_valid != valid
        differ |= (got_valid & valid) & (np.rint(out["ocr_boxes"] * wh)
                                         != np.rint(boxes * wh)).any(axis=1)
        return int(differ.sum())

    # ------------------------- served elements ------------------------ #
    def caption_text(self, row, logp: float) -> str:
        """A caption's token row as the served string: the structural
        tokenizer's decode (ids under 10 are specials), the captioner's
        confidence gate where the configuration sets one."""
        d = self.nets.dims
        ids = [int(t) for t in row
               if t not in (d.pad_token_id, d.eos_token_id, d.bos_token_id) and t >= 10]
        chars = ((i - 10) % 0x4000 for i in ids)
        text = "".join(chr(c) if 32 <= c < 0xD800 else "?" for c in chars).strip()
        return self.nets.caption.served_text(self.cfg, text, logp)

    def results_mismatch(self, sample) -> int:
        """The elements served to the request against those rebuilt from its
        own download and caption segments: OCR lines kept by the merge,
        then icons that took OCR text, then icons captioned by the model."""
        out, segs = sample["out"], sample["captions"]
        elements = sample["result"][2]
        keep = np.nonzero(out["icon_keep"])[0]
        took_text = out["absorb"][keep].any(axis=1)
        want = [("text", out["ocr_boxes"][k], "box_ocr_content_ocr", None)
                for k in np.nonzero(out["ocr_keep"])[0]]
        want += [("icon", out["det_boxes"][i], "box_yolo_content_ocr", None)
                 for i in keep[took_text]]
        captions = [self.caption_text(row, float(lp)) for s in segs
                    for row, lp in zip(s["tokens"], s["scores"])]
        plain = keep[~took_text]
        want += [("icon", out["det_boxes"][i], "box_yolo_content_yolo", c)
                 for i, c in zip(plain, captions)]
        bad = abs(len(elements) - len(want)) + abs(len(plain) - len(captions))
        for e, (typ, box, source, content) in zip(elements, want):
            if (e["type"] != typ or e["source"] != source
                    or e["bbox"] != [float(v) for v in box]
                    or (content is not None and e["content"] != content)):
                bad += 1
        return bad

    # ------------------------------ K1 ------------------------------ #
    def nms_mismatch(self, levels, r, pad, hw, out) -> int:
        """Greedy NMS (the plain version) over the program's own decoded head,
        with the program's top-k window and compaction, against the kept
        slots it downloaded."""
        boxes, scores = decode_predictions(levels)
        boxes, scores = boxes[0], scores[0].max(dim=-1).values
        thr = self.det.get("box_threshold", 0.05)
        max_det = self.det.get("max_detections", 512)
        keep = scores > thr
        k = min(max(self.det.get("prefilter_topk", 4096), max_det * 2), boxes.shape[0])
        masked = torch.where(keep, scores, torch.full_like(scores, -1.0))
        top_scores, top_idx = torch.sort(masked, descending=True, stable=True)
        top_scores, top_idx = top_scores[:k], top_idx[:k]
        top_boxes = boxes[top_idx]
        top_valid = top_scores > 0
        neg_inf = torch.full((), float("-inf"), device=self.dev)
        sorted_scores, order = torch.sort(torch.where(top_valid, top_scores, neg_inf),
                                          descending=True, stable=True)
        sboxes = top_boxes[order].contiguous()
        kept = ops.greedy_nms_plain(sboxes, top_valid[order].contiguous(),
                                    self.det.get("nms_iou_threshold", 0.1))
        kb = sboxes[kept][:max_det]
        h, w = hw
        wh = torch.tensor([w, h, w, h], dtype=torch.float32, device=self.dev)
        kb = ops.boxes_letterboxed_to_image(kb, r, pad, hw) / wh
        # the zero-area gate at the original dims
        ib = torch.trunc(kb * wh).to(torch.int32)
        area = (ib[:, 2] - ib[:, 0]) * (ib[:, 3] - ib[:, 1])
        want_valid = np.zeros(max_det, bool)
        want_valid[:kb.shape[0]] = (area > 0).cpu().numpy()
        want_boxes = np.zeros((max_det, 4), np.float32)
        want_boxes[:kb.shape[0]] = kb.cpu().numpy()
        got_valid = out["det_valid"].astype(bool)
        differ = got_valid != want_valid
        both = got_valid & want_valid
        differ |= both & (np.abs(out["det_boxes"] - want_boxes) > 1e-6).any(axis=1)
        return int(differ.sum())

    # ------------------------------ K2 ------------------------------ #
    def merge_mismatch(self, out) -> int:
        t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.dev, dtype=dt)
        want = ops.merge_masks_plain(t(out["det_boxes"]), t(out["det_valid"], torch.bool),
                                     t(out["ocr_boxes"]), t(out["ocr_valid"], torch.bool),
                                     self.merge_iou)
        names = ("icon_keep", "ocr_keep", "absorb", "icon_suppressed")
        return sum(int((w.cpu().numpy() != out[n].astype(bool)).sum())
                   for w, n in zip(want, names))

    # ------------------------------------------------------------ #
    def readings(self, samples: List[Dict], lower: Optional[Networks] = None
                 ) -> Dict[str, float]:
        """The worst of each number over the samples."""
        with strict_float32():
            per = [self.image_readings(s, lower) for s in samples]
        out: Dict[str, float] = {}
        for rd in per:
            for k, v in rd.items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def check(self, readings: Dict[str, float]) -> Dict[str, Dict]:
        """Each number beside its limit; a number the sample lacks (no text
        line was found) is left out, and a number without a limit fails."""
        out = {}
        for k, v in readings.items():
            lim = self.limits.get(k)
            out[k] = {"value": v, "limit": lim, "ok": lim is not None and v <= lim}
        return out
