#!/usr/bin/env python3
"""Time the design variants that the NMS, crop and merge kernels were chosen from.

    python3 scripts/kernel_variants.py [--seed N]

Three questions, each answered on one card in one process, in turns:

  nms_stages  csrc/nms.cu built with SCAN_STAGES = 2, 3 and 4 (how many
              bitmask column copies its scans keep in shared memory); each
              build's mask and scan launches timed apart at chip_smoke.py's
              cases (its N=4096 window, every box kept, N=8192 on the
              streaming scan), each build's keep mask held to nms_keep_plain.
  crop_band   every variant of scripts/crop_band_variants.cu (one block per
              box and band of output rows, tap rows staged in shared memory)
              against the shipped csrc/crop.cu, at chip_smoke.py's caption
              grid (128 boxes at 64x64) and line grid (32 lines at 32x480);
              each variant must equal the shipped kernel bit for bit.
  merge       every variant of scripts/merge_variants.cu (rows a block, warps
              a row, no division for disjoint pairs) against the shipped
              fused merge (csrc/overlap.cu, hopper_kernels.merge_masks) at
              512 icons x 256 OCR boxes: chip_smoke.py's case, the same
              boxes with no valid OCR box and with nothing valid, and a
              parse-like case (70 valid icons, 6 valid OCR boxes); each
              variant must equal the shipped kernel in all four masks, but
              the two "breakdown" builds, which time parts of the kernel.

    python3 scripts/kernel_variants.py --only merge   # one question alone

Prints one JSON line per measurement, then the card's nvidia-smi name and
power limit, and last {"ok": true, ...}.  Builds into the git-ignored
omniparser_tpu_torch/build/.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from omniparser_tpu_torch.ops import cuda_build, hopper_crop, hopper_kernels  # noqa: E402

STAGES = (2, 3, 4)


def build(sources: dict) -> dict:
    """{name: path of a .cu} -> {name: loaded library}, nvcc in parallel."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = []
    for name, src in sources.items():
        out = os.path.join(cuda_build.BUILD_DIR, f"variant_{name}.so")
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", out, src]
        procs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(out)
    return libs


def nms_stage_sources() -> dict:
    with open(os.path.join(cuda_build.CSRC_DIR, "nms.cu")) as f:
        text = f.read()
    if len(re.findall(r"^#define SCAN_STAGES \d+", text, flags=re.M)) != 1:
        raise RuntimeError("nms.cu: no single '#define SCAN_STAGES' line to vary")
    sources = {}
    for s in STAGES:
        path = os.path.join(cuda_build.BUILD_DIR, f"nms_stages{s}.cu")
        with open(path, "w") as f:
            f.write(re.sub(r"^#define SCAN_STAGES \d+", f"#define SCAN_STAGES {s}", text,
                           flags=re.M))
        sources[f"nms_stages{s}"] = path
    return sources


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("nms_stages", "crop_band", "merge"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cuda_build.build_all()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    wanted = lambda q: args.only in (None, q)
    sources = {}
    if wanted("nms_stages"):
        sources.update(nms_stage_sources())
    if wanted("crop_band"):
        sources["crop_band"] = os.path.join(ROOT, "scripts", "crop_band_variants.cu")
    if wanted("merge"):
        sources["merge"] = os.path.join(ROOT, "scripts", "merge_variants.cu")
    libs = build(sources)
    ok = True
    if wanted("nms_stages"):
        nms_stages(libs, args.seed)
    if wanted("crop_band"):
        ok &= crop_band(libs, args.seed)
    if wanted("merge"):
        ok &= merge(libs, args.seed)
    print(smi, flush=True)
    if not ok:
        sys.exit("kernel_variants: a variant disagrees with the shipped kernel")
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)


def nms_stages(libs, seed: int) -> None:
    """K1: column stages, at chip_smoke.py's draws."""
    cu = lambda a: torch.from_numpy(a).to("cuda")
    rng = np.random.default_rng(seed)
    chip_smoke.nms_case(rng, 512)
    cases = {"n4096_window": chip_smoke.nms_case(rng, 4096)}
    edge = chip_smoke.nms_edge_cases(np.random.default_rng(seed + 7))
    cases["all_kept"], cases["n8192"] = edge["all_kept"], edge["n8192"]
    thr = 0.1
    for case, (boxes, valid) in cases.items():
        b, v = cu(boxes), cu(valid)
        times = {s: [] for s in STAGES}
        for s in STAGES + STAGES[::-1]:  # 2, 3, 4, 4, 3, 2
            # nms_stage_ms fails the run if the keep mask differs from the plain version
            times[s].append(chip_smoke.nms_stage_ms(b, v, thr, lib=libs[f"nms_stages{s}"]))
        for s in STAGES:
            print(json.dumps({"kernel": "nms_keep", "case": case, "n": len(valid),
                              "scan_stages": s, "mask_ms": [t[0] for t in times[s]],
                              "scan_ms": [t[1] for t in times[s]]}), flush=True)



def crop_band(libs, seed: int) -> bool:
    """K3: band variants, at chip_smoke.py's draws."""
    cu = lambda a: torch.from_numpy(a).to("cuda")
    ok = True
    rng = np.random.default_rng(seed)
    chip_smoke.nms_case(rng, 512)
    chip_smoke.nms_case(rng, 4096)
    chip_smoke.overlap_case(rng, 512, 256)
    img, hw, boxes = chip_smoke.crop_case(rng, 128)
    im, bx = cu(img), cu(boxes)
    lb = bx[:32].clone()
    lb[:, 2] = torch.clamp(lb[:, 0] + (lb[:, 2] - lb[:, 0]) * 4, max=1.0)
    band = libs["crop_band"]
    band.crop_band_variant_name.argtypes = [ctypes.c_int]
    band.crop_band_variant_name.restype = ctypes.c_char_p
    launch = band.crop_band_launch
    launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int
    names = []
    while band.crop_band_variant_name(len(names)) is not None:
        names.append(band.crop_band_variant_name(len(names)).decode())
    stream = cuda_build.current_stream()
    for grid_name, bxs, out_hw, grid in (("caption_grid", bx, (64, 64), "resize"),
                                         ("line_grid", lb, (32, 480), "line")):
        k = bxs.shape[0]
        shipped = lambda: hopper_crop.crop_resize(im, hw, bxs, out_hw, grid=grid)
        want = shipped()
        out = torch.empty_like(want)
        shipped_ms = [chip_smoke.time_ms(shipped, 200)]
        for i, name in enumerate(names):
            def variant():
                cuda_build.check(launch(i, im.data_ptr(), bxs.data_ptr(), out.data_ptr(), k,
                                        img.shape[0], img.shape[1], hw[0], hw[1], *out_hw,
                                        0 if grid == "resize" else 1, stream), name)

            out.fill_(float("nan"))
            variant()
            same = bool(torch.equal(out, want))
            ok &= same
            ms = [chip_smoke.time_ms(variant, 200)]
            shipped_ms.append(chip_smoke.time_ms(shipped, 200))
            ms.append(chip_smoke.time_ms(variant, 200))
            print(json.dumps({"kernel": "crop_resize", "grid": grid_name, "k": k,
                              "out": list(out_hw), "variant": name, "identical": same,
                              "ms": ms}), flush=True)
        print(json.dumps({"kernel": "crop_resize", "grid": grid_name, "k": k,
                          "out": list(out_hw), "variant": "shipped csrc/crop.cu",
                          "ms": shipped_ms}), flush=True)
    return ok


def merge(libs, seed: int) -> bool:
    """K2's fused merge: the variants of scripts/merge_variants.cu against
    the shipped kernel, each timed twice, the shipped kernel between."""
    cu = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    rng = np.random.default_rng(seed + 11)  # chip_smoke.merge_record's draws
    main = {name: make(rng) for name, make in chip_smoke.MERGE_CASES.items()}["512x256"]
    icons, iv, ocr, ov = main
    parse_iv = np.zeros_like(iv)
    parse_iv[:70] = True
    parse_ov = np.zeros_like(ov)
    parse_ov[:6] = True
    cases = {"chip_smoke_512x256": main,
             "no_valid_ocr": (icons, iv, ocr, np.zeros_like(ov)),
             "nothing_valid": (icons, np.zeros_like(iv), ocr, np.zeros_like(ov)),
             "parse_like_70_icons_6_ocr": (icons, parse_iv, ocr, parse_ov)}
    lib = libs["merge"]
    lib.merge_variant_name.argtypes = [ctypes.c_int]
    lib.merge_variant_name.restype = ctypes.c_char_p
    launch = lib.merge_variant_launch
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    launch.argtypes = [i32] + [vp] * 4 + [i32, i32, ctypes.c_float] + [vp] * 6
    launch.restype = i32
    names = []
    while lib.merge_variant_name(len(names)) is not None:
        names.append(lib.merge_variant_name(len(names)).decode())
    thr = chip_smoke.MERGE_IOU
    stream = cuda_build.current_stream()
    ok = True
    for case, arrays in cases.items():
        a = tuple(cu(x) for x in arrays)
        n, m = a[0].shape[0], a[2].shape[0]
        shipped = lambda: hopper_kernels.merge_masks(*a, thr)
        want = shipped()
        outs = tuple(torch.empty_like(w) for w in want)
        scratch = torch.zeros(((m + 31) // 32 + 1,), dtype=torch.int32, device="cuda")
        shipped_ms = [chip_smoke.time_ms(shipped, 200)]
        for v, name in enumerate(names):
            def variant():
                cuda_build.check(launch(v, *(t.data_ptr() for t in a), n, m, thr,
                                        *(t.data_ptr() for t in outs), scratch.data_ptr(),
                                        stream), name)

            for t in outs:
                t.fill_(True)
            variant()
            same = all(bool(torch.equal(g, w)) for g, w in zip(outs, want))
            ms = [chip_smoke.time_ms(variant, 200)]
            same &= all(bool(torch.equal(g, w)) for g, w in zip(outs, want))
            ok &= same or name.startswith("breakdown")  # those time a part only
            shipped_ms.append(chip_smoke.time_ms(shipped, 200))
            ms.append(chip_smoke.time_ms(variant, 200))
            print(json.dumps({"kernel": "merge_masks", "case": case, "n": n, "m": m,
                              "variant": name, "identical": same, "ms": ms}), flush=True)
        print(json.dumps({"kernel": "merge_masks", "case": case, "n": n, "m": m,
                          "variant": "shipped csrc/overlap.cu", "ms": shipped_ms}), flush=True)
    return ok


if __name__ == "__main__":
    main()
