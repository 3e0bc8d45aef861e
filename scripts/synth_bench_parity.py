#!/usr/bin/env python3
"""The synthetic grounding benchmark through the port and through the JAX
package, on the same held-out scenes, with the same trained weights.

    python scripts/synth_bench_parity.py [--scenes 2] [--seed 777555] [--out DIR]

Each side runs in a process of its own, one after the other (the JAX
pipeline at its default widths peaks near 24 GB of host memory): the JAX
package's ``eval/synth_bench.run`` with its shipped checkpoints, then the
port's with the same trees read through its 'auto' fields on the CPU (``--device``), both at their
default widths and dtypes (bfloat16) with the detector at the scenes' 640.
Each writes its records as JSONL into --out; the parent compares them row
for row and prints one JSON line: each side's scores, and the rows whose
correctness, or predicted point (beyond one pixel of the 640 scene),
differ.  The scenes need TTF fonts (``train/synth_text.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_side(side: str, scenes: int, seed: int, log: str, device: str) -> dict:
    t0 = time.perf_counter()
    if side == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from omniparser_tpu.eval import synth_bench

        scores = synth_bench.run(scenes, seed, log_path=log)
    else:
        from omniparser_tpu_torch.eval import synth_bench

        scores = synth_bench.run(scenes, seed, log_path=log, device=device)
    return {"side": side, "scores": scores, "seconds": round(time.perf_counter() - t0, 1)}


def compare(jax_log: str, torch_log: str) -> dict:
    rows = []
    for path in (jax_log, torch_log):
        with open(path) as f:
            rows.append([json.loads(line) for line in f])
    differ = []
    for i, (j, t) in enumerate(zip(*rows)):
        same = j["correctness"] == t["correctness"] and (j["pred"] is None) == (t["pred"] is None)
        if same and j["pred"] is not None:
            same = max(abs(a - b) for a, b in zip(j["pred"], t["pred"])) <= 1.0 / 640
        if j["instruction"] != t["instruction"] or not same:
            differ.append({"row": i, "instruction": t["instruction"], "jax": [j["correctness"], j["pred"]],
                           "torch": [t["correctness"], t["pred"]]})
    return {"rows": [len(r) for r in rows], "rows_differing": len(differ), "differing": differ}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=777555)
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--out", default=None, help="where the records go (default: a "
                    "temporary directory, removed at the end)")
    ap.add_argument("--side", choices=("jax", "torch"), default=None,
                    help="run one side in this process (the parent runs both)")
    args = ap.parse_args()
    if args.side:
        print(json.dumps(run_side(args.side, args.scenes, args.seed,
                                  os.path.join(args.out, f"{args.side}.jsonl"), args.device)),
              flush=True)
        return
    with tempfile.TemporaryDirectory(prefix="synth_bench_parity_") as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        results = {}
        for side in ("jax", "torch"):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", side,
                                  "--scenes", str(args.scenes), "--seed", str(args.seed),
                                  "--device", args.device, "--out", out_dir],
                                 capture_output=True, text=True, check=True)
            results[side] = json.loads(out.stdout.strip().splitlines()[-1])
        agreement = compare(os.path.join(out_dir, "jax.jsonl"),
                            os.path.join(out_dir, "torch.jsonl"))
    print(json.dumps({"scenes": args.scenes, "seed": args.seed, **results,
                      "agreement": agreement}))


if __name__ == "__main__":
    main()
