#!/usr/bin/env python3
"""The benchmark of omniparser_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each run is a new process: it draws the cell's screenshots and the seeded
captioner from --seed, builds the pipeline, warms the cell's shapes (set-up),
drives closed-loop clients through the serving batcher for --seconds (the
window), judges a sample of the window's requests against the plain
reference, and prints one JSON line last.  With --trace 0 the line holds the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read by
benchmark/metrics/<name>.py from a traced run.

Everything that belongs to a cell is found by name from BENCHMARK.json:
configs/, traffic/, generators/, metrics/, flops/, and the configuration's
captioner and every hand-written kernel from files of their own:
captioners/<backend>.py, kernels/<kernel>.py.  --device cpu with --tiny
FILE rehearses a cell at small sizes on the CPU (tests only).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# modules that may not be loaded in the process that prints the result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "omniparser_tpu")
# H100 SXM published dense peaks (NVIDIA data sheet, 700 W)
PEAKS = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}
HOST_THREADS = 4   # torch's intra-op threads on the host
TRACE_S = 8.0      # the traced run profiles the window's last TRACE_S seconds


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the control (float8 reference in the program's place)")
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--tiny", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr)
    sys.exit(code)


def merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def plan(traffic, seed, work):
    """Each client's order of the pool, and the sampled requests: client 0's
    first request (the heaviest screenshot of the pool) and, drawn from the
    seed, further (client, k) pairs early enough to finish in any window."""
    import numpy as np

    rng = np.random.default_rng([seed, 1])
    n, clients = len(work), int(traffic["clients"])
    perm = [int(i) for i in rng.permutation(n)]
    heavy = int(np.argmax(work))
    orders = []
    for c in range(clients):
        start = (c * n) // clients
        orders.append([perm[(start + k) % n] for k in range(n)])
    o0 = orders[0]
    j = o0.index(heavy)
    orders[0] = o0[j:] + o0[:j]
    check = traffic["check"]
    sampled = {(0, 0): 0}
    while len(sampled) < int(check["requests"]):
        pair = (int(rng.integers(clients)), int(rng.integers(check["max_index"] + 1)))
        sampled.setdefault(pair, len(sampled))
    return orders, sampled


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))

    import torch

    from benchmark.harness import manifest as mf
    from benchmark.harness import stats

    cell = mf.Cell(mf.load_manifest(ROOT), args.workload)
    cfg, traffic = cell.config, cell.traffic
    if args.tiny:
        with open(args.tiny) as f:
            tiny = json.load(f)
        cfg = merge(cfg, tiny["configs"].get(cell.entry["config"], {}))
        traffic = merge(traffic, tiny["traffic"])
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            fail(f"the cell needs {cell.chips} CUDA device(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device(args.device if args.device != "cuda" else "cuda:0")
    on_card = dev.type == "cuda"
    torch.set_num_threads(HOST_THREADS)

    from benchmark.harness import port, seeded, trace
    from benchmark.harness.loop import Window
    from benchmark.harness.samples import assemble

    # ---------------- set-up: inputs, weights, program, warm-up ---------------- #
    laps = [("imports", time.perf_counter())]
    gen = cell.generator()
    images = gen.make_pool(traffic, args.seed)
    work = gen.work(traffic, args.seed)
    laps.append(("screens", time.perf_counter()))
    captioner = mf.captioner(cfg)  # benchmark/captioners/<backend>.py
    _, make_cap, keep_f32 = captioner.reference(cfg)
    cap_dtype = getattr(torch, cfg["pipeline"]["captioner"].get("dtype", "bfloat16"))
    cap_state = seeded.draw_state(make_cap, args.seed, dev, cap_dtype, keep_f32)
    if on_card:
        torch.cuda.synchronize(dev)
    laps.append(("captioner_draw", time.perf_counter()))
    pipe = port.build(cfg, dev, cap_state, captioner)
    laps.append(("pipeline_build", time.perf_counter()))
    if args.fault:
        from benchmark.harness import faults

        faults.plant(args.fault, pipe)
    k = int(cfg["pipeline"]["captioner"].get("batch_size", 128))
    heavy = sorted(range(len(work)), key=lambda i: -work[i])
    captioner.warm(pipe, traffic["screen"],
                   [images[i] for i in heavy[:int(cfg["pipeline"].get("max_batch_size", 8))]])
    if on_card:
        torch.cuda.synchronize(dev)
    laps.append(("warm_up", time.perf_counter()))
    rec = port.Recorder(pipe, traced=bool(args.trace))
    if args.trace:
        pipe.stage_ms = {}
    orders, sampled = plan(traffic, args.seed, work)
    server = traffic.get("server", {})
    win = Window(pipe, rec, images, int(traffic["clients"]), orders, sampled,
                 int(server.get("max_batch", 8)), float(server.get("batch_window_ms", 5.0)))
    # What set-up made (screens, weights, the program and its imports) goes
    # to the collector's permanent generation, so that a full collection in
    # the window walks only what the window makes: unfrozen, each run paid one
    # pause of 0.1 to 0.3 s there, at a point that differed from run to run.
    gc.collect()
    gc.freeze()
    laps.append(("window_prep", time.perf_counter()))
    setup_s = laps[-1][1] - T_START
    prev = T_START
    for name, t in laps:
        print(f"setup {name} {t - prev:.3f} s", file=sys.stderr)
        prev = t

    # ------------------------------ the window ------------------------------ #
    # The traced run profiles the last TRACE_S seconds before the deadline:
    # the profiler slows every launch from its start on, so the program's
    # spans and counters are read from the batches that ended before it.
    sl = {}
    trace_len = min(TRACE_S, 0.4 * args.seconds)

    def during(t0):
        if args.trace and on_card:
            sl.update(trace.profile_slice(dev, args.seconds - trace_len, trace_len, t0))

    w = win.run(args.seconds, during)
    gc.unfreeze()
    cut = w["t0"] + args.seconds - trace_len if sl else w["t1"]
    rec.close()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    done = [r for r in win.requests if r["error"] is None]
    failed = [r for r in win.requests if r["error"] is not None]
    lat = [(r["end"] - r["submit"]) * 1e3 for r in done]

    metrics = {}
    if not args.trace:
        values = {"screenshots_per_s": stats.rate(len(done), w["window_s"]),
                  "parse_p50_ms": stats.nearest_rank(lat, 50) if lat else None,
                  "parse_p90_ms": stats.nearest_rank(lat, 90) if lat else None,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    breakdown = None
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
              "count": cell.chips if on_card else 0, "memory_peak_bytes": peak}
    if args.trace:
        red = None
        if sl:
            red = trace.reduce_slice(sl, trace.host_spans(win.batches, rec.caption_host))
            device["busy_s"] = red["busy_s"]
            device["window_s"] = red["window_s"]
            breakdown = {
                "device_ops": sorted(([n[:120], v[0]] for n, v in red["by_name"].items()),
                                     key=lambda r: -r[1])[:10],
                "idle_gaps": [[lab, s] for lab, s in red["gaps"]]}
        run = reduce_run(cfg, win, w, rec, red, cut)
        for m in cell.per_layer:
            v = mf.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # --------------------- the comparison, after the window --------------------- #
    samples = assemble(win.captured, captioner.fused(cfg), k, pipe._DECODE_CHUNK)
    missing = sorted(set(sampled.values()) - {s["key"] for s in samples})
    del win, rec, pipe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from benchmark.reference.judge import Judge, Networks

    nets = Networks(cfg, cap_state, dev, {
        name: os.path.join(ROOT, path) for name, path in cfg["trees"].items()})
    judge = Judge(cfg, nets)
    def passes(checks):
        return bool(checks) and all(c["ok"] for c in checks.values())

    checks = judge.check(judge.readings(samples)) if samples else {}
    control = None
    if args.control:
        control = judge.check(judge.readings(samples, nets.lower()))
    correct = passes(checks) and not failed and not missing

    found = forbidden_modules()
    if found:
        fail(f"modules that the benchmark may not load were loaded: {found}", 3)
    line = {"correct": correct, "attempted": len(done) + len(failed), "failed": len(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if control is not None:
        line["control"] = {n: c["value"] for n, c in control.items()}
        line["control_correct"] = passes(control)
    if missing:
        line["unsampled"] = missing
    line["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    for r in failed[:3]:
        print(f"failed request: {r['error']}", file=sys.stderr)
    for n, c in (control or {}).items():
        print(f"control {n} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
    if control is not None:
        print(f"control_correct {line['control_correct']}", file=sys.stderr)
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


def reduce_run(cfg, win, w, rec, red, cut):
    """What the per-layer readers read (see benchmark/metrics/): the program's
    spans and counters over the batches that ended by `cut`, the device's
    view over the profiled slice."""
    from benchmark.harness import manifest as mf

    work_cfg = cfg["work"]
    flops = 0
    per_shot = sum(mf.flops_of(n)(cfg) for n in work_cfg["per_screenshot"])
    per_line = mf.flops_of(work_cfg["per_line"])(cfg)
    per_cap = mf.flops_of(work_cfg["per_caption"])(cfg)
    batches = [b for b in win.batches if b["t1"] <= cut]
    for c in rec.counts:
        if c["batch"] < len(batches):
            flops += per_shot + per_line * c["lines"] + per_cap * c["captions"]
    done = [r for r in win.requests if r["error"] is None and r["end"] <= cut]
    # each kernel of benchmark/kernels/: the work of every call the window
    # made, and its device time and launches in the traced slice
    kernels = mf.kernels()
    kernel_work = {name: [k.work(c) for c in rec.kernel_calls.get(name, [])]
                   for name, k in kernels.items()}
    tr = None
    if red is not None:
        device = {}
        for name, k in kernels.items():
            secs = sum(v[0] for n, v in red["by_name"].items()
                       if any(s in n for s in k.KERNELS))
            count = sum(v[1] for n, v in red["by_name"].items() if k.COUNT_BY in n)
            device[name] = {"seconds": secs, "count": count}
        tr = {"busy_s": red["busy_s"], "window_s": red["window_s"], "kernels": device}
    return {"requests": done, "batches": batches, "window_s": (batches[-1]["t1"] - w["t0"]
                                                               if batches else 0.0),
            "shots": sum(b["size"] for b in batches),
            "stage_ms": batches[-1]["stage_ms"] if batches else {},
            "caption_ms": rec.caption_ms(cut), "flops": flops, "peaks": PEAKS,
            "kernel_work": kernel_work, "trace": tr}


if __name__ == "__main__":
    sys.exit(main())
