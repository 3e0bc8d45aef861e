#!/usr/bin/env python3
"""Start the port's REST server as a user would and drive it over HTTP.

    python3 scripts/serve_smoke.py [--device cuda] [--requests 8] [--port N]

Runs ``python -m omniparser_tpu_torch.serving`` (its defaults: the 'auto'
weights, the trained orbax trees committed under ``omniparser_tpu/weights/``;
warm-up before it serves) on ``--port`` (default: a free port chosen at start), waits until
that process's log says it listens there and ``GET /probe/`` answers, then
sends one ``POST /parse/`` alone and
``--requests`` at once (synthetic screenshots of ``chip_smoke.py``, three
sizes), a malformed body (must answer 400) and ``GET /metrics``.  Checks the
contract of every answer, prints one JSON line with the latencies and the
server's metrics, and stops the server.  Exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((1080, 1920), (768, 1366), (1440, 2560))
KEYS = {"som_image_base64", "parsed_content_list", "latency"}
ELEMENT_KEYS = {"type", "bbox", "interactivity", "content", "source"}


def fail(msg: str) -> None:
    print(f"serve_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def free_port() -> int:
    """A port that nothing on 127.0.0.1 listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--port", type=int, default=0, help="0: a free port chosen at start")
    ap.add_argument("--start-timeout", type=float, default=900.0)
    args = ap.parse_args()

    from chip_smoke import synthetic_screenshot
    from omniparser_tpu_torch.utils.image import encode_image_base64

    port = args.port or free_port()
    base = f"http://127.0.0.1:{port}"
    listening = f"omniparser_tpu_torch server on 127.0.0.1:{port}"
    log_path = os.path.join(ROOT, "chiprun_out", "serve_smoke_server.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    images = [synthetic_screenshot(np.random.default_rng(100 + i), *SHAPES[i % len(SHAPES)])
              for i in range(args.requests + 1)]
    bodies = [json.dumps({"base64_image": encode_image_base64(im)}).encode() for im in images]

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, json.loads(r.read())

    def post(body):
        req = urllib.request.Request(base + "/parse/", body, {"Content-Type": "application/json"})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                out = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            out = e.code, None
        return (time.perf_counter() - t) * 1e3, out

    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        server = subprocess.Popen(
            [sys.executable, "-m", "omniparser_tpu_torch.serving", "--host", "127.0.0.1",
             "--port", str(port), "--device", args.device],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                if server.poll() is not None:
                    fail(f"the server exited with {server.returncode} (see {log_path})")
                # probe only once this process has bound the port: anything
                # else listening there would answer the probe too
                with open(log_path) as f:
                    bound = listening in f.read()
                try:
                    if bound and get("/probe/")[0] == 200:
                        break
                except (urllib.error.URLError, ConnectionError):
                    pass
                if time.perf_counter() - t0 > args.start_timeout:
                    fail("the server did not answer /probe/ in time")
                time.sleep(0.5)
            start_s = time.perf_counter() - t0
            alone_ms, alone = post(bodies[0])
            t1 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=args.requests) as ex:
                answers = list(ex.map(post, bodies[1:]))
            burst_ms = (time.perf_counter() - t1) * 1e3
            bad_status = post(b"{not json")[1][0]
            _, metrics = get("/metrics")
        finally:
            server.terminate()
            try:
                server.wait(30)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait(30)

    elements = []
    for i, (_, (code, body)) in enumerate([(alone_ms, alone)] + answers):
        if code != 200 or body is None or set(body) != KEYS:
            fail(f"request {i} answered {code} with {sorted(body or {})}")
        for e in body["parsed_content_list"]:
            if set(e) != ELEMENT_KEYS or e["content"] is None:
                fail(f"request {i}: malformed element {e}")
        elements.append(len(body["parsed_content_list"]))
    if bad_status != 400:
        fail(f"a malformed body answered {bad_status}, not 400")
    lat = sorted(ms for ms, _ in answers)
    hists = metrics["histograms"]
    sizes = hists.get("parse_batch_size", {})
    print(json.dumps({
        "device": args.device, "server_start_seconds": round(start_s, 2),
        "shapes": [list(im.shape) for im in images], "elements": elements,
        "alone_ms": round(alone_ms, 2),
        "burst": {"requests": args.requests, "wall_ms": round(burst_ms, 2),
                  "requests_per_s": args.requests / burst_ms * 1e3,
                  "p50_ms": float(np.percentile(lat, 50)),
                  "p99_ms": float(np.percentile(lat, 99)),
                  "all_ms": [round(x, 2) for x in lat]},
        "batches": sizes.get("count"), "requests_batched": sizes.get("sum"),
        "server_seconds_mean": {k: v["mean"] for k, v in sorted(hists.items())
                                if k.endswith("_seconds")},
        "sample": [e for e in alone[1]["parsed_content_list"][:3]]}), flush=True)
    if server.returncode is None:
        fail("the server is still running")


if __name__ == "__main__":
    main()
