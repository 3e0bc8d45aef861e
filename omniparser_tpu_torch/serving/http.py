"""HTTP serving with the reference's REST contract, over the port.

Endpoints:
  POST /parse/  {"base64_image": ...} ->
      {"som_image_base64": ..., "parsed_content_list": [...], "latency": s}
  GET  /probe/  -> {"message": "Omniparser API ready"}
  GET  /metrics -> counters and histograms (JSON; ?format=prometheus); with
                   --trace also each span of the pipeline's recorder as
                   span_<name>_seconds and each counter as <name>_total
  GET  / , /demo -> a one-page upload demo

Implementation: stdlib ThreadingHTTPServer + MicroBatcher, so concurrent
requests share one ``SOMPipeline.parse_batch`` call (one batched caption
decode).  The same contract, flags and responses as the JAX package's
``serving/http.py``; run it with

    python -m omniparser_tpu_torch.serving --port 8000      # on the card
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from omniparser_tpu_torch.config import PipelineConfig, ServerConfig
from omniparser_tpu_torch.utils.profiling import recorder

# parse_batch sizes, in screenshots
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)
# span durations (seconds): from a kernel launch's tens of microseconds up
# to a beam decode's seconds
SPAN_BUCKETS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0)

# Zero-dependency interactive demo page.
DEMO_PAGE = """<!doctype html><html><head><title>omniparser_tpu_torch</title>
<style>body{font-family:sans-serif;max-width:1100px;margin:2em auto}
img{max-width:100%;border:1px solid #ccc}pre{background:#f4f4f4;padding:1em;
overflow:auto;max-height:320px}</style></head><body>
<h2>omniparser_tpu_torch demo</h2>
<input type=file id=f accept=image/*> <span id=st></span>
<div id=out></div>
<script>
document.getElementById('f').onchange = async (ev) => {
  const file = ev.target.files[0]; if (!file) return;
  const st = document.getElementById('st'); st.textContent = 'parsing...';
  const b64 = await new Promise(r => { const fr = new FileReader();
    fr.onload = () => r(fr.result.split(',')[1]); fr.readAsDataURL(file); });
  const t0 = performance.now();
  const resp = await fetch('/parse/', {method: 'POST',
    body: JSON.stringify({base64_image: b64})});
  const data = await resp.json();
  st.textContent = `${((performance.now()-t0)/1000).toFixed(2)}s, ` +
    `${data.parsed_content_list.length} elements`;
  document.getElementById('out').innerHTML =
    `<img src="data:image/png;base64,${data.som_image_base64}">` +
    `<pre>${JSON.stringify(data.parsed_content_list, null, 1)}</pre>`;
};
</script></body></html>"""


class OmniparserServer:
    """The REST server.  pipeline: a built SOMPipeline (or a stand-in with
    its parse_batch); without one it builds
    ``SOMPipeline(pipeline_config, device)``, on the card by default.
    trace: turn the process's span recorder on and export each batch's
    spans and counters (the pipeline's ``last_trace``) at /metrics."""

    def __init__(self, pipeline_config: PipelineConfig, server_config: ServerConfig = None,
                 pipeline=None, device="cuda", trace: bool = False):
        from omniparser_tpu_torch.pipeline import SOMPipeline
        from omniparser_tpu_torch.serving.batcher import MicroBatcher
        from omniparser_tpu_torch.utils.image import decode_base64_image, encode_image_base64
        from omniparser_tpu_torch.utils.metrics import Metrics, jlog

        self.server_config = server_config or ServerConfig()
        self.pipeline = pipeline or SOMPipeline(pipeline_config, device)
        self._decode = decode_base64_image
        self._encode = encode_image_base64
        self.metrics = Metrics()
        self._jlog = jlog
        self.trace = trace
        if trace:
            recorder.enable()

        def process_batch(images):
            # items are pre-decoded np arrays: a bad-base64 request fails in
            # its own handler thread (400) and can't poison batch-mates
            t0 = time.perf_counter()
            results = self.pipeline.parse_batch(images)
            self.metrics.observe("parse_batch_size", len(images), BATCH_BUCKETS)
            self.metrics.observe("parse_batch_seconds", time.perf_counter() - t0)
            for name, v in self.pipeline.last_timings.items():
                self.metrics.observe(f"stage_{name}_seconds", v)
            if self.trace and getattr(self.pipeline, "last_trace", None) is not None:
                self._export(self.pipeline.last_trace)
            return [(self._encode(annotated), elements)
                    for annotated, _, elements in results]

        self.batcher = MicroBatcher(
            process_batch,
            max_batch=self.server_config.max_batch,
            batch_window_ms=self.server_config.batch_window_ms,
        )
        self._httpd: Optional[ThreadingHTTPServer] = None

    def _export(self, trace) -> None:
        """A trace's spans and counters under Prometheus names ('.' -> '_')."""
        for s in trace.spans:
            self.metrics.observe(f"span_{s.name.replace('.', '_')}_seconds", s.t1 - s.t0,
                                 SPAN_BUCKETS)
        for name, n in trace.counts.items():
            self.metrics.count(f"{name.replace('.', '_')}_total", n)

    def parse(self, base64_image: str):
        t0 = time.perf_counter()
        image = self._decode(base64_image)  # per-request; errors -> 400 here
        som_b64, elements = self.batcher.submit(image).result()
        latency = time.perf_counter() - t0
        self.metrics.observe("parse_latency_seconds", latency)
        self.metrics.count("parse_elements_total", len(elements))
        self._jlog("parse", latency_s=round(latency, 4),
                   image_hw=list(image.shape[:2]), elements=len(elements))
        return {
            "som_image_base64": som_b64,
            "parsed_content_list": elements,
            "latency": latency,
        }

    # ------------------------------------------------------------------ #

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                server.metrics.count(f'responses_total{{code="{code}"}}')
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path.rstrip("/") == "/probe":
                    self._send(200, {"message": "Omniparser API ready"})
                elif path.rstrip("/") == "/metrics":
                    if "format=prometheus" in query:
                        body = server.metrics.render_prometheus().encode()
                        server.metrics.count('responses_total{code="200"}')
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; version=0.0.4")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self._send(200, server.metrics.snapshot())
                elif self.path in ("/", "/demo"):
                    body = DEMO_PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path.rstrip("/") != "/parse":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(data, dict):
                        raise TypeError("body must be a JSON object")
                    b64 = data["base64_image"]
                except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    self._send(200, server.parse(b64))
                except (ValueError, OSError) as e:  # bad image payloads
                    self._send(400, {"error": f"bad image: {e}"})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": str(e)})

        return Handler

    def serve_forever(self, host=None, port=None):
        host = host or self.server_config.host
        port = port if port is not None else self.server_config.port
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"omniparser_tpu_torch server on {host}:{self._httpd.server_address[1]}",
              flush=True)
        self._httpd.serve_forever()

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()
        self.batcher.close()
        if self.trace:
            recorder.disable()


def main(argv=None):
    ap = argparse.ArgumentParser("omniparser_tpu_torch server")
    ap.add_argument("--som_model_path", default=None)
    ap.add_argument("--caption_model_name", default="florence2")
    ap.add_argument("--caption_model_path", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs: 'cuda' (the default) or 'cpu'")
    ap.add_argument("--BOX_TRESHOLD", type=float, default=0.05)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--ocr_backend", default="jax")
    ap.add_argument("--max_som_side", type=int, default=1920,
                    help="SOM overlay canvas cap (0 = native resolution); "
                    "drawing+PNG at 4K costs 0.1-0.4 s/request")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="shard batched parses over a device mesh, e.g. '8,1' (data "
                    "parallel) or '4,2' (dp x captioner tensor parallel); requires "
                    "dp*tp CUDA devices (with --device cpu: a mesh of dp*tp CPU entries)")
    ap.add_argument("--trace", action="store_true",
                    help="record the pipeline's spans and counters (utils/profiling) and "
                    "export them at /metrics")
    args = ap.parse_args(argv)

    import dataclasses

    # no compilation cache to enable (the JAX server's first step): eager
    # PyTorch compiles no graphs, and the CUDA kernels' builds are kept by
    # ops/cuda_build under omniparser_tpu_torch/build/, keyed by their source

    base = PipelineConfig()
    cfg = dataclasses.replace(
        base,
        detector=dataclasses.replace(base.detector, box_threshold=args.BOX_TRESHOLD),
        ocr=dataclasses.replace(base.ocr, backend=args.ocr_backend),
        # explicit CLI paths (exported .npz files) win; otherwise the
        # 'auto' defaults load the exported shipped checkpoints
        detector_weights=args.som_model_path or "auto",
        captioner_weights=args.caption_model_path or "auto",
        max_som_side=args.max_som_side or None,
    )
    pipeline = None
    if args.mesh:
        from omniparser_tpu_torch.parallel.mesh import make_mesh
        from omniparser_tpu_torch.parallel.sharded_parse import ShardedServingPipeline
        from omniparser_tpu_torch.pipeline import SOMPipeline

        dp, tp = (int(x) for x in args.mesh.split(","))
        # every visible card (raises with fewer than dp*tp), or the CPU repeated
        mesh = make_mesh(None if args.device == "cuda" else [args.device] * (dp * tp),
                         dp=dp, tp=tp)
        pipeline = ShardedServingPipeline(SOMPipeline(cfg, mesh.row_device(0)), mesh)
    server = OmniparserServer(cfg, ServerConfig(host=args.host, port=args.port),
                              pipeline=pipeline, device=args.device, trace=args.trace)
    server.pipeline.warmup()  # the kernels' build and first launches, before any request
    server.serve_forever()


if __name__ == "__main__":
    main()
