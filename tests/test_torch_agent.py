"""The JAX package's agent loop against the port's server: the loop talks
HTTP to whatever serves ``/parse/`` (which is why ``agent/`` is not
copied into the port), so the port's ``OmniparserServer`` over its own
pipeline must answer the agent's requests."""

import http.server
import threading

import numpy as np
import pytest
import torch

from omniparser_tpu.agent.llm import MockLLM
from omniparser_tpu.agent.loop import sampling_loop_sync
from omniparser_tpu.agent.mock_vm import MockVM
from omniparser_tpu_torch.config import (CaptionerConfig, DetectorConfig, OcrConfig,
                                         PipelineConfig, ServerConfig)
from omniparser_tpu_torch.serving import OmniparserServer
from omniparser_tpu_torch.utils.image import decode_base64_image


@pytest.fixture()
def vm():
    vm = MockVM()
    url = vm.start()
    yield vm, url
    vm.stop()


def _port_pipeline():
    """A reduced seeded port pipeline on the CPU, as
    tests/test_torch_serving.py's real-pipeline test builds it."""
    from omniparser_tpu_torch.models.florence2 import FlorenceCaptioner, FlorenceDims
    from omniparser_tpu_torch.pipeline import SOMPipeline

    tiny = FlorenceDims(embed_dims=(8, 16, 32, 64), num_heads=(1, 2, 4, 8),
                        num_groups=(1, 2, 4, 8), depths=(1, 1, 1, 1), window_size=4,
                        d_model=32, encoder_layers=1, decoder_layers=2, attn_heads=4,
                        ffn_dim=64, vocab_size=160, max_positions=64)
    cfg = PipelineConfig(
        detector=DetectorConfig(default_imgsz=128, max_detections=16, box_threshold=0.01,
                                dtype="float32"),
        captioner=CaptionerConfig(batch_size=8, crop_size=32, max_new_tokens=4,
                                  dtype="float32"),
        ocr=OcrConfig(backend="null"), detector_weights=None)
    cap = FlorenceCaptioner(cfg.captioner, tiny, device="cpu",
                            generator=torch.Generator().manual_seed(1))
    return cfg, SOMPipeline(cfg, device="cpu", captioner=cap)


def test_sampling_loop_against_the_port_server(vm):
    """Full loop: mock VM, the port's HTTP server over its own pipeline,
    a scripted LLM.  The click reaches the VM and every screen_info line
    of the port's parse reaches the prompt."""
    vm_obj, vm_url = vm
    cfg, pipe = _port_pipeline()
    srv = OmniparserServer(cfg, ServerConfig(port=0), pipeline=pipe)
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    llm = MockLLM([
        '```json\n{"Reasoning": "click it", "Next Action": "left_click", "Box ID": 0}\n```',
        '```json\n{"Reasoning": "done", "Next Action": "None"}\n```',
    ])
    try:
        turns = list(sampling_loop_sync(
            task="open the first element", model="omniparser + gpt-4o", provider="mock",
            llm_client=llm, omniparser_url=f"http://127.0.0.1:{httpd.server_address[1]}",
            vm_url=vm_url, max_turns=5))
    finally:
        httpd.shutdown()
        srv.batcher.close()
    assert [t["action"]["Next Action"] for t in turns] == ["left_click", "None"]
    assert any("pyautogui.click()" in " ".join(c) for c in vm_obj.commands)
    screenshot = decode_base64_image(vm_obj.screenshot_png_b64())
    _, _, elements = pipe.parse_image(np.ascontiguousarray(screenshot))
    assert elements
    prompt = llm.calls[0]["system"]
    for i, e in enumerate(elements):
        line = f"ID: {i}, {'Text' if e['type'] == 'text' else 'Icon'}: {e['content']}"
        assert line in prompt, line
