"""omniparser_tpu_torch — the screen-parsing framework in PyTorch and CUDA.

The port of the JAX package ``omniparser_tpu`` (which stays in the
repository as the reference) for one NVIDIA Hopper card: a raw GUI
screenshot becomes a structured list of UI elements
``{type, bbox, interactivity, content, source}`` plus a numbered
Set-of-Mark overlay.  Plain tensor code is PyTorch; the three kernels the
JAX package wrote for the TPU (greedy NMS, the merge matrices, the
bilinear crop-gather) are hand-written CUDA kernels under ``csrc/``; the
merge runs as one kernel that computes the whole merge decision.

This package imports torch, never jax, and nothing of ``omniparser_tpu``.
Every entry point takes ``device=`` and defaults to the card:

    from omniparser_tpu_torch import Omniparser, PipelineConfig
    parser = Omniparser(PipelineConfig())            # device="cuda"
    som_image_b64, elements = parser.parse(image_base64)

Several screenshots share one caption decode through
``parser.pipeline.parse_batch(images)``; ``python -m
omniparser_tpu_torch.serving --port 8000`` serves the REST contract with a
micro-batcher in front of ``parse_batch``.
"""

__version__ = "0.1.0"

from omniparser_tpu_torch.config import (
    CaptionerConfig,
    DetectorConfig,
    OcrConfig,
    PipelineConfig,
)

__all__ = ["PipelineConfig", "DetectorConfig", "CaptionerConfig", "OcrConfig", "Omniparser"]


def __getattr__(name):
    # lazy: `import omniparser_tpu_torch` stays cheap (no model imports)
    if name == "Omniparser":
        from omniparser_tpu_torch.pipeline import Omniparser

        return Omniparser
    raise AttributeError(f"module 'omniparser_tpu_torch' has no attribute {name!r}")
