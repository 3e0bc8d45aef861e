"""Serving: the reference's REST contract on the Python stdlib, over the
port's pipeline, with a micro-batcher that hands concurrent requests to one
``SOMPipeline.parse_batch`` call."""

from omniparser_tpu_torch.serving.batcher import MicroBatcher
from omniparser_tpu_torch.serving.http import OmniparserServer, main

__all__ = ["OmniparserServer", "MicroBatcher", "main"]
