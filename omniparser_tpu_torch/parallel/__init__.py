"""Device mesh, shardings, and batched multi-screenshot parse.

Data parallelism over screenshots, crops and training examples ('dp'), and
tensor parallelism over the captioner's large parameters ('tp'), driven by
one process over a grid of torch devices (``parallel/mesh.py``).
"""

from omniparser_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    shard_params_fsdp_tp,
)

__all__ = ["make_mesh", "batch_sharding", "replicated", "shard_params_fsdp_tp"]
