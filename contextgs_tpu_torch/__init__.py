"""ContextGS-TPU, PyTorch and CUDA port for NVIDIA Hopper (H100).

A second package beside `contextgs_tpu` (the JAX reference, left unchanged).
It keeps the reference's module paths and public names so that every
counterpart is easy to find, imports nothing of JAX or of `contextgs_tpu`,
and runs on `cuda` unless the caller passes `device="cpu"`. On the card each
Pallas kernel of the reference becomes a hand-written CUDA kernel; CPU tensors
take the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from contextgs_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    TrainConfig,
)
from contextgs_tpu_torch.device import resolve_device  # noqa: F401
