"""NeuroSync Trainer Lite in PyTorch for an NVIDIA H100 (sm_90a).

A port of the JAX package neurosync_trainer_lite_tpu, which stays the
reference. Module names mirror the JAX package's, and so do the package
exports, so a user moving over changes the package name in an import. The
Pallas kernels are hand-written CUDA kernels here (csrc/, built at first
use); each has a plain PyTorch version that CPU tensors take. Entry points
run on the CUDA card unless the caller passes device="cpu".
"""

from neurosync_trainer_lite_tpu_torch.config import Config, full_config, tiny_config

__version__ = "0.1.0"

__all__ = ["Config", "tiny_config", "full_config", "__version__"]
