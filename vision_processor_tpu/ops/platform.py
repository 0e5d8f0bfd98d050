"""Which device formulation a stage runs: kernels on the GPU, XLA on CPU."""
from __future__ import annotations

import jax


def use_gpu_kernels() -> bool:
    """True on the GPU, where the Pallas (Triton route) kernels run; False
    on the CPU, where the plain XLA formulations run. Any other platform
    raises: no kernel here was written or checked for it."""
    platform = jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(f"no kernel selection for platform {platform!r}")
