"""owlvit_tpu_torch — the PyTorch/CUDA port of owlvit_tpu for NVIDIA Hopper.

Keeps the JAX package's module names (models/, ops/, train/, utils/,
serve.py), imports torch and never jax. The attention kernels (forward and
backward) are CUDA C++ under csrc/, built with nvcc at first use.
"""

__version__ = "0.1.0"
