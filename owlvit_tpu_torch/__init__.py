"""owlvit_tpu_torch — the PyTorch/CUDA port of owlvit_tpu for NVIDIA Hopper.

Keeps the JAX package's module names (models/, ops/, train/, utils/,
serve.py), imports torch and never jax. The kernels (attention forward and
backward, fused add+LayerNorm) are CUDA C++ under csrc/, built with nvcc at
first use (ops/_cuda.py).
"""

__version__ = "0.1.0"
