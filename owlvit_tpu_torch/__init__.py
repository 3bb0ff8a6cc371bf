"""owlvit_tpu_torch — the PyTorch/CUDA port of owlvit_tpu for NVIDIA Hopper.

Keeps the JAX package's module names (models/, ops/, serve.py), imports
torch and never jax. The attention kernel is CUDA C++ under csrc/, built with
nvcc at first use.
"""

__version__ = "0.1.0"
