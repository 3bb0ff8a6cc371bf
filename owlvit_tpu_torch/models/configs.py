"""Model configurations for the OWL-ViT family.

A copy of owlvit_tpu/models/configs.py, kept here because importing that
module pulls in jax (through owlvit_tpu/models/__init__.py).
tests/test_torch_convert.py holds the two registries equal field by field.

Dimension sources: HF transformers configuration_owlvit.py defaults (B/32)
and the published OWL-ViT B/16 and L/14 variants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 768
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    max_len: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class OwlViTConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    projection_dim: int = 512

    # Runtime policy (not part of the checkpoint):
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"
    # "auto" and "flash": the packed attention wrapper (the CUDA kernel for
    # CUDA tensors, its plain version for CPU tensors); "xla": the plain
    # version on any device.
    attention_impl: str = "auto"
    remat: bool = False  # recompute the trained encoder blocks in the backward
    # int8 frozen prefix (or OWLVIT_QUANT_BACKBONE=1): every projection of
    # the frozen layers through ops/quant.py::linear_q (vit.forward_prefix)
    quant_backbone: bool = False
    # Only the last k vision layers may take gradients; None = no split.
    trainable_last_k: "int | None" = None
    # Fixed-shift softmax (C = 20) in the non-fp32 attention kernel, for
    # forward-only callers (serving).
    static_softmax: bool = False
    # The reference's query normalization is `q / ||q|| + 1e-6` (epsilon
    # added to the normalized vector); True uses `q / (||q|| + 1e-6)`.
    fix_query_norm: bool = False

    def replace(self, **kw) -> "OwlViTConfig":
        return dataclasses.replace(self, **kw)


_B32 = OwlViTConfig()

_B16 = OwlViTConfig(
    vision=VisionConfig(patch_size=16),  # 48x48 = 2304 patches
)

_L14 = OwlViTConfig(
    vision=VisionConfig(
        image_size=840,
        patch_size=14,  # 60x60 = 3600 patches
        hidden_size=1024,
        num_layers=24,
        num_heads=16,
        mlp_dim=4096,
    ),
    text=TextConfig(hidden_size=768, num_heads=12, mlp_dim=3072),
    projection_dim=768,
)

_TINY = OwlViTConfig(  # for tests: fast on 1 CPU core
    vision=VisionConfig(
        image_size=96, patch_size=32, hidden_size=64, num_layers=2,
        num_heads=4, mlp_dim=128,
    ),
    text=TextConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
        mlp_dim=64, max_len=16,
    ),
    projection_dim=32,
)

_REGISTRY = {"b32": _B32, "b16": _B16, "l14": _L14, "tiny": _TINY}


def get_config(name: str, **overrides) -> OwlViTConfig:
    cfg = _REGISTRY[name.lower().replace("/", "").replace("-", "")]
    return cfg.replace(**overrides) if overrides else cfg
