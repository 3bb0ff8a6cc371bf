"""Analytic matmul-FLOPs accounting for MFU reporting (a copy of
owlvit_tpu/utils/flops.py: the same formulas, with the card's peak in
place of the TPU ones).

Counts the model's USEFUL dense-matmul FLOPs per image (2 FLOPs per MAC),
the standard MFU convention: elementwise work (layernorms, softmax, loss,
matcher) and any padding the kernels add are excluded, so the reported
MFU is conservative w.r.t. what the hardware actually executes.

Shapes follow the OWL-ViT architecture (HF modeling_owlvit.py:271-345
backbone, 1113-1129 box head, 1139 class projection; reference
models.py:98-119 forward):

  S  = num_patches + 1 (CLS)      tokens through the encoder
  D  = vision hidden size         M = vision MLP dim
  per encoder layer fwd: QKV 6SD² + QKᵀ 2S²D + PV 2S²D + proj 2SD² + MLP 4SDM
  heads (on P = num_patches tokens): box MLP ≈ 4PD², class dense0 2PD·proj,
  cosine matmul 2P·proj·Q

Backward ≈ 2× the forward FLOPs of everything that receives gradients
(dW and dX matmuls), the standard approximation.
"""

from __future__ import annotations


def _encoder_layer_fwd(S: int, D: int, M: int) -> float:
    return 8 * S * D * D + 4 * S * S * D + 4 * S * D * M


def _heads_fwd(P: int, D: int, proj: int, num_queries: int) -> float:
    box = 2 * P * D * D * 2 + 2 * P * D * 4
    cls = 2 * P * D * proj + 2 * P * proj * num_queries
    return box + cls


def _vision_fwd(cfg, num_queries: int) -> tuple[float, float, float]:
    """(frozen-prefix fwd, per-trainable-layer fwd, heads fwd) per image."""
    v = cfg.vision
    S = v.num_patches + 1
    patch_embed = 2 * v.num_patches * (v.patch_size * v.patch_size * 3) * v.hidden_size
    layer = _encoder_layer_fwd(S, v.hidden_size, v.mlp_dim)
    heads = _heads_fwd(v.num_patches, v.hidden_size, cfg.projection_dim, num_queries)
    return patch_embed, layer, heads


def train_flops_per_image(cfg, num_queries: int = 240, cached: bool = False) -> float:
    """Matmul FLOPs of one train-step image.

    cached=False: full forward (patch embed + all L layers + heads) plus
    backward through the trainable tail — the reference's autograd scope
    (requires_grad=False frozen prefix, models.py:173-184).
    cached=True: the steady-state activation-cache step — only the trainable
    tail runs, forward and backward (the frozen prefix is a pool gather).
    """
    patch_embed, layer, heads = _vision_fwd(cfg, num_queries)
    L = cfg.vision.num_layers
    k = cfg.trainable_last_k if cfg.trainable_last_k else L
    tail = k * layer + heads
    if cached:
        return 3 * tail  # fwd + ~2x bwd
    return patch_embed + L * layer + heads + 2 * tail


def serve_flops_per_image(cfg, num_queries: int = 240) -> float:
    """Matmul FLOPs of one inference image (full forward, no backward)."""
    patch_embed, layer, heads = _vision_fwd(cfg, num_queries)
    return patch_embed + cfg.vision.num_layers * layer + heads


_PEAKS_BF16 = [
    # (torch.cuda.get_device_name substring, dense bf16 peak FLOP/s per card).
    # The H100 SXM5 reports "NVIDIA H100 80GB HBM3"; the PCIe card ("NVIDIA
    # H100 PCIe") and the NVL have lower peaks and no entry here.
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
]


def chip_peak_flops(device_kind: str) -> float | None:
    """bf16 peak FLOP/s for a device name string; None if unknown."""
    kind = device_kind.lower()
    for sub, peak in _PEAKS_BF16:
        if sub in kind:
            return peak
    return None


def mfu(imgs_per_sec: float, flops_per_image: float, peak: float | None) -> float | None:
    if not peak or not imgs_per_sec:
        return None
    return imgs_per_sec * flops_per_image / peak
