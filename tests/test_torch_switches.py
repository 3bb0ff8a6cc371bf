"""Port: the JAX package's switches that change the computed function.

OWLVIT_STATIC_MAX is read at call time by the port's `resolve_static_max`,
as the JAX package's `_static_max_env` reads it (`off` or `dynamic` in any
case: the per-row max; a number: that C; unset: C = 20 for non-fp32
compute), and only where static_softmax is set. OWLVIT_FAST_SOFTMAX=1 and
OWLVIT_QUANT_BACKBONE=1 (or OwlViTConfig.quant_backbone) change the frozen
prefix's function in the JAX package; the port does not run them and raises
ValueError where the JAX package reads them (the vision prefix).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import owlvit_tpu.ops.flash_attention as jfa
from owlvit_tpu_torch.models import get_config, layers, owlvit
from owlvit_tpu_torch.ops import flash_attention as tfa
from owlvit_tpu_torch.ops import nms as nms_ops
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.serve import DetectorServer

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
N_CLASSES = 3


@pytest.mark.parametrize("static_softmax", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("env", [None, "off", "DYNAMIC", "5", "30"])
def test_static_max_matches_jax(env, dtype, static_softmax, monkeypatch):
    """resolve_static_max(dtype, static_softmax) equals the JAX package's
    `_static_max_env(dtype) if static_softmax else None`."""
    if env is None:
        monkeypatch.delenv("OWLVIT_STATIC_MAX", raising=False)
    else:
        monkeypatch.setenv("OWLVIT_STATIC_MAX", env)
    want = jfa._static_max_env(jnp.dtype(dtype)) if static_softmax else None
    assert tfa.resolve_static_max(TDT[dtype], static_softmax) == want


@pytest.fixture(scope="module")
def tiny_bf16():
    cfg = get_config("tiny", dtype="bfloat16")
    model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=3 * N_CLASSES)
    return model, cfg


@pytest.mark.parametrize("env, want_c", [("off", None), (None, tfa.STATIC_MAX_DEFAULT),
                                         ("5", 5.0)])
def test_served_batch_reads_static_max(env, want_c, tiny_bf16, monkeypatch):
    """A tiny bf16 served batch on the CPU: every attention call of the
    forward gets the C that OWLVIT_STATIC_MAX gives at call time, and under
    `off` the served detections equal the per-row-max forward's."""
    model, cfg = tiny_bf16
    if env is None:
        monkeypatch.delenv("OWLVIT_STATIC_MAX", raising=False)
    else:
        monkeypatch.setenv("OWLVIT_STATIC_MAX", env)
    seen = []
    real = layers.pk_fwd
    monkeypatch.setattr(layers, "pk_fwd", lambda *a, static_max=None, **kw:
                        seen.append(static_max) or real(*a, static_max=static_max, **kw))
    S = cfg.vision.image_size
    images = np.random.default_rng(1).integers(0, 255, (2, S, S, 3), dtype=np.uint8)
    flat = torch.from_numpy(images.reshape(2, -1))
    with DetectorServer(model, cfg, device="cpu", buckets=(2,), warmup=False,
                        autostart=False, top_k=16) as srv:
        got = srv.serve_batch(flat)
        thresholds = srv._thresholds
    assert seen and set(seen) == {want_c}
    if env == "off":
        with torch.inference_mode():
            boxes, sims = owlvit.forward_train(
                model, cfg.replace(trainable_last_k=0, static_softmax=False),
                normalize_image(torch.from_numpy(images)))
            want = nms_ops.pack_detections(
                nms_ops.postprocess(boxes, sims, **thresholds)).reshape(2, -1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("switch", ["OWLVIT_FAST_SOFTMAX", "OWLVIT_QUANT_BACKBONE",
                                    "quant_backbone"])
def test_unported_switches_raise(switch, monkeypatch):
    """Each of the three raises ValueError naming itself at the vision
    prefix, where the JAX package reads it, rather than run the bf16
    function under its name."""
    monkeypatch.delenv("OWLVIT_FAST_SOFTMAX", raising=False)
    monkeypatch.delenv("OWLVIT_QUANT_BACKBONE", raising=False)
    cfg = get_config("tiny", trainable_last_k=1)
    if switch == "quant_backbone":
        cfg = cfg.replace(quant_backbone=True)
    else:
        monkeypatch.setenv(switch, "1")
    model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=3 * N_CLASSES)
    S = cfg.vision.image_size
    pixels = torch.zeros((1, S, S, 3))
    with pytest.raises(ValueError, match=switch):
        owlvit.forward_train(model, cfg, pixels)
    with pytest.raises(ValueError, match=switch):
        owlvit.embed_prefix(model, cfg, pixels)
