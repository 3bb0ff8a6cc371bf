"""Port: the pieces of the cached train step against the JAX package's.

- ops/quant.py's row quantization against owlvit_tpu/ops/quant.py (equal
  int8 codes and scales, equal dequantized values);
- data/act_cache.py, the port's copy of owlvit_tpu/data/act_cache.py: the
  same fingerprints, and one on-disk layout (each package reads what the
  other wrote), round trips, and a stale fingerprint hiding the rows;
- `embed_prefix` then `forward_train_from_prefix` bit-equal to
  `forward_train`, as tests/test_act_cache.py holds for the JAX package.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from owlvit_tpu.data import act_cache as jcache
from owlvit_tpu.ops import quant as jquant
from owlvit_tpu_torch.data import act_cache as tcache
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.ops import quant


def _rows(seed=0, shape=(4, 6, 32)):
    """Rows with dynamic ranges 1e-2 .. 1e1, a zero row, and values on
    half-step boundaries (where round-half-to-even matters)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * (10.0 ** np.arange(-2, 2))[:, None, None]
    x = x.astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, :4] = [127.0, 0.5, 1.5, -2.5]  # scale 1: ties at .5
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax(dtype):
    x = _rows()
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jq, js = jquant.quantize_rows(jx)
    tq, ts = quant.quantize_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == x.shape and ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[1, 1, :4].tolist() == [127, 0, 2, -2]  # half to even
    for out in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jnp.asarray(jquant.dequantize_rows(jq, js, out), jnp.float32))
        tout = torch.float32 if out == jnp.float32 else torch.bfloat16
        got = quant.dequantize_rows(tq, ts, tout)
        assert got.dtype == tout
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantize_rows_error_bound():
    """Worst-case error half a step, rowmax / 254; zero rows stay zero."""
    x = torch.from_numpy(_rows(1))
    q, s = quant.quantize_rows(x)
    err = (quant.dequantize_rows(q, s, torch.float32) - x).abs()
    assert (err <= s[..., None] * 0.5 * (1 + 1e-5)).all()
    assert (quant.dequantize_rows(q, s, torch.float32)[0, 0] == 0).all()


def test_fingerprint_equals_original():
    for parts in ({"m": "b16", "k": 1, "ds": ["x", "y"]}, {"params": "random:0", "seed": 3},
                  {"dataset": [("a.jpg", 10, 3)], "fused_ln": True, "static_max": ""}):
        assert tcache.fingerprint(parts) == jcache.fingerprint(parts)
    assert tcache.fingerprint({"a": 1, "b": 2}) == tcache.fingerprint({"b": 2, "a": 1})
    assert tcache.fingerprint({"a": 1}) != tcache.fingerprint({"a": 2})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_is_shared_with_the_original(tmp_path, dtype, writer):
    """Rows written by one package's cache are read, bit for bit, by the
    other's, through numpy (write/read) and torch (write_tensor/read_tensor)."""
    acts = np.arange(3 * 5 * 8, dtype=np.float32).reshape(3, 5, 8) / 7 - 2
    if dtype == "bfloat16":
        np_acts = acts.astype(ml_dtypes.bfloat16)
        t_acts = torch.from_numpy(acts).to(torch.bfloat16)
    else:
        np_acts, t_acts = acts, torch.from_numpy(acts)
    base = str(tmp_path / "c")
    if writer == "jax":
        jcache.ActivationCache(base, 6, "fp").write([4, 1, 0], np_acts)
    else:
        tcache.ActivationCache(base, 6, "fp").write_tensor([4, 1, 0], t_acts)
    j, t = jcache.ActivationCache(base, 6, "fp"), tcache.ActivationCache(base, 6, "fp")
    assert j.has([0, 1, 4]) and t.has([0, 1, 4]) and not t.has([2]) and not t.complete
    got = t.read_tensor([1, 4])
    assert got.dtype == t_acts.dtype and got.shape == (2, 5, 8)
    assert torch.equal(got, t_acts[[1, 0]])
    np.testing.assert_array_equal(np.asarray(j.read([1, 4]), np.float32),
                                  np.asarray(np_acts[[1, 0]], np.float32))
    np.testing.assert_array_equal(np.asarray(t.read([0]), np.float32),
                                  np.asarray(np_acts[[2]], np.float32))
    with pytest.raises(KeyError):
        t.read_tensor([2])


def test_stale_fingerprint_hides_rows_and_rebuilds(tmp_path):
    base = str(tmp_path / "c")
    cache = tcache.ActivationCache(base, n_items=3, fp="fpA")
    cache.write_tensor([0, 1, 2], torch.ones((3, 2, 2)))
    cache.flush()
    assert tcache.ActivationCache(base, n_items=3, fp="fpA").complete
    assert jcache.ActivationCache(base, n_items=3, fp="fpA").complete
    stale = tcache.ActivationCache(base, n_items=3, fp="fpB")
    assert not stale.has([0])
    stale.write_tensor([1], torch.zeros((1, 2, 2)))
    assert stale.has([1]) and not stale.has([0])
    assert not jcache.ActivationCache(base, n_items=3, fp="fpA").has([1])
    with pytest.raises(ValueError, match="changed mid-run"):
        stale.write_tensor([2], torch.zeros((1, 2, 3)))


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("k", [0, 1])
def test_prefix_tail_matches_fused_forward(k, fused, monkeypatch):
    """embed_prefix then forward_train_from_prefix is bit-equal to
    forward_train, with and without the fused add+LayerNorm branch."""
    monkeypatch.setenv("OWLVIT_FUSED_LN", fused)
    cfg = get_config("tiny").replace(trainable_last_k=k)
    model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=6)
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(2, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32))
    boxes_a, sims_a = owlvit.forward_train(model, cfg, img)
    acts = owlvit.embed_prefix(model, cfg, img)
    assert acts.shape == (2, cfg.vision.num_patches + 1, cfg.vision.hidden_size)
    assert not acts.requires_grad
    boxes_b, sims_b = owlvit.forward_train_from_prefix(model, cfg, acts)
    assert torch.equal(boxes_a, boxes_b) and torch.equal(sims_a, sims_b)


def test_embed_prefix_rejects_full_finetune():
    cfg = get_config("tiny").replace(trainable_last_k=None)
    model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=6)
    with pytest.raises(ValueError, match="trainable_last_k"):
        owlvit.embed_prefix(model, cfg, torch.zeros((1, 96, 96, 3)))
