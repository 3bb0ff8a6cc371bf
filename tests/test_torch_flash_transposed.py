"""Port: the transposed attention functions against the JAX package's.

`flash_attention` ([B, S, H, hd], the JAX `_flash3` with `_fwd_kernel`,
`_dq_kernel` and `_dkv_kernel`) and `flash_attention_hybrid` (packed
forward, transposed backward) run the packed wrappers at num_heads=1; on the
CPU those are the plain versions. The JAX side runs its Pallas kernels in
interpret mode. Also the routing predicates and the attention layer's
choice among packed, hybrid and transposed.

Tolerances, as tests/test_torch_flash_attention_bwd.py: fp32 atol 2e-5 on
outputs and gradients of magnitude about 1 (summation order; the TPU
kernels scale the fp32 scores, the port the q and k tiles, which is exact
for these power-of-two scales); bf16 max-rel 2e-2 (p and ds rounded to bf16
at the same points, in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import owlvit_tpu.ops.flash_attention as jfa
from owlvit_tpu_torch.models import layers
from owlvit_tpu_torch.ops import flash_attention as tfa

B, S, H, HD = 2, 200, 2, 64  # S not a BLOCK_Q multiple: the JAX side pads and masks
SCALE = HD**-0.5
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


@pytest.fixture(autouse=True)
def _interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _jax(fn, q, k, v, do, dtype):
    o, vjp = jax.vjp(fn, *(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, JDT[dtype]))
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (o, *grads)]


def _port(fn, q, k, v, do, dtype):
    leaves = [torch.from_numpy(x).to(TDT[dtype]).requires_grad_(True) for x in (q, k, v)]
    o = fn(*leaves)
    assert o.dtype == TDT[dtype] and o.shape == leaves[0].shape
    o.backward(torch.from_numpy(do).to(TDT[dtype]))
    return [a.detach().float().numpy() for a in (o, *(x.grad for x in leaves))]


def _check(got, ref, dtype):
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=2e-5, rtol=0, err_msg=name)
        else:
            assert np.abs(g - r).max() / np.abs(r).max() <= 2e-2, name


@DTYPES
def test_flash_attention_matches_pallas(dtype):
    q, k, v, do = _inputs(0, (B, S, H, HD))
    ref = _jax(lambda q, k, v: jfa.flash_attention(q, k, v, scale=SCALE), q, k, v, do, dtype)
    got = _port(lambda q, k, v: tfa.flash_attention(q, k, v, scale=SCALE), q, k, v, do, dtype)
    _check(got, ref, dtype)


@DTYPES
def test_flash_attention_hybrid_matches_pallas(dtype):
    q, k, v, do = _inputs(1, (B, S, H * HD))
    ref = _jax(lambda q, k, v: jfa.flash_attention_hybrid(q, k, v, scale=SCALE, num_heads=H),
               q, k, v, do, dtype)
    got = _port(lambda q, k, v: tfa.flash_attention_hybrid(q, k, v, scale=SCALE, num_heads=H),
                q, k, v, do, dtype)
    _check(got, ref, dtype)


def test_transposed_equals_packed_on_the_same_heads():
    """The transposed layout is the packed one with one head: fp32 outputs
    and grads of the three Functions agree to summation order (atol 1e-5)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, (B, S, H * HD)))
    outs = []
    for fn in (lambda q, k, v: tfa.flash_attention_packed(q, k, v, scale=SCALE, num_heads=H),
               lambda q, k, v: tfa.flash_attention_hybrid(q, k, v, scale=SCALE, num_heads=H),
               lambda q, k, v: tfa.flash_attention(
                   *(x.view(B, S, H, HD) for x in (q, k, v)), scale=SCALE).reshape(B, S, H * HD)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        outs.append([o.detach(), *(x.grad for x in leaves)])
    for other in outs[1:]:
        for a, b in zip(other, outs[0]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _counts():
    return tuple(getattr(w, a) for w in (tfa.pk_fwd, tfa.pk_bwd, tfa.pk_dq, tfa.pk_dkv)
                 for a in ("launches", "transposed_launches"))


def test_cpu_runs_plain_and_counts_no_launch():
    """On CPU tensors `flash_attention` is the plain versions at one head on
    the [B*H, S, hd] layout, bit for bit, and counts no launch."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, (B, S, H, HD)))
    before = _counts()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, scale=SCALE)
    o.backward(do)
    q3, k3, v3, do3 = (tfa._to3(x) for x in (q, k, v, do))
    o_p, lse_p = tfa.pk_fwd_plain(q3, k3, v3, scale=SCALE, num_heads=1)
    assert torch.equal(o.detach(), tfa._from3(o_p, B, H)) and lse_p.shape == (B * H, 1, S)
    want = tfa.pk_bwd_plain(q3, k3, v3, o_p, lse_p, do3, scale=SCALE, num_heads=1)
    assert all(torch.equal(x.grad, tfa._from3(w, B, H)) for x, w in zip(leaves, want))
    assert before == (0,) * 8 == _counts()


@pytest.mark.parametrize("packed_env", [None, "1", "0"])
def test_routing_predicates_match_jax(packed_env, monkeypatch):
    if packed_env is None:
        monkeypatch.delenv("OWLVIT_PACKED_FLASH", raising=False)
    else:
        monkeypatch.setenv("OWLVIT_PACKED_FLASH", packed_env)
    for heads, hd in ((1, 64), (2, 64), (3, 64), (12, 64), (16, 64), (4, 16), (3, 32), (5, 128)):
        D = heads * hd
        assert tfa.packed_supported(heads, hd, D) == jfa.packed_supported(heads, hd, D)
        assert tfa.hybrid_supported(heads, hd, D) == jfa.hybrid_supported(heads, hd, D)


@pytest.mark.parametrize("heads,packed_env,want", [
    (2, "1", "packed"), (2, "0", "hybrid"), (3, "1", "transposed"), (3, "0", "transposed")])
def test_attention_layer_routes_recorded_calls(heads, packed_env, want, monkeypatch):
    """A recorded call takes packed, else hybrid, else transposed, as the
    JAX package's `attention` routes them; a call that is not recorded
    keeps `pk_fwd`. The three routes give the same output (fp32 atol 1e-5)."""
    monkeypatch.setenv("OWLVIT_PACKED_FLASH", packed_env)
    calls = []
    for name in ("flash_attention_packed", "flash_attention_hybrid", "flash_attention"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    attn = layers.Attention(heads * HD, heads, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 9, heads * HD)).astype(np.float32))
    y = attn(x)
    assert y.requires_grad
    assert calls == [{"packed": "flash_attention_packed", "hybrid": "flash_attention_hybrid",
                      "transposed": "flash_attention"}[want]]
    y.sum().backward()
    with torch.no_grad():
        torch.testing.assert_close(attn(x), y.detach(), atol=1e-5, rtol=0)
    assert len(calls) == 1
