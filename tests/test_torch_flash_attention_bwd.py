"""Port: the plain attention backward against `jax.vjp` of the JAX package's
`flash_attention_packed` (the Pallas backward in interpret mode, in its
modes "fused" and "both"), the autograd Function on CPU against PyTorch's
autograd through the plain forward, and the wrapper's routing.

Tolerances. fp32: atol 2e-5 on gradients of magnitude about 1 (summation
order, and p taken as exp(s - lse) here but recomputed from the row max and
sum in the TPU kernel). bf16: max-rel 2e-2, as the forward (both sides round
ds and p to bf16 at the same points, but the port's o and lse come from its
own forward, so delta differs in the last bf16 bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import owlvit_tpu.ops.flash_attention as jfa
from owlvit_tpu_torch.models import layers
from owlvit_tpu_torch.ops import flash_attention as tfa

B, S, H, HD, VALID = 2, 256, 2, 64, 200  # S a BLOCK_Q multiple; keys >= VALID masked
SCALE = HD**-0.5
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H * HD)).astype(np.float32) for _ in range(n)]


def _jax_grads(q, k, v, do, dtype):
    def f(q, k, v):
        return jfa.flash_attention_packed(q, k, v, scale=SCALE, num_heads=H,
                                          valid_len=VALID)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, JDT[dtype]))]


def _port_grads(q, k, v, do, dtype):
    q, k, v, do = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v, do))
    args = dict(scale=SCALE, num_heads=H, valid_len=VALID)
    o, lse = tfa.pk_fwd_plain(q, k, v, **args)
    grads = tfa.pk_bwd(q, k, v, o, lse, do, **args)
    assert all(g.dtype == TDT[dtype] and g.shape == q.shape for g in grads)
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("mode", ["fused", "both"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_bwd(dtype, mode, monkeypatch):
    """Both JAX modes compute one function: the port's one backward covers
    the fused kernel and the split dq/dkv pair."""
    monkeypatch.setenv("OWLVIT_PACKED_BWD", mode)
    q, k, v, do = _inputs(0)
    ref = _jax_grads(q, k, v, do, dtype)
    got = _port_grads(q, k, v, do, dtype)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        # "both" leaves dq of query rows >= valid_len unmasked; the port
        # zeroes them, as the fused kernel does
        rows = slice(0, VALID) if name == "dq" else slice(None)
        g, r = g[:, rows], r[:, rows]
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=2e-5, rtol=0, err_msg=name)
        else:
            assert np.abs(g - r).max() / np.abs(r).max() <= 2e-2, name
    dq, dk, dv = got
    assert not dq[:, VALID:].any()  # padded query rows contribute nothing
    assert not dk[:, VALID:].any() and not dv[:, VALID:].any()  # masked keys


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_plain_autograd(dtype):
    """flash_attention_packed's backward (pk_bwd on CPU) against PyTorch's
    autograd through pk_fwd_plain. fp32 atol 1e-5; bf16 max-rel 2e-2 (the
    two backward graphs round at different points)."""
    q, k, v, do = (torch.from_numpy(x).to(TDT[dtype]) for x in _inputs(1))
    grads = []
    for fn in ("function", "autograd"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if fn == "function":
            o = tfa.flash_attention_packed(*leaves, scale=SCALE, num_heads=H)
        else:
            o, _ = tfa.pk_fwd_plain(*leaves, scale=SCALE, num_heads=H)
        assert o.dtype == TDT[dtype]
        o.backward(do)
        grads.append([x.grad.float() for x in leaves])
    for g, r in zip(*grads):
        if dtype == "float32":
            torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
        else:
            assert (g - r).abs().max() / r.abs().max() <= 2e-2


def test_attention_layer_routes_by_recording(monkeypatch):
    """A recorded call takes the autograd Function; static_max on a recorded
    call raises; the same call without a gradient runs the fixed shift."""
    calls = []
    monkeypatch.setattr(layers, "flash_attention_packed",
                        lambda *a, **kw: calls.append(1) or tfa.flash_attention_packed(*a, **kw))
    attn = layers.Attention(H * HD, H, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 10, H * HD)).astype(np.float32))
    y = attn(x)
    assert y.requires_grad and calls == [1]
    with torch.no_grad():
        attn(x)
    assert calls == [1]
    with pytest.raises(ValueError, match="forward-only"):
        attn(x, static_max=20.0)
    with pytest.raises(ValueError, match="forward-only"):
        attn(x, impl="xla", static_max=20.0)
    with torch.no_grad():
        assert attn(x, static_max=20.0).shape == x.shape


def test_cpu_runs_plain_and_counts_no_launch():
    before = tfa.pk_bwd.launches
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2))
    args = dict(scale=SCALE, num_heads=H, valid_len=VALID)
    o, lse = tfa.pk_fwd(q, k, v, **args)
    got = tfa.pk_bwd(q, k, v, o, lse, do, **args)
    want = tfa.pk_bwd_plain(q, k, v, o, lse, do, **args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tfa.pk_bwd.launches == before == 0


def test_other_devices_raise():
    x = torch.empty((1, 8, 64), device="meta")
    lse = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.pk_bwd(x, x, x, x, lse, x, scale=SCALE, num_heads=1)
