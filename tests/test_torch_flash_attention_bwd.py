"""Port: the plain attention backward against `jax.vjp` of the JAX package's
`flash_attention_packed` (the Pallas backward in interpret mode, in its
modes "fused" and "both", against the port's `pk_bwd` and `pk_bwd_split`),
the keys past valid_len that the dq kernel's copies no longer zero (large
values there leave dq as zeros do), the autograd Function on CPU against
PyTorch's autograd through the plain forward, and the routing: the backward
mode (`pk_bwd_mode` against `_pk_bwd_mode` where OWLVIT_PACKED_BWD is set,
the split pair where it is not), the pair on every layer of a recorded
stack, the transposed and hybrid backward's split pair, and the wrappers'
launch counters.

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


def _port_grads(q, k, v, do, dtype, mode="fused"):
    q, k, v, do = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v, do))
    args = dict(scale=SCALE, num_heads=H, valid_len=VALID)
    o, lse = tfa.pk_fwd_plain(q, k, v, **args)
    bwd = tfa.pk_bwd if mode == "fused" else tfa.pk_bwd_split
    grads = bwd(q, k, v, o, lse, do, **args)
    assert all(g.dtype == TDT[dtype] and g.shape == q.shape for g in grads)
    return [g.float().numpy() for g in grads]


@pytest.mark.parametrize("mode", ["fused", "both"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_bwd(dtype, mode, monkeypatch):
    """Each JAX mode against the port's backward of the same mode: the fused
    kernel's plain version (`pk_bwd`) and the split pair's (`pk_dq` then
    `pk_dkv`)."""
    monkeypatch.setenv("OWLVIT_PACKED_BWD", mode)
    q, k, v, do = _inputs(0)
    ref = _jax_grads(q, k, v, do, dtype)
    got = _port_grads(q, k, v, do, dtype, mode)
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


@pytest.mark.parametrize("dtype, fill", [("float32", 3e4), ("bfloat16", -1e4)])
def test_pair_dq_ignores_the_keys_past_valid_len(dtype, fill, monkeypatch):
    """The masking contract the dq kernel's copies rely on: keys in
    [valid_len, S) holding large finite values (the caller's data, not
    zeros) leave `pk_dq`'s dq bit-equal to the zero-padded input's, and both
    hold against the Pallas `_pk_dq_kernel` (mode "both", interpret mode) at
    that valid_len on the real query rows."""
    monkeypatch.setenv("OWLVIT_PACKED_BWD", "both")
    q, k, v, do = _inputs(5)
    sign = np.sign(np.random.default_rng(6).normal(size=k[:, VALID:].shape))
    k_big, v_big = k.copy(), v.copy()
    k_big[:, VALID:], v_big[:, VALID:] = fill * sign, -fill * sign
    k_zero, v_zero = k.copy(), v.copy()
    k_zero[:, VALID:] = v_zero[:, VALID:] = 0.0
    args = dict(scale=SCALE, num_heads=H, valid_len=VALID)
    dqs = []
    for kk, vv in ((k_big, v_big), (k_zero, v_zero)):
        qt, kt, vt, dot = (torch.from_numpy(x).to(TDT[dtype]) for x in (q, kk, vv, do))
        o, lse = tfa.pk_fwd(qt, kt, vt, **args)
        dqs.append(tfa.pk_dq(qt, kt, vt, o, lse, dot, **args)[0])
    assert torch.equal(dqs[0], dqs[1])
    assert not dqs[0][:, VALID:].any()
    for kk, vv in ((k_big, v_big), (k_zero, v_zero)):
        ref = _jax_grads(q, kk, vv, do, dtype)[0][:, :VALID]
        got = dqs[0].float().numpy()[:, :VALID]
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
        else:
            assert np.abs(got - ref).max() / np.abs(ref).max() <= 2e-2


@pytest.mark.parametrize("scale, exact", [
    (HD**-0.5, True), (0.5, True), (1.0, True), (2.0**-20, True),
    (0.1, False), (48**-0.5, False), (2.0, False), (0.0, False), (-0.125, False),
])
def test_scale_exact_in_bf16(scale, exact):
    """The dq kernel reads k, and the dkv kernel q, and they scale in fp32
    only where bf16(x * scale) is x * scale (a power of two in (0, 1]);
    elsewhere the wrapper hands the kernel the x * scale scratch. The
    premise, on every finite bf16 value of magnitude 2^-100 .. 2^100: the
    rounding leaves such products alone."""
    assert tfa.scale_is_exact_in_bf16(scale) is exact
    k = torch.zeros((1, 8, HD), dtype=torch.bfloat16)
    assert (tfa._scaled_scratch(k, scale) is None) is exact
    if exact:
        bits = torch.arange(0, 2**16, dtype=torch.int32).to(torch.int16)
        x = bits.view(torch.bfloat16).float()
        x = x[torch.isfinite(x) & (x.abs() >= 2.0**-100) & (x.abs() <= 2.0**100)]
        assert torch.equal((x * scale).to(torch.bfloat16).float(), x * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_plain_autograd(dtype):
    """flash_attention_packed's backward (the pair on CPU) against PyTorch's
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


def _counts():
    return {f"{w.__name__}.{a}": getattr(w, a) for w in (tfa.pk_bwd, tfa.pk_dq, tfa.pk_dkv)
            for a in ("launches", "transposed_launches")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid_len", [VALID, None])
def test_split_pair_is_the_fused_function(dtype, valid_len):
    """On CPU tensors the pair (`pk_dq`, then `pk_dkv` on its delta) gives
    `pk_bwd`'s dq, dk and dv bit for bit, delta is rowsum(do * o) in fp32
    [B, H, S], and no counter moves."""
    before = _counts()
    q, k, v, do = (torch.from_numpy(x).to(TDT[dtype]) for x in _inputs(4))
    args = dict(scale=SCALE, num_heads=H, valid_len=valid_len)
    o, lse = tfa.pk_fwd(q, k, v, **args)
    dq, delta = tfa.pk_dq(q, k, v, o, lse, do, **args)
    dk, dv = tfa.pk_dkv(q, k, v, lse, do, delta, **args)
    want = tfa.pk_bwd(q, k, v, o, lse, do, **args)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    assert all(torch.equal(a, b) for a, b in zip(tfa.pk_bwd_split(q, k, v, o, lse, do, **args),
                                                 want))
    ref = (do.float() * o.float()).reshape(B, S, H, HD).sum(-1).transpose(1, 2)
    assert delta.dtype == torch.float32 and delta.is_contiguous()
    torch.testing.assert_close(delta, ref, atol=0, rtol=0)
    assert _counts() == before == dict.fromkeys(before, 0)


@pytest.mark.parametrize("env", [None, "fused", "both"])
@pytest.mark.parametrize("hint", [None, "fused", "both"])
def test_bwd_mode_matches_jax(env, hint, monkeypatch):
    """OWLVIT_PACKED_BWD wins when set, as `_pk_bwd_mode` resolves it
    whatever its caller's hint (`hint`); unset, the port gives "both", the
    split pair whose gradients are the same on every run, where the JAX
    package falls to the hint (its grid runs in order, so either of its
    kernels is reproducible)."""
    if env is None:
        monkeypatch.delenv("OWLVIT_PACKED_BWD", raising=False)
        assert tfa.pk_bwd_mode() == "both"
    else:
        monkeypatch.setenv("OWLVIT_PACKED_BWD", env)
        assert tfa.pk_bwd_mode() == jfa._pk_bwd_mode(hint) == env


@pytest.mark.parametrize("env, hint", [("dq", None), ("dkv", "both"), ("other", None)])
def test_bwd_mode_refuses_the_diagnostic_halves(env, hint, monkeypatch):
    """JAX's diagnostic modes "dq" and "dkv" (and any other value) raise,
    whatever the JAX caller's hint would have been: the port runs "fused"
    and "both" only."""
    monkeypatch.setenv("OWLVIT_PACKED_BWD", env)
    assert jfa._pk_bwd_mode(hint) == env
    with pytest.raises(ValueError, match="packed backward mode"):
        tfa.pk_bwd_mode()


def _record_kernels(monkeypatch):
    """Count the backward wrappers' calls as (name, num_heads), in order."""
    calls = []
    for name in ("pk_bwd", "pk_dq", "pk_dkv"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append((_n, kw["num_heads"])) or _f(*a, **kw))
    return calls


@pytest.mark.parametrize("fused_ln", [False, True])
@pytest.mark.parametrize("n_layers", [1, 2, 3, 12])
def test_encoder_hint_matches_jax(n_layers, fused_ln, monkeypatch):
    """Without OWLVIT_PACKED_BWD, a recorded stack of any depth, on either
    branch (OWLVIT_FUSED_LN), runs each layer's attention backward as the
    split pair: pk_dq and pk_dkv once per layer, pk_bwd never. The JAX
    package's encoder hinted "fused" for stacks of 2 layers or fewer; the
    port takes no hint."""
    monkeypatch.delenv("OWLVIT_PACKED_BWD", raising=False)
    monkeypatch.setenv("OWLVIT_FUSED_LN", "1" if fused_ln else "0")
    calls = _record_kernels(monkeypatch)
    D = H * HD
    blocks = torch.nn.ModuleList(layers.EncoderBlock(D, 2 * D, H, 1e-5,
                                                     generator=torch.Generator().manual_seed(i))
                                 for i in range(n_layers))
    x = torch.zeros(1, 4, D, requires_grad=True)
    layers.encoder(blocks, x).sum().backward()
    assert calls == [("pk_dq", H), ("pk_dkv", H)] * n_layers


@pytest.mark.parametrize("env", [None, "fused", "both"])
@pytest.mark.parametrize("fn", ["packed", "hybrid", "transposed"])
def test_backward_takes_the_mode(fn, env, monkeypatch):
    """The packed Function's backward runs the pair, or `pk_bwd` under
    OWLVIT_PACKED_BWD=fused, as `pk_bwd_mode()` resolves at backward time;
    the transposed and hybrid backward always run the pair at one head, as
    the JAX package's `_bwd` always runs `_dq_kernel` and `_dkv_kernel`."""
    if env is None:
        monkeypatch.delenv("OWLVIT_PACKED_BWD", raising=False)
    else:
        monkeypatch.setenv("OWLVIT_PACKED_BWD", env)
    calls = _record_kernels(monkeypatch)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    if fn == "packed":
        o = tfa.flash_attention_packed(*leaves, scale=SCALE, num_heads=H)
    elif fn == "hybrid":
        o = tfa.flash_attention_hybrid(*leaves, scale=SCALE, num_heads=H)
    else:
        o = tfa.flash_attention(*(x.view(B, S, H, HD) for x in leaves),
                                scale=SCALE).reshape(B, S, H * HD)
    o.backward(do)
    if fn == "packed" and env == "fused":
        assert calls == [("pk_bwd", H)]
    else:
        heads = H if fn == "packed" else 1
        assert calls == [("pk_dq", heads), ("pk_dkv", heads)]


def test_pair_counters_do_not_advance_on_cpu(monkeypatch):
    """A recorded stack of 3 layers takes the pair; on CPU tensors the
    wrappers run the plain versions and count nothing."""
    monkeypatch.delenv("OWLVIT_PACKED_BWD", raising=False)
    before = _counts()
    D = H * HD
    blocks = torch.nn.ModuleList(layers.EncoderBlock(D, 2 * D, H, 1e-5,
                                                     generator=torch.Generator().manual_seed(0))
                                 for _ in range(3))
    x = torch.randn(1, 6, D, requires_grad=True)
    layers.encoder(blocks, x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert _counts() == before == dict.fromkeys(before, 0)


@pytest.mark.parametrize("name", ["pk_dq", "pk_dkv"])
def test_pair_other_devices_raise(name):
    x = torch.empty((1, 8, 64), device="meta")
    rows = torch.empty((1, 1, 8), device="meta")
    args = (x, x, x, x, rows, x) if name == "pk_dq" else (x, x, x, rows, x, rows)
    with pytest.raises(ValueError, match="cpu or cuda"):
        getattr(tfa, name)(*args, scale=SCALE, num_heads=1)
