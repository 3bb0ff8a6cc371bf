"""Port: the fused add+LayerNorm (ops/fused_ln.py) against the JAX package's
`add_ln` (the Pallas kernels in interpret mode), its backward against
autograd through its plain forward, and the encoder's fused branch
(OWLVIT_FUSED_LN=1) against the port's unfused encoder and against the JAX
package's fused `encoder(impl="flash")` at `tiny`.

Tolerances. fp32: r is exact (one add); y and g atol 1e-5 on values of
magnitude about 1 (the mean and variance are summed in another order, and
rsqrt differs in its last bits); dscale and dbias atol 1e-4 (sums over N
rows of terms about 1). bf16: r is exact on both sides (the fp32 sum of two
bf16 values rounds once); y and g are held to one bf16 ulp of their largest
magnitude (max-rel 1e-2): the fp32 statistics differ in their last bits, and
a value at a rounding boundary can fall either way. The encoders: fp32
rtol 1e-4 and atol 3e-5 on values and grads of magnitude 1-10 (several
layers of summation order), as the JAX package's own fused-vs-unfused test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import layers as jlayers
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.ops import flash_attention as jfa
from owlvit_tpu.ops import fused_ln as jfused
from owlvit_tpu_torch.models import get_config, layers
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.ops import fused_ln

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
SHAPES = pytest.mark.parametrize("shape", [(1, 300, 128), (3, 41, 256)])  # N = 300, 123: not 256 multiples
EPS = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    old = jfused.INTERPRET, jfa.INTERPRET
    jfused.INTERPRET = jfa.INTERPRET = True
    yield
    jfused.INTERPRET, jfa.INTERPRET = old


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _inputs(shape, dtype):
    D = shape[-1]
    # x carries a row offset, so that the mean is not ~0
    x, h = _rand(shape, 0, 2.0, 0.5), _rand(shape, 1)
    scale, bias = _rand((D,), 2, 0.3, 1.0), _rand((D,), 3, 0.1)
    wr, wy = _rand(shape, 4), _rand(shape, 5)
    return x, h, scale, bias, wr, wy


def _jax_add_ln(x, h, scale, bias, wr, wy, dtype):
    """(r, y) and the grads of sum(r*wr) + sum(y*wy) w.r.t. x, h, scale,
    bias through the JAX package's add_ln, as float32 numpy."""
    jx, jh = (jnp.asarray(a, JDT[dtype]) for a in (x, h))
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(x, h, p):
        r, y = jfused.add_ln(x, h, p, EPS)
        return (jnp.sum(r.astype(jnp.float32) * wr)
                + jnp.sum(y.astype(jnp.float32) * wy)), (r, y)

    (_, (r, y)), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jx, jh, p)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return [f32(r), f32(y), f32(g[0]), f32(g[1]), f32(g[2]["scale"]), f32(g[2]["bias"])]


def _port_add_ln(x, h, scale, bias, wr, wy, dtype):
    tx, th = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True) for a in (x, h))
    ln = layers.LayerNorm(x.shape[-1], EPS)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    r, y = fused_ln.add_ln(tx, th, ln)
    assert r.dtype == y.dtype == TDT[dtype]
    (r.float() * torch.from_numpy(wr) + y.float() * torch.from_numpy(wy)).sum().backward()
    assert ln.weight.grad.dtype == torch.float32
    return [a.detach().float().numpy()
            for a in (r, y, tx.grad, th.grad, ln.weight.grad, ln.bias.grad)]


def _max_rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@SHAPES
@DTYPES
def test_add_ln_matches_pallas(shape, dtype):
    ref = _jax_add_ln(*_inputs(shape, dtype), dtype)
    got = _port_add_ln(*_inputs(shape, dtype), dtype)
    names = ("r", "y", "dx", "dh", "dscale", "dbias")
    np.testing.assert_array_equal(got[0], ref[0], err_msg="r")
    for name, g, w in zip(names[1:], got[1:], ref[1:]):
        if name in ("dscale", "dbias"):
            # fp32 sums over N rows (bf16: of bf16 cotangent products)
            tol = 1e-4 if dtype == "float32" else 2e-3 * np.abs(w).max()
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)
        elif dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        else:
            assert _max_rel(g, w) <= 1e-2, (name, _max_rel(g, w))
    np.testing.assert_array_equal(got[2], got[3])  # one g for x and h


@DTYPES
def test_plain_backward_matches_autograd(dtype):
    """add_ln_bwd_plain against PyTorch's autograd through add_ln_fwd_plain:
    g fp32 atol 1e-5, bf16 max-rel 1e-2 (autograd rounds the LayerNorm's
    gradient to bf16 before adding dr, the kernel adds in fp32); dscale and
    dbias, fp32 sums over the rows, atol 1e-4."""
    x, h, scale, bias, wr, wy = _inputs((2, 37, 256), dtype)
    tx, th = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, h))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    dr, dy = (torch.from_numpy(a).to(TDT[dtype]) for a in (wr, wy))
    leaves = [a.clone().requires_grad_(True) for a in (tx, th, ts, tb)]
    r, y = fused_ln.add_ln_fwd_plain(*leaves, EPS)
    torch.autograd.backward([r, y], [dr, dy])
    r_, _ = fused_ln.add_ln_fwd_plain(tx, th, ts, tb, EPS)
    g, dscale, dbias = fused_ln.add_ln_bwd_plain(r_, dy, dr, ts, EPS)
    for name, got, want in (("dx", g, leaves[0].grad), ("dh", g, leaves[1].grad)):
        got, want = got.float().numpy(), want.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
        else:
            assert _max_rel(got, want) <= 1e-2, name
    for name, got, want in (("dscale", dscale, leaves[2].grad), ("dbias", dbias, leaves[3].grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0, err_msg=name)


def test_cpu_runs_plain_and_counts_no_launch():
    x, h, scale, bias, _, dy = (torch.from_numpy(a) for a in _inputs((2, 5, 128), "float32"))
    before = fused_ln.add_ln_fwd.launches, fused_ln.add_ln_bwd.launches
    r, y = fused_ln.add_ln_fwd(x, h, scale, bias, EPS)
    r_p, y_p = fused_ln.add_ln_fwd_plain(x, h, scale, bias, EPS)
    assert torch.equal(r, r_p) and torch.equal(y, y_p)
    got = fused_ln.add_ln_bwd(r, dy, x, scale, EPS)
    want = fused_ln.add_ln_bwd_plain(r, dy, x, scale, EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fused_ln.add_ln_fwd.launches, fused_ln.add_ln_bwd.launches) == before == (0, 0)


def test_other_devices_raise():
    x = torch.empty((2, 256), device="meta")
    s = torch.empty((256,), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_ln.add_ln_fwd(x, x, s, s, EPS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_ln.add_ln_bwd(x, x, x, s, EPS)


def _encoder_inputs(D=128, heads=2, n_layers=3, seed=0):
    blocks = torch.nn.ModuleList(
        layers.EncoderBlock(D, 2 * D, heads, EPS, generator=torch.Generator().manual_seed(seed))
        for _ in range(n_layers))
    with torch.no_grad():  # non-trivial LayerNorm parameters
        for i, block in enumerate(blocks):
            for j, ln in enumerate((block.ln1, block.ln2)):
                ln.weight.copy_(torch.from_numpy(_rand((D,), 10 + 2 * i + j, 0.2, 1.0)))
                ln.bias.copy_(torch.from_numpy(_rand((D,), 20 + 2 * i + j, 0.1)))
    x = torch.from_numpy(_rand((2, 19, D), seed + 1))
    return blocks, x


def _run_encoder(blocks, x, monkeypatch, fused: str):
    monkeypatch.setenv("OWLVIT_FUSED_LN", fused)
    blocks.zero_grad(set_to_none=True)
    xl = x.clone().requires_grad_(True)
    y = layers.encoder(blocks, xl)
    (y * torch.from_numpy(_rand(x.shape, 7))).sum().backward()
    return y.detach(), xl.grad, {n: p.grad.clone() for n, p in blocks.named_parameters()}


def test_encoder_fused_equals_unfused(monkeypatch):
    """The port's encoder, value and every gradient, with and without the
    fused branch: fp32 rtol 1e-4, atol 3e-5, the JAX package's own
    tolerance for the same comparison (tests/test_fused_ln.py)."""
    blocks, x = _encoder_inputs()
    calls = []
    real = layers.add_ln
    monkeypatch.setattr(layers, "add_ln", lambda *a, **k: calls.append(1) or real(*a, **k))
    fused = _run_encoder(blocks, x, monkeypatch, "1")
    assert len(calls) == 2 * len(blocks)
    plain = _run_encoder(blocks, x, monkeypatch, "0")
    assert len(calls) == 2 * len(blocks)  # off: no add_ln
    torch.testing.assert_close(fused[0], plain[0], atol=3e-5, rtol=1e-4)
    torch.testing.assert_close(fused[1], plain[1], atol=3e-5, rtol=1e-4)
    for name in plain[2]:
        torch.testing.assert_close(fused[2][name], plain[2][name], atol=3e-5, rtol=1e-4,
                                   msg=name)


def test_encoder_xla_impl_ignores_switch(monkeypatch):
    """impl "xla" keeps the plain encoder under OWLVIT_FUSED_LN=1, as the
    JAX package's switch applies to its flash path only."""
    blocks, x = _encoder_inputs(n_layers=1)
    monkeypatch.setenv("OWLVIT_FUSED_LN", "1")
    monkeypatch.setattr(layers, "add_ln", lambda *a, **k: pytest.fail("add_ln called"))
    with torch.no_grad():
        layers.encoder(blocks, x, impl="xla")


def test_encoder_fused_matches_jax_fused(monkeypatch):
    """The port's fused encoder at `tiny` against the JAX package's
    encoder(impl="flash") with OWLVIT_FUSED_LN=1 (both Pallas kernels in
    interpret mode): value and the grads of x and of every layer's LayerNorm
    and fc1 weights (fp32 rtol 1e-4, atol 3e-5)."""
    cfg = jax_get_config("tiny")
    tree = jax.tree.map(np.asarray, jowlvit.init(jax.random.PRNGKey(0), cfg, num_queries=6))
    stacked = tree["vision"]["layers"]
    for i, name in enumerate(("ln1", "ln2")):  # non-trivial LayerNorm parameters
        L, D = stacked[name]["scale"].shape
        stacked[name]["scale"] = _rand((L, D), 30 + i, 0.2, 1.0)
        stacked[name]["bias"] = _rand((L, D), 40 + i, 0.1)
    model, _ = from_jax_tree(tree, get_config("tiny"))
    vc = cfg.vision
    x = _rand((2, vc.num_patches + 1, vc.hidden_size), 9)
    w = _rand(x.shape, 8)

    monkeypatch.setenv("OWLVIT_FUSED_LN", "1")

    def jloss(x, stacked):
        y = jlayers.encoder(stacked, x, num_heads=vc.num_heads, eps=vc.layer_norm_eps,
                            impl="flash")
        return jnp.sum(y * w), y

    (_, y_ref), (gx_ref, gp_ref) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, stacked))

    blocks = model.vision.layers
    xl = torch.from_numpy(x).requires_grad_(True)
    y = layers.encoder(blocks, xl)
    (y * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(xl.grad.numpy(), np.asarray(gx_ref), atol=3e-5, rtol=1e-4)
    for i, block in enumerate(blocks):
        for name, got, want in (
                ("ln1.scale", block.ln1.weight.grad, gp_ref["ln1"]["scale"][i]),
                ("ln1.bias", block.ln1.bias.grad, gp_ref["ln1"]["bias"][i]),
                ("ln2.scale", block.ln2.weight.grad, gp_ref["ln2"]["scale"][i]),
                ("ln2.bias", block.ln2.bias.grad, gp_ref["ln2"]["bias"][i]),
                ("mlp.fc1", block.mlp.fc1.weight.grad.T, gp_ref["mlp"]["fc1"]["kernel"][i])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4,
                                       err_msg=f"layer {i} {name}")
    assert os.environ["OWLVIT_FUSED_LN"] == "1"
