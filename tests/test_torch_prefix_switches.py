"""Port: the frozen prefix's switches and the pruned matcher against the JAX
package.

OWLVIT_FAST_SOFTMAX=1 is `pk_fwd`'s fast mode (the TPU kernel's
fast_softmax branch), OWLVIT_QUANT_BACKBONE=1 / quant_backbone the int8
`linear_q` in every projection of the frozen layers, OWLVIT_MATCH_PRUNE=1
`hungarian_pruned` and OWLVIT_MATCH_SKIP=0 a solve of the padded rows too.

The JAX side of the fast softmax runs in a subprocess with XLA's
`--xla_allow_excess_precision=false`: with the flag's default, XLA on the
CPU keeps the branch's bf16 exp in fp32 (it skips the rounding of p before
the fp32 sum l), which moves lse by up to a bf16 half-ulp, 2^-9, and is
not the function the kernel's source states. Without excess precision the
two sides round at the same points.

Tolerances. The fast forward (bf16, S = 37 and 130): lse within 1e-4,
where the fast and the exact softmax differ by ~1e-3, and o within 2^-7 of
its largest magnitude (a value at a bf16 rounding boundary may fall either
way: one ulp, at most 2^-7 of the element). `linear_q`: the int8
operands equal and the output bit-equal (the same int32 sums and the same
fp32 rescale). The switched prefix (3 layers, 2 heads of 64): fp32 within
1e-4 of its largest magnitude (an fp32 difference in the layer norms or the
attention can carry an activation across an int8 rounding boundary: one
step of one token's quantized value), bf16 within 2e-2 (bf16 rounding over
3 layers, as tests/test_torch_model.py holds hidden states). The matcher:
exactly equal.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import owlvit_tpu.ops.flash_attention as jfa
import owlvit_tpu.ops.matcher as jmatcher
import owlvit_tpu.ops.quant as jquant
from owlvit_tpu.models import vit as jvit
from owlvit_tpu.models.configs import VisionConfig as JaxVisionConfig
from owlvit_tpu_torch.models import get_config, layers, owlvit, vit
from owlvit_tpu_torch.models.configs import VisionConfig
from owlvit_tpu_torch.models.convert import to_jax_tree
from owlvit_tpu_torch.ops import flash_attention as tfa
from owlvit_tpu_torch.ops import matcher as tmatcher
from owlvit_tpu_torch.ops import quant as tquant

from torch_mesh_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, HD = 2, 2, 64
SCALE = HD**-0.5
FAST_CASES = ((37, 30), (130, 101))  # (S, valid_len): ragged tiles, masked keys
TOL_FAST_LSE, TOL_FAST_O_REL = 1e-4, 2.0**-7
TOL_PREFIX = {"float32": 1e-4, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# 3 layers, 2 heads of 64: the JAX packed_supported holds (hd 64)
VC = dict(image_size=96, patch_size=32, hidden_size=128, num_layers=3, num_heads=2,
          mlp_dim=256)
SWITCHES = ("OWLVIT_FAST_SOFTMAX", "OWLVIT_QUANT_BACKBONE", "OWLVIT_MATCH_PRUNE",
            "OWLVIT_MATCH_SKIP", "OWLVIT_STATIC_MAX")


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _qkv(S, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, S, H * HD)) * 2).astype(np.float32) for _ in range(3)]


def _vision():
    """A random port ViT (biases drawn too) and its JAX parameter tree."""
    g = torch.Generator().manual_seed(4)
    model = vit.init(VisionConfig(**VC), g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model.eval(), to_jax_tree(model)


def _pixels(seed=3):
    return np.random.default_rng(seed).normal(size=(2, 96, 96, 3)).astype(np.float32)


# The JAX side without excess precision, in a process of its own (the flag
# is read when XLA's CPU backend starts). argv: inputs .npz, outputs .npz.
_STRICT_JAX = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
import owlvit_tpu.ops.flash_attention as jfa
from owlvit_tpu.models import vit as jvit
from owlvit_tpu.models.configs import VisionConfig

src = dict(np.load(sys.argv[1]))
meta = {k[5:]: src.pop(k) for k in list(src) if k.startswith("meta_")}
H, HD = int(meta["H"]), int(meta["HD"])
out = {}
for S, valid in meta["fast_cases"].tolist():
    q, k, v = (src[f"{n}_{S}"] for n in "qkv")
    S_pad = -(-S // 128) * 128
    pad = lambda x: np.pad(x, ((0, 0), (0, S_pad - S), (0, 0)))
    for dt, jd in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32)):
        for fast, static in ((True, False), (False, False), (True, True)):
            o, lse = jfa._pk_fwd(*(jnp.asarray(pad(x), jd) for x in (q, k, v)), HD**-0.5,
                                 valid, H, HD, fast, static)
            lse = np.asarray(lse).transpose(0, 1, 3, 2).reshape(q.shape[0], H, S_pad)
            key = f"{S}_{dt}_{int(fast)}{int(static)}"
            out[f"o_{key}"] = np.asarray(o.astype(jnp.float32))[:, :S]
            out[f"lse_{key}"] = lse[..., :S]
vc = VisionConfig(**{k: int(meta[k]) for k in
                     ("image_size", "patch_size", "hidden_size", "num_layers", "num_heads",
                      "mlp_dim")})
tree = {k[7:]: v for k, v in src.items() if k.startswith("vision/")}
params = {}
for key, val in tree.items():
    node = params
    *path, leaf = key.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = jnp.asarray(val)
px = jnp.asarray(src["pixels"])
n_real = vc.num_patches + 1
out["prefix_fast"] = np.asarray(jvit.forward_prefix(
    params, vc, px, dtype=jnp.bfloat16, attention_impl="flash",
    trainable_last_k=1).astype(jnp.float32))[:, :n_real]
np.savez(sys.argv[2], **out)
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def strict_jax(tmp_path_factory):
    """The JAX fast-softmax forward (every FAST_CASES shape, bf16 and fp32,
    fast, exact and fast + static) and the JAX frozen prefix under
    OWLVIT_FAST_SOFTMAX=1 (bf16, flash in interpret mode), computed without
    excess precision."""
    tmp = tmp_path_factory.mktemp("strict_jax")
    _, tree = _vision()
    arrays = {f"vision/{k}": v for k, v in _flat(tree).items()}
    for S, _ in FAST_CASES:
        for n, x in zip("qkv", _qkv(S, S)):
            arrays[f"{n}_{S}"] = x
    arrays["pixels"] = _pixels()
    meta = {"H": H, "HD": HD, "fast_cases": np.array(FAST_CASES), **VC}
    arrays.update({f"meta_{k}": np.asarray(v) for k, v in meta.items()})
    np.savez(tmp / "in.npz", **arrays)
    # OWLVIT_STATIC_MAX=20: the JAX fixed shift in fp32 too, the port's C
    env = {**os.environ, "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "JAX_PLATFORMS": "cpu", "OWLVIT_FAST_SOFTMAX": "1", "OWLVIT_STATIC_MAX": "20",
           "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", _STRICT_JAX, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _port_fwd(S, valid, dtype, fast, static):
    q, k, v = (torch.from_numpy(x).to(TDT[dtype]) for x in _qkv(S, S))
    o, lse = tfa.pk_fwd(q, k, v, scale=SCALE, num_heads=H, valid_len=valid,
                        static_max=tfa.STATIC_MAX_DEFAULT if static else None,
                        fast_softmax=fast)
    return o.float().numpy(), lse.numpy()


def _max_rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("S, valid", FAST_CASES)
def test_fast_plain_matches_pallas(S, valid, strict_jax):
    """bf16: the fast plain version against the JAX kernel's fast branch,
    and both clearly apart from the exact softmax."""
    o, lse = _port_fwd(S, valid, "bfloat16", True, False)
    o_j, lse_j = strict_jax[f"o_{S}_bfloat16_10"], strict_jax[f"lse_{S}_bfloat16_10"]
    assert np.abs(lse - lse_j).max() <= TOL_FAST_LSE
    assert _max_rel(o, o_j) <= TOL_FAST_O_REL
    o_x, lse_x = strict_jax[f"o_{S}_bfloat16_00"], strict_jax[f"lse_{S}_bfloat16_00"]
    assert np.abs(lse_x - lse_j).max() > 5 * TOL_FAST_LSE  # the switch changes the function


@pytest.mark.parametrize("S, valid", FAST_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_static_wins_over_fast(S, valid, dtype, strict_jax):
    """fast + static is the fixed shift, bit-equal to it in the port and
    within the module's bf16 / fp32 tolerances of the JAX kernel's."""
    o, lse = _port_fwd(S, valid, dtype, True, True)
    o_s, lse_s = _port_fwd(S, valid, dtype, False, True)
    np.testing.assert_array_equal(o, o_s)
    np.testing.assert_array_equal(lse, lse_s)
    o_j, lse_j = strict_jax[f"o_{S}_{dtype}_11"], strict_jax[f"lse_{S}_{dtype}_11"]
    assert np.abs(lse - lse_j).max() <= TOL_FAST_LSE
    assert _max_rel(o, o_j) <= (TOL_FAST_O_REL if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("S, valid", FAST_CASES)
def test_fp32_ignores_fast(S, valid, strict_jax):
    o, lse = _port_fwd(S, valid, "float32", True, False)
    o_x, lse_x = _port_fwd(S, valid, "float32", False, False)
    np.testing.assert_array_equal(o, o_x)
    np.testing.assert_array_equal(lse, lse_x)
    np.testing.assert_allclose(o, strict_jax[f"o_{S}_float32_10"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse, strict_jax[f"lse_{S}_float32_10"], atol=1e-5, rtol=0)


def test_softmax_mode():
    bf, f32 = torch.bfloat16, torch.float32
    assert tfa.softmax_mode(bf, None, True) == tfa.FAST
    assert tfa.softmax_mode(bf, 20.0, True) == tfa.STATIC_SHIFT
    assert tfa.softmax_mode(f32, None, True) == tfa.ROW_MAX
    assert tfa.softmax_mode(bf, None, False) == tfa.ROW_MAX


@pytest.mark.parametrize("fn", [tfa.flash_attention_packed, tfa.flash_attention_hybrid])
def test_fast_differentiated_raises(fn):
    """The autograd paths refuse fast_softmax with NotImplementedError, as
    the JAX package's `_check_differentiable`, on a recorded call and under
    no_grad alike: the one route to the fast mode is `pk_fwd`."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(37, 37))
    with pytest.raises(NotImplementedError, match="fast_softmax"):
        fn(q.requires_grad_(True), k, v, scale=SCALE, num_heads=H, fast_softmax=True)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="fast_softmax"):
        fn(q, k, v, scale=SCALE, num_heads=H, fast_softmax=True)
    got = fn(q, k, v, scale=SCALE, num_heads=H)
    want, _ = tfa.pk_fwd_plain(q.detach(), k, v, scale=SCALE, num_heads=H)
    assert torch.equal(got.detach(), want)


def test_attention_recorded_fast_raises():
    attn = layers.Attention(H * HD, H, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 10, H * HD, requires_grad=True).bfloat16()
    with pytest.raises(NotImplementedError):
        attn(x, fast_softmax=True)


@functools.lru_cache(maxsize=1)
def _smoke():
    """chip_smoke.py as a module: its fast-softmax emulation and limits
    (importing it needs no card)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_fast",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv_bf16(S, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, H * HD, generator=g).bfloat16() for _ in range(3)]


@pytest.mark.parametrize("S", [37, 64])
def test_smoke_fast_emulation_one_tile(S):
    """The smoke's emulation of the fast kernel's online arithmetic is the
    plain fast version, bit for bit, where one 64-key tile holds the row
    (the running max is the row's)."""
    q, k, v = _qkv_bf16(S, S)
    got = _smoke().pk_fwd_fast_online(q, k, v, H, SCALE)
    want = tfa.pk_fwd_plain(q, k, v, scale=SCALE, num_heads=H, fast_softmax=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("S", [130, 300])
def test_smoke_fast_limits(S):
    """The smoke's fast limits over several tiles: the emulation in the
    kernel's place holds every one, and the exact softmax (the per-row max
    kernel's function) fails each limit the smoke requires it to fail."""
    smoke = _smoke()
    q, k, v = _qkv_bf16(S, S)
    outputs = {"fast": smoke.pk_fwd_fast_online(q, k, v, H, SCALE),
               "row_max": tfa.pk_fwd_plain(q, k, v, scale=SCALE, num_heads=H)}
    got = smoke.fast_readings(q, k, v, H, SCALE, outputs, slice_=1)
    plain = got.pop("plain_fast")
    assert all(smoke.fast_limits(got["fast"], plain).values())
    row_max = smoke.fast_limits(got["row_max"], plain)
    assert not any(v for name, v in row_max.items() if name != "factor")


# ------------------------------------------------------------------ linear_q

@pytest.mark.parametrize("shape", [(2, 10, 128), (7, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_q_matches_jax(dtype, shape):
    rng = np.random.default_rng(len(shape))
    d_in, d_out = shape[-1], 96
    x = (rng.normal(size=shape) * rng.uniform(0.1, 4, size=shape[:-1] + (1,)))
    x = x.astype(np.float32)
    w = rng.normal(size=(d_in, d_out)).astype(np.float32) * 0.05  # JAX [d_in, d_out]
    b = rng.normal(size=d_out).astype(np.float32)
    xj = jnp.asarray(x, JDT[dtype])
    want = jquant.linear_q({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, xj)
    xt = torch.from_numpy(x).to(TDT[dtype])
    wt = torch.from_numpy(w.T.copy())
    got = tquant.linear_q(xt, wt, torch.from_numpy(b))
    assert got.dtype == TDT[dtype] and got.shape == shape[:-1] + (d_out,)
    # the int8 operands
    xs_j = jquant._per_token_scale(xj)
    ws_j = jquant._per_channel_scale(jnp.asarray(w))
    xs_t = tquant._scale(xt.float().abs().amax(-1, keepdim=True))
    ws_t = tquant._scale(wt.abs().amax(-1))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))
    np.testing.assert_array_equal(ws_t.numpy(), np.asarray(ws_j))
    np.testing.assert_array_equal(tquant._quantize(xt, xs_t).numpy(),
                                  np.asarray(jquant._quantize(xj, xs_j)))
    np.testing.assert_array_equal(tquant._quantize(wt, ws_t[:, None]).numpy().T,
                                  np.asarray(jquant._quantize(jnp.asarray(w), ws_j[None, :])))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))


def test_linear_module_quantized():
    lin = layers.Linear(64, 32, generator=torch.Generator().manual_seed(1))
    x = torch.randn(3, 5, 64)
    assert torch.equal(lin(x, quantized=True), tquant.linear_q(x, lin.weight, lin.bias))
    assert not torch.equal(lin(x, quantized=True), lin(x))


# ------------------------------------------------------- the switched prefix

def _jax_prefix(tree, dtype, impl, quant):
    vc = JaxVisionConfig(**VC)
    out = jvit.forward_prefix(jax.tree.map(jnp.asarray, tree), vc, jnp.asarray(_pixels()),
                              dtype=JDT[dtype], attention_impl=impl, trainable_last_k=1,
                              quant_backbone=quant)
    return np.asarray(out.astype(jnp.float32))[:, :vc.num_patches + 1]


def _port_prefix(model, dtype, impl="auto", quant=False):
    return vit.forward_prefix(model, VisionConfig(**VC), torch.from_numpy(_pixels()),
                              dtype=TDT[dtype], attention_impl=impl, trainable_last_k=1,
                              quant_backbone=quant).float().numpy()


@pytest.mark.parametrize("how", ["env", "config"])
@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_prefix_matches_jax(dtype, impl, how, monkeypatch):
    """OWLVIT_QUANT_BACKBONE=1 or quant_backbone: the int8 prefix against
    the JAX package's, on both attention paths (each quantizes its
    projections)."""
    model, tree = _vision()
    if how == "env":
        monkeypatch.setenv("OWLVIT_QUANT_BACKBONE", "1")
    want = _jax_prefix(tree, dtype, impl, how == "config")
    got = _port_prefix(model, dtype, "xla" if impl == "xla" else "auto", how == "config")
    assert _max_rel(got, want) <= TOL_PREFIX[dtype]
    monkeypatch.delenv("OWLVIT_QUANT_BACKBONE", raising=False)
    plain = _port_prefix(model, dtype, "xla" if impl == "xla" else "auto")
    assert _max_rel(got, plain) > 2 * TOL_PREFIX["float32"]  # the switch took effect


def test_fast_prefix_matches_jax(strict_jax, monkeypatch):
    """OWLVIT_FAST_SOFTMAX=1, bf16: the port's prefix (pk_fwd's fast mode,
    the plain version here) against the JAX prefix on its flash kernels."""
    model, _ = _vision()
    seen = []
    real = layers.pk_fwd
    monkeypatch.setattr(layers, "pk_fwd", lambda *a, fast_softmax=False, **kw:
                        seen.append(fast_softmax) or real(*a, fast_softmax=fast_softmax, **kw))
    monkeypatch.setenv("OWLVIT_FAST_SOFTMAX", "1")
    got = _port_prefix(model, "bfloat16")
    assert seen == [True] * (VC["num_layers"] - 1)
    assert _max_rel(got, strict_jax["prefix_fast"]) <= TOL_PREFIX["bfloat16"]
    # the XLA path ignores the switch, as the JAX package's does
    monkeypatch.setattr(layers, "pk_fwd", real)
    monkeypatch.delenv("OWLVIT_FAST_SOFTMAX")
    xla = _port_prefix(model, "bfloat16", "xla")
    monkeypatch.setenv("OWLVIT_FAST_SOFTMAX", "1")
    assert np.array_equal(_port_prefix(model, "bfloat16", "xla"), xla)


def test_switches_reach_the_train_forward(monkeypatch):
    """forward_train at trainable_last_k=1 under both switches: the frozen
    layer's projections go through linear_q and its attention through the
    fast mode; the trained layer through neither."""
    cfg = get_config("tiny", trainable_last_k=1, dtype="bfloat16")
    cfg = cfg.replace(vision=VisionConfig(**{**VC, "num_layers": 2}))
    model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=6)
    calls = {"q": 0, "fast": []}
    real_q, real_fwd = layers.linear_q, layers.pk_fwd
    monkeypatch.setattr(layers, "linear_q", lambda *a, **kw: calls.__setitem__(
        "q", calls["q"] + 1) or real_q(*a, **kw))
    monkeypatch.setattr(layers, "pk_fwd", lambda *a, fast_softmax=False, **kw:
                        calls["fast"].append(fast_softmax) or real_fwd(*a, **kw,
                                                                        fast_softmax=fast_softmax))
    monkeypatch.setenv("OWLVIT_FAST_SOFTMAX", "1")
    monkeypatch.setenv("OWLVIT_QUANT_BACKBONE", "1")
    with torch.no_grad():
        owlvit.forward_train(model, cfg, torch.from_numpy(_pixels()))
    assert calls["q"] == 6  # q, k, v, out, fc1, fc2 of the one frozen layer
    assert calls["fast"] == [True, False]  # the frozen layer, then the trained one


def test_quant_prefix_tensor_parallel(tmp_path):
    """The int8 prefix at tp=2 on two gloo ranks against one device: the
    row-parallel out and fc2 take both scales over the whole d_in (max over
    the group) and sum the int32 products, so the numbers are the single
    device's."""
    out = run_ranks("quant_prefix_tp", 2, tmp_path)
    for o in out:
        torch.testing.assert_close(o["tp"], o["one"], rtol=1e-4, atol=1e-5)
        assert (o["one"] - o["plain"]).abs().max() > 1e-3  # the switch took effect


# ---------------------------------------------------------------- the matcher

def _random_costs(rng, Bm, R, C):
    cost = rng.normal(size=(Bm, R, C)).astype(np.float32)
    mask = rng.random((Bm, R)) < 0.6
    mask[0] = True
    cost = np.where(mask[..., None], cost, 0.0).astype(np.float32)  # zeroed padded rows
    return cost, mask


def _tie_costs(rng, Bm, R, C):
    cost = rng.integers(0, 3, (Bm, R, C)).astype(np.float32)
    cost[..., C // 2:2 * (C // 2)] = cost[..., :C // 2]
    mask = rng.random((Bm, R)) < 0.5
    mask[0], mask[1] = True, False
    cost[2], mask[2] = cost[2, 0], True
    return cost, mask


def _signed_zero_costs(rng, Bm, R, C):
    cost = rng.choice(np.array([-0.0, 0.0, 1.0, 2.0], np.float32), (Bm, R, C))
    mask = rng.random((Bm, R)) < 0.75
    mask[0] = True
    return cost, mask


COSTS = {"random": _random_costs, "ties": _tie_costs, "signed_zeros": _signed_zero_costs}
# (R, C): pruned (R*R < C) and the R*R >= C fallback
MATCH_SHAPES = ((4, 40), (6, 80), (8, 40))


@pytest.mark.parametrize("R, C", MATCH_SHAPES)
@pytest.mark.parametrize("kind", sorted(COSTS))
def test_hungarian_pruned_matches_jax(kind, R, C):
    rng = np.random.default_rng(R * C)
    cost, mask = COSTS[kind](rng, 4, R, C)
    got = tmatcher.hungarian_pruned(torch.from_numpy(cost), torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (4, R)
    for b in range(4):
        want = jmatcher.hungarian_pruned(jnp.asarray(cost[b]), jnp.asarray(mask[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want), err_msg=f"image {b}")
    # the same optimum as the full solve; masked rows -1
    full = tmatcher.hungarian(cost, mask)
    for b in range(4):
        rows = np.flatnonzero(mask[b])
        assert (got[b].numpy()[~mask[b]] == -1).all()
        np.testing.assert_allclose(cost[b, rows, got[b].numpy()[rows]].sum(),
                                   cost[b, rows, full[b, rows]].sum(), rtol=0, atol=1e-5)


def test_top_k_order_of_signed_zeros():
    """XLA's top_k puts -0 ahead of +0 (IEEE total order) and equal values
    by index: the port's key sort picks the same columns."""
    row = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0], np.float32)
    _, want = jax.lax.top_k(-jnp.asarray(row), 4)
    key = tmatcher._total_order_key(torch.from_numpy(row))
    got = torch.sort(key, stable=True).indices[:4]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _match_inputs(seed, Bm=4, G=6, P=80, n_classes=5):
    rng = np.random.default_rng(seed)
    sims = rng.uniform(-1, 1, (Bm, P, n_classes)).astype(np.float32)
    c = rng.uniform(0.1, 0.9, (Bm, P, 2))
    wh = rng.uniform(0.05, 0.3, (Bm, P, 2))
    pred = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    c = rng.uniform(0.1, 0.9, (Bm, G, 2))
    wh = rng.uniform(0.05, 0.3, (Bm, G, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    labels = rng.integers(0, n_classes, (Bm, G)).astype(np.int32)
    mask = rng.random((Bm, G)) < 0.6
    mask[0] = True
    return sims, pred, labels, gt, mask, n_classes


@pytest.mark.parametrize("env", [{"OWLVIT_MATCH_PRUNE": "1"}, {"OWLVIT_MATCH_SKIP": "0"},
                                 {"OWLVIT_MATCH_PRUNE": "1", "OWLVIT_MATCH_SKIP": "0"}, {}],
                         ids=["prune", "no_skip", "prune_no_skip", "default"])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_switches_match_jax(env, seed, monkeypatch):
    """match under the JAX package's switches, read at call time, against
    its vmapped match: assigned and target_classes exactly (under
    OWLVIT_MATCH_SKIP=0 the padded rows' columns too)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sims, pred, labels, gt, mask, nc = _match_inputs(seed)
    a_j, t_j = jax.vmap(lambda s, b, l, g, m: jmatcher.match(s, b, l, g, m, nc))(
        *(jnp.asarray(x) for x in (sims, pred, labels, gt, mask)))
    a_t, t_t = tmatcher.match(*(torch.from_numpy(x) for x in (sims, pred, labels, gt, mask)),
                              nc)
    a_j, a_t = np.asarray(a_j), a_t.numpy()
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(a_t[mask], a_j[mask])
    if env.get("OWLVIT_MATCH_SKIP") == "0":
        np.testing.assert_array_equal(a_t, a_j)
    else:
        assert (a_t[~mask] == -1).all()


def test_solve_routes(monkeypatch):
    """`solve` takes the pruned solver under OWLVIT_MATCH_PRUNE=1 and an
    all-true row mask under OWLVIT_MATCH_SKIP=0, read at call time."""
    seen = []
    monkeypatch.setattr(tmatcher, "hungarian_pruned",
                        lambda c, m: seen.append(("pruned", m.all().item())) or
                        torch.zeros(m.shape, dtype=torch.int32))
    monkeypatch.setattr(tmatcher, "jv_assign",
                        lambda c, m: seen.append(("full", m.all().item())) or
                        torch.zeros(m.shape, dtype=torch.int32))
    cost = torch.zeros(1, 2, 9)
    mask = torch.tensor([[True, False]])
    tmatcher.solve(cost, mask)
    monkeypatch.setenv("OWLVIT_MATCH_PRUNE", "1")
    tmatcher.solve(cost, mask)
    monkeypatch.setenv("OWLVIT_MATCH_SKIP", "0")
    tmatcher.solve(cost, mask)
    assert seen == [("full", False), ("pruned", False), ("pruned", True)]
