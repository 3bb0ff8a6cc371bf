"""Port: the plain packed-attention version against the Pallas `_pk_fwd`
(interpret mode on CPU), and the wrapper's CPU routing.

Tolerances: fp32 holds each side against a float64 reference within the
worst-case bound of fp32 summation over the valid keys (see _f32_bound);
bf16 max-rel 2e-2 on o (both sides round p to bf16), atol 1e-3 on the fp32
lse.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import owlvit_tpu.ops.flash_attention as jfa
from owlvit_tpu_torch.ops import _cuda
from owlvit_tpu_torch.ops import flash_attention as tfa

B, S, H, HD, VALID = 2, 256, 2, 64, 200  # S a BLOCK_Q multiple; keys >= VALID masked
SCALE = HD**-0.5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H * HD)).astype(np.float32) for _ in range(3)]


def _reference_f64(q, k, v):
    """o [B, S, D] and lse [B, H, S] in float64 over keys < VALID."""
    def heads(x):
        return x.astype(np.float64).reshape(B, S, H, HD).transpose(0, 2, 1, 3)

    s = heads(q) * SCALE @ heads(k).transpose(0, 1, 3, 2)
    s[..., VALID:] = -np.inf
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    o = (p @ heads(v)) / l
    return o.transpose(0, 2, 1, 3).reshape(B, S, H * HD), (m + np.log(l))[..., 0]


def _f32_bound(v, lse):
    """Worst-case rounding of an fp32 sum of n = VALID terms, n * 2^-24 of
    the largest term: for o the largest |v|, for lse the largest |lse|.
    Summation order alone moves the result this far, so two correct fp32
    implementations (or one on a loaded machine, whose BLAS may split the
    sum differently) can each sit anywhere inside it."""
    n_u = VALID * 2.0**-24
    return n_u * np.abs(v).max(), n_u * np.abs(lse).max()


def _jax_pk_fwd(q, k, v, dtype, static):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    o, lse = jfa._pk_fwd(*(jnp.asarray(x, jd) for x in (q, k, v)), SCALE,
                         VALID, H, HD, False, static)
    lse = np.asarray(lse)  # [B, G, S, hg] -> [B, H, S]
    lse = lse.transpose(0, 1, 3, 2).reshape(B, H, S)
    return np.asarray(o.astype(jnp.float32)), lse


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(dtype, static, monkeypatch):
    # the JAX side resolves C from OWLVIT_STATIC_MAX (fp32 would otherwise
    # stay dynamic); the port takes C as an argument
    monkeypatch.setenv("OWLVIT_STATIC_MAX", "20" if static else "off")
    q, k, v = _inputs(0)
    o_j, lse_j = _jax_pk_fwd(q, k, v, dtype, static)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    o_t, lse_t = tfa.pk_fwd(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), scale=SCALE,
        num_heads=H, valid_len=VALID,
        static_max=tfa.STATIC_MAX_DEFAULT if static else None)
    assert o_t.dtype == td and o_t.shape == (B, S, H * HD)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (B, H, S)
    o_t, lse_t = o_t.float().numpy()[:, :VALID], lse_t.numpy()[..., :VALID]
    o_j, lse_j = o_j[:, :VALID], lse_j[..., :VALID]
    if dtype == "float32":
        o_64, lse_64 = _reference_f64(q, k, v)
        o_64, lse_64 = o_64[:, :VALID], lse_64[..., :VALID]
        tol_o, tol_lse = _f32_bound(v, lse_64)
        for side, o, lse in (("port", o_t, lse_t), ("pallas", o_j, lse_j)):
            np.testing.assert_allclose(o, o_64, atol=tol_o, rtol=0, err_msg=side)
            np.testing.assert_allclose(lse, lse_64, atol=tol_lse, rtol=0, err_msg=side)
    else:
        assert np.abs(o_t - o_j).max() / np.abs(o_j).max() <= 2e-2
        np.testing.assert_allclose(lse_t, lse_j, atol=1e-3, rtol=0)


def test_masked_keys_drop_out_exactly():
    """Keys at index >= valid_len get zero weight: changing them changes
    nothing in o or lse."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1))
    o1, l1 = tfa.pk_fwd(q, k, v, scale=SCALE, num_heads=H, valid_len=VALID)
    k2, v2 = k.clone(), v.clone()
    k2[:, VALID:] = 1e4
    v2[:, VALID:] = -7.0
    o2, l2 = tfa.pk_fwd(q, k2, v2, scale=SCALE, num_heads=H, valid_len=VALID)
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.parametrize("static_softmax", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_max_resolution_matches_jax(dtype, static_softmax, monkeypatch):
    monkeypatch.delenv("OWLVIT_STATIC_MAX", raising=False)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jfa._static_max_env(jnp.dtype(dtype)) if static_softmax else None
    assert tfa.resolve_static_max(td, static_softmax) == want


def test_cpu_runs_plain_and_counts_no_launch():
    before = tfa.pk_fwd.launches
    q, k, v = (torch.from_numpy(x) for x in _inputs(2))
    args = dict(scale=SCALE, num_heads=H, valid_len=VALID, static_max=20.0)
    o, lse = tfa.pk_fwd(q, k, v, **args)
    o_p, lse_p = tfa.pk_fwd_plain(q, k, v, **args)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert tfa.pk_fwd.launches == before == 0


def test_other_devices_raise():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA is refused rather than silently computed."""
    q = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.pk_fwd(q, q, q, scale=SCALE, num_heads=1)


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda._nvcc()


def test_imports_without_triton_or_nvcc(tmp_path):
    """Importing the module and running it on CPU needs neither triton nor
    the CUDA toolkit: the kernel is built only at its first CUDA launch."""
    code = (
        "import sys; sys.modules['triton'] = None\n"
        "import torch\n"
        "from owlvit_tpu_torch.ops import flash_attention as fa\n"
        "x = torch.randn(1, 10, 128)\n"
        "o, lse = fa.pk_fwd(x, x, x, scale=0.125, num_heads=2)\n"
        "assert o.shape == (1, 10, 128) and fa.pk_fwd.launches == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
