"""Port: the bench utilities on the CPU — `utils/flops.py` against the JAX
copy (the same formulas, the card's peak in place of the TPU ones),
`utils/profiling.py::StepTimer` against the JAX one, and
`utils/bench_cached.py` against the JAX `build_batch` and
`measure_cached_steady_state` at `tiny` in fp32 from one parameter tree.

Tolerances: flops and timer summaries equal (the same arithmetic); the
benchmark's batch equal array for array (the same numpy draws); the
measured loss within rtol 1e-4, as the cached-step parity tests
(tests/test_torch_train_cached.py) hold the loss terms.
"""

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.utils import bench_cached as jbench
from owlvit_tpu.utils import flops as jflops
from owlvit_tpu.utils import profiling as jprofiling
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.utils import bench_cached, flops, profiling

MODELS = ("tiny", "b32", "b16", "l14")


@pytest.mark.parametrize("k", [1, 2, None])
@pytest.mark.parametrize("name", MODELS)
def test_flops_equal_jax(name, k):
    """Every function of the copy gives the JAX module's number, cached and
    uncached, at each trainable depth."""
    cfg, jcfg = get_config(name, trainable_last_k=k), jax_get_config(name, trainable_last_k=k)
    v = cfg.vision
    S, D, M, P = v.num_patches + 1, v.hidden_size, v.mlp_dim, v.num_patches
    assert flops._encoder_layer_fwd(S, D, M) == jflops._encoder_layer_fwd(S, D, M)
    assert (flops._heads_fwd(P, D, cfg.projection_dim, 240)
            == jflops._heads_fwd(P, D, cfg.projection_dim, 240))
    assert flops._vision_fwd(cfg, 240) == jflops._vision_fwd(jcfg, 240)
    for q in (3, 240):
        for cached in (False, True):
            assert (flops.train_flops_per_image(cfg, q, cached)
                    == jflops.train_flops_per_image(jcfg, q, cached))
        assert flops.serve_flops_per_image(cfg, q) == jflops.serve_flops_per_image(jcfg, q)


@pytest.mark.parametrize("name, uncached, cached, serve", [
    ("b16", 711.51, 170.34, 597.95), ("b32", 137.26, 33.44, 114.96)])
def test_flops_reference_values(name, uncached, cached, serve):
    """GFLOP per image at trainable_last_k=1 and 240 queries."""
    cfg = get_config(name, trainable_last_k=1)
    assert round(flops.train_flops_per_image(cfg, 240) / 1e9, 2) == uncached
    assert round(flops.train_flops_per_image(cfg, 240, cached=True) / 1e9, 2) == cached
    assert round(flops.serve_flops_per_image(cfg, 240) / 1e9, 2) == serve


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA H100 PCIe", None), ("NVIDIA H100 NVL", None), ("TPU v5 lite", None),
    ("TPU v4", None), ("NVIDIA A100-SXM4-80GB", None), ("", None)])
def test_chip_peak_flops(name, peak):
    """The SXM card's dense bf16 peak; nothing for a PCIe or NVL card, a TPU
    kind or an unknown name."""
    assert flops.chip_peak_flops(name) == peak


def test_mfu_equal_jax():
    for ips, f, peak in ((1063.6, 170.34e9, 989e12), (0.0, 1e9, 989e12), (5.0, 1e9, None)):
        assert flops.mfu(ips, f, peak) == jflops.mfu(ips, f, peak)
    assert flops.mfu(1063.6, 170.34e9, 989e12) == pytest.approx(0.1832, abs=1e-4)


def test_step_timer_summary_equal_jax():
    durations = [0.5, 0.125, 0.25, 1.0, 0.375, 0.0625, 2.0]
    got, ref = profiling.StepTimer(), jprofiling.StepTimer()
    assert got.summary() == ref.summary() == {}
    got.durations, ref.durations = list(durations), list(durations)
    assert got.summary() == ref.summary()
    assert set(got.summary()) == {"steps", "mean_s", "p50_s", "p90_s", "total_s"}


def test_step_timer_waits_only_on_cuda(monkeypatch):
    """stop() records one duration per step; CPU tensors, nested or not,
    and None need no device wait."""
    def no_sync(*a, **k):
        raise AssertionError("synchronize called for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    t = profiling.StepTimer()
    for result in (None, torch.ones(2), {"a": [torch.ones(1), (torch.zeros(1), 3)]}):
        t.start()
        t.stop(result)
    assert len(t.durations) == 3 and all(d >= 0 for d in t.durations)
    assert profiling._devices({"a": [torch.ones(1)], "b": (torch.ones(1),)}, set()) == set()


@pytest.mark.parametrize("name, batch, n_classes, seed", [
    ("tiny", 2, 80, 0), ("tiny", 3, 5, 7), ("b16", 2, 80, 0)])
def test_build_batch_equal_jax(name, batch, n_classes, seed):
    got = bench_cached.build_batch(get_config(name), batch, n_classes, seed, device="cpu")
    ref = jbench.build_batch(jax_get_config(name), batch, n_classes, seed)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
        assert got[key].numpy().dtype == np.asarray(ref[key]).dtype, key
    assert int(got["gt_mask"][0].sum()) == min(8, get_config(name).vision.num_patches)


@pytest.fixture
def same_init(monkeypatch):
    """Both packages' owlvit.init return the same tree: the JAX draw of
    seed 0, carried over by from_jax_tree."""
    tree = jax.tree.map(np.asarray, jowlvit.init(
        jax.random.PRNGKey(0), jax_get_config("tiny"), num_queries=240))
    real = jowlvit.init
    monkeypatch.setattr(jowlvit, "init", lambda key, cfg, num_queries=None: jax.tree.map(
        jax.numpy.asarray, tree) if num_queries == 240 else real(key, cfg, num_queries))

    def port_init(cfg, generator, num_queries=None, device=None):
        assert num_queries == 240
        return from_jax_tree(tree, cfg)[0].to(device)

    monkeypatch.setattr(owlvit, "init", port_init)


def test_measure_cached_steady_state_matches_jax(same_init):
    kw = dict(dtype="float32")
    ref = jbench.measure_cached_steady_state("tiny", 2, 2, **kw)
    got = bench_cached.measure_cached_steady_state("tiny", 2, 2, device="cpu", **kw)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4, atol=0)
    assert np.isfinite(got["loss"])
    assert got["acts_mb"] == ref["acts_mb"] and got["pool_imgs"] == ref["pool_imgs"] == 2500
    for key in ("tail_imgs_per_sec", "gather_imgs_per_sec", "split_gather_imgs_per_sec"):
        assert got[key] > 0, key


def test_measure_cached_switches_and_pool_size(same_init):
    """pool_gather / split_gather off leave their rates None; the pool is
    max(batch, min(max_pool_rows, pool_bytes // row_bytes)) rows."""
    v = get_config("tiny").vision
    row_bytes = (v.num_patches + 1) * v.hidden_size * 4  # one fp32 prefix row
    got = bench_cached.measure_cached_steady_state(
        "tiny", 2, 1, dtype="float32", device="cpu", pool_gather=False, split_gather=False,
        pool_bytes=3 * row_bytes + 1, max_pool_rows=100)
    assert got["gather_imgs_per_sec"] is None and got["split_gather_imgs_per_sec"] is None
    assert got["tail_imgs_per_sec"] > 0 and np.isfinite(got["loss"])
    assert got["pool_imgs"] == 3


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench_cached.measure_cached_steady_state("tiny", 2, 1)
