"""Port: the ("data", "model") mesh and the sharding rules
(owlvit_tpu_torch/parallel) against the JAX package's (owlvit_tpu/parallel).

- create_mesh: the refusal of a mesh that is not the world's size, the
  world of one, and over 4 ranks the axis order ("model" fastest, as the
  JAX mesh's reshape) and the backend check.
- shard_aligned_order / shard_aligned_batches: bit-equal to the JAX
  functions.
- local_gather / local_scatter: each rank's result, on its rows of the
  pool, is shard r of the JAX functions' on the 8-device virtual CPU mesh
  ([N, S, D] and [N, S] pools, dp 1, 2, 4, 8).
- param_specs: every parameter of `tiny` sharded on the dim that the JAX
  param_specs puts on "model", read through models/convert.py::to_jax_tree.
- The tiny detector at tp=2 over two gloo ranks against one device: the
  eval forward, the frozen prefix, the tail's forward and its input and
  weight gradients (fp32; the split products and the reduce sum in another
  order: rtol 1e-4, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.parallel import create_mesh as jax_create_mesh
from owlvit_tpu.parallel import local_gather as jax_local_gather
from owlvit_tpu.parallel import local_scatter as jax_local_scatter
from owlvit_tpu.parallel import param_specs as jax_param_specs
from owlvit_tpu.parallel import sharding as jsharding
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import flatten, to_jax_tree
from owlvit_tpu_torch.parallel import (create_mesh, local_gather, local_scatter,
                                       param_specs, shard_aligned_batches,
                                       shard_aligned_order)
from torch_mesh_ranks import run_ranks

RTOL_TP, ATOL_TP = 1e-4, 1e-5


class _Rank:
    """A mesh as the pool functions read it (coords): rank r of `data`."""

    def __init__(self, r: int, dp: int):
        self.r, self.dp = r, dp

    def get_local_rank(self, axis):
        return self.r if axis == "data" else 0

    def size(self, dim):
        return self.dp if dim == 0 else 1


def test_create_mesh_refuses_another_world_size():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        create_mesh(2, 1, device_type="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        create_mesh(1, 1, device_type="tpu")
    assert not dist.is_initialized()  # refused before any group was made


def test_create_mesh_world_of_one():
    mesh = create_mesh(1, 1, device_type="cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert dist.get_backend() == "gloo"
        assert dist.get_world_size(mesh.get_group("data")) == 1
    finally:
        dist.destroy_process_group()


def test_create_mesh_layout_over_four_ranks(tmp_path):
    out = run_ranks("mesh_layout", 4, tmp_path)
    jax_2x2 = np.asarray([[d.id for d in row] for row in
                          jax_create_mesh(2, 2, devices=jax.devices()[:4]).devices])
    for rank, o in enumerate(out):
        assert o[(2, 2)]["names"] == ("data", "model")
        # "model" varies fastest, as np.reshape(devices, (data, model))
        assert o[(2, 2)]["mesh"] == (jax_2x2 - jax_2x2.min()).tolist() == [[0, 1], [2, 3]]
        assert o[(2, 2)]["coords"] == ((rank // 2, 2), (rank % 2, 2))
        assert o[(4, 1)]["coords"] == ((rank, 4), (0, 1))
        assert o[(1, 4)]["coords"] == ((0, 1), (rank, 4))
        assert o["mismatch"] == "mesh 3x1 != 4 devices"
        assert "runs 'gloo'" in o["backend"]


@pytest.mark.parametrize("n,batch,dp,seed", [(16, 8, 4, 3), (17, 4, 2, 0), (40, 6, 3, 7),
                                             (8, 8, 8, 1), (9, 4, 1, 5)])
def test_shard_aligned_matches_jax(n, batch, dp, seed):
    np.testing.assert_array_equal(shard_aligned_order(n, dp, seed=seed),
                                  jsharding.shard_aligned_order(n, dp, seed=seed))
    got = list(shard_aligned_batches(n, batch, dp, seed=seed))
    want = list(jsharding.shard_aligned_batches(n, batch, dp, seed=seed))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
@pytest.mark.parametrize("trailing", [(3, 4), (3,)], ids=["NSD", "NS"])
def test_local_gather_scatter_match_jax(dp, trailing):
    N, B = 16, 8
    rng = np.random.default_rng(dp)
    pool = rng.normal(size=(N, *trailing)).astype(np.float32)
    mesh = jax_create_mesh(data=dp, model=8 // dp)
    row = NamedSharding(mesh, P("data", *([None] * len(trailing))))
    jpool = jax.device_put(jnp.asarray(pool), row)
    per, sub = N // dp, B // dp
    # one aligned batch (each JAX call compiles its shard_map anew)
    for idxs in list(shard_aligned_batches(N, B, dp, seed=dp))[:1]:
        jidx = jax.device_put(jnp.asarray(idxs), NamedSharding(mesh, P("data")))
        want = np.asarray(jax_local_gather(jpool, jidx, mesh))
        vals = rng.normal(size=(B, *trailing)).astype(np.float32)
        want_pool = np.asarray(jax_local_scatter(
            jpool, jidx, jax.device_put(jnp.asarray(vals), row), mesh))
        for r in range(dp):
            rows = slice(r * sub, (r + 1) * sub)
            local = torch.from_numpy(pool[r * per:(r + 1) * per].copy())
            got = local_gather(local, idxs[rows], _Rank(r, dp))
            np.testing.assert_array_equal(got.numpy(), want[rows])
            local_scatter(local, idxs[rows], torch.from_numpy(vals[rows]), _Rank(r, dp))
            np.testing.assert_array_equal(local.numpy(), want_pool[r * per:(r + 1) * per])
    with pytest.raises(ValueError, match="shard-aligned"):  # a row rank 0 does not own
        local_gather(torch.zeros(per, *trailing), np.array([N - 1 if dp > 1 else N]),
                     _Rank(0, dp))


def test_param_specs_match_jax():
    """Each port parameter is filled with a marker that varies along its
    sharded dim alone (replicated: constant); through to_jax_tree, the
    marker of every JAX leaf varies exactly along the axes the JAX
    param_specs puts on "model"."""
    cfg = get_config("tiny")
    model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=9)
    specs = param_specs(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.zero_()
            if "model" in specs[name]:
                dim = specs[name].index("model")
                shape = [1] * p.dim()
                shape[dim] = p.shape[dim]
                p.copy_(torch.arange(1.0, p.shape[dim] + 1).reshape(shape).expand_as(p))
    ours = flatten(to_jax_tree(model))
    jax_tree = jowlvit.init(jax.random.PRNGKey(0), jax_get_config("tiny"), num_queries=9)
    want = flatten(jax_param_specs(jax_tree))
    assert ours.keys() == want.keys()
    on_model = 0
    for key, arr in ours.items():
        varies = tuple(ax for ax in range(arr.ndim) if (np.diff(arr, axis=ax) != 0).any())
        model_axes = tuple(ax for ax, s in enumerate(want[key]) if s == "model")
        assert varies == model_axes, (key, want[key], varies)
        on_model += bool(model_axes)
    # q/k/v/fc1 kernels and biases, out/fc2 kernels, in each tower
    assert on_model == 2 * 10


def test_tensor_parallel_matches_single_device(tmp_path):
    out = run_ranks("tensor_parallel", 2, tmp_path)
    for rank, o in enumerate(out):
        want, got = o["want"], o["got"]
        for key in ("full", "tail"):
            for g, w in zip(got[key], want[key]):
                torch.testing.assert_close(g, w, rtol=RTOL_TP, atol=ATOL_TP)
        torch.testing.assert_close(got["prefix"], want["prefix"], rtol=RTOL_TP, atol=ATOL_TP)
        torch.testing.assert_close(got["dacts"], want["dacts"], rtol=RTOL_TP, atol=ATOL_TP)
        assert got["grads"].keys() == want["grads"].keys() and len(want["grads"]) > 20
        for name in want["grads"]:
            torch.testing.assert_close(got["grads"][name], want["grads"][name],
                                       rtol=RTOL_TP, atol=ATOL_TP, msg=name)
        shapes = o["local_shapes"]
        D, F = 64, get_config("tiny").vision.mlp_dim
        assert shapes["vision.layers.0.attn.q.weight"] == (D // 2, D)
        assert shapes["vision.layers.0.attn.q.bias"] == (D // 2,)
        assert shapes["vision.layers.1.attn.out.weight"] == (D, D // 2)
        assert shapes["vision.layers.1.attn.out.bias"] == (D,)
        assert shapes["vision.layers.0.mlp.fc1.weight"] == (F // 2, D)
        assert shapes["vision.layers.0.mlp.fc2.weight"] == (D, F // 2)
        assert shapes["box_head.dense0.weight"] == (D, D)
        # the 2x1 pool: rank r's rows [4r, 4r + 4) of arange(24).reshape(8, 3)
        pool = np.arange(24, dtype=np.float32).reshape(8, 3)
        idxs = [[2, 0], [5, 7]][rank]
        np.testing.assert_array_equal(o["gathered"].numpy(), pool[idxs])
        local = pool[4 * rank:4 * rank + 4].copy()
        local[np.array(idxs) - 4 * rank] *= -1
        np.testing.assert_array_equal(o["scattered"].numpy(), local)
        assert "shard-aligned" in o["misaligned"]
