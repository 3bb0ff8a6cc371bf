"""Sharding rules of the detector on the ("data", "model") mesh (counterpart
of owlvit_tpu/parallel/sharding.py: `_spec_for`, `param_specs`,
`shard_params`, `batch_spec`, `shard_batch`, `local_gather`,
`local_scatter`, `shard_aligned_order`, `shard_aligned_batches`).

Tensor parallelism of the encoder blocks (Megatron), on the port's [d_out,
d_in] weights (the JAX kernels are [d_in, d_out], so the JAX package's
"output dim on model" is dim 0 here):

  * q/k/v and mlp fc1: column-parallel, weight and bias sharded on d_out
  * attn out and mlp fc2: row-parallel, weight sharded on d_in; the bias is
    replicated and added once, after the reduce (models/layers.py)
  * everything else (embeddings, LayerNorms, heads, the query bank)
    replicated

A spec is a tuple with one entry per dim of the tensor: "model" on the
sharded dim, None elsewhere; () is replicated. A rank keeps its slice of
each sharded tensor (`shard_params`); the optimizer built after it holds
state of the same shapes, so its state follows its parameter by
construction (what the JAX package's `opt_state_specs` derives). Batches
split their leading axis over "data": rank r takes rows [r B/dp, (r+1)
B/dp), the layout P("data") gives.

The activation pool of the cached step is row-sharded over "data": rank r
owns rows [r N/dp, (r+1) N/dp) and holds only those. `local_gather` and
`local_scatter` address them with no collective, which holds when the
sampler aligns batches to the rows (`shard_aligned_batches`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import coords

MODEL = "model"
REPLICATED = ()

# the modules whose weights shard on "model", by the tail of their names
_COLUMN = ("attn.q", "attn.k", "attn.v", "mlp.fc1")
_ROW = ("attn.out", "mlp.fc2")


def spec_for(name: str) -> tuple:
    """The spec of a parameter (or state_dict entry) by its name, e.g.
    `vision.layers.3.attn.q.weight`; the JAX `_spec_for` on the port's
    names and layout."""
    owner, _, leaf = ("." + name).rpartition(".")
    if any(owner.endswith("." + m) for m in _COLUMN):
        return {"weight": (MODEL, None), "bias": (MODEL,)}.get(leaf, REPLICATED)
    if any(owner.endswith("." + m) for m in _ROW) and leaf == "weight":
        return (None, MODEL)
    return REPLICATED


def param_specs(model: torch.nn.Module) -> dict:
    """{parameter name: spec} of every parameter of `model`."""
    return {name: spec_for(name) for name, _ in model.named_parameters()}


def _model_dim(spec: tuple):
    return spec.index(MODEL) if MODEL in spec else None


def shard_tensor(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of a full tensor (the tensor itself if replicated)."""
    dim = _model_dim(spec)
    if dim is None:
        return full
    r, tp = coords(mesh, MODEL)
    n = full.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of size {n} does not divide by model={tp}")
    return full.narrow(dim, r * (n // tp), n // tp).contiguous()


def gather_tensor(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every model rank's slice (a collective over
    "model"; the tensor itself if replicated)."""
    dim = _model_dim(spec)
    if dim is None:
        return local
    return torch.cat(all_gather(local, mesh.get_group(MODEL)), dim=dim)


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Keep this rank's slice of every sharded parameter (in place: each
    Parameter object stays, so build the optimizer after this) and set the
    "model" group on every Attention and MLP, which then run their
    tensor-parallel form (models/layers.py). Returns the model."""
    from owlvit_tpu_torch.models.layers import MLP, Attention

    _, tp = coords(mesh, MODEL)
    group = mesh.get_group(MODEL)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_tensor(p.data, spec_for(name), mesh).clone()
    for m in model.modules():
        if isinstance(m, (Attention, MLP)):
            m.tensor_parallel(group, tp)
    return model


def batch_spec() -> tuple:
    return ("data",)


def batch_rows(batch_size: int, mesh) -> slice:
    """This rank's rows of a global batch of batch_size."""
    r, dp = coords(mesh, "data")
    if batch_size % dp:
        raise ValueError(f"batch of {batch_size} does not divide by data={dp}")
    sub = batch_size // dp
    return slice(r * sub, (r + 1) * sub)


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every array (and list) of a global batch."""
    n = len(next(iter(batch.values())))
    rows = batch_rows(n, mesh)
    return {k: v[rows] for k, v in batch.items()}


# --------------------------------------------------------------------------
# Collectives, each on the device its backend takes: gloo's on the host (a
# CUDA tensor is copied there and back, as gloo's own CUDA path does), the
# others' where the tensor lies.
# --------------------------------------------------------------------------


def _host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _all_reduce_(t: torch.Tensor, group, op) -> torch.Tensor:
    """Reduce t (contiguous) over the group with `op`, in place; returns t."""
    if t.is_cuda and _host(group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t (contiguous) over the group, in place; returns t."""
    return _all_reduce_(t, group, dist.ReduceOp.SUM)


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of t (contiguous) over the group, in place;
    returns t."""
    return _all_reduce_(t, group, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's t (same shape on every rank), in rank order."""
    src = t.contiguous()
    if src.is_cuda and _host(group):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def broadcast_(t: torch.Tensor, group, src_rank: int = 0) -> torch.Tensor:
    """t from the group's rank src_rank, in place; returns t."""
    src = dist.get_global_rank(group, src_rank)
    if t.is_cuda and _host(group):
        h = t.cpu()
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


# --------------------------------------------------------------------------
# The row-sharded activation pool.
# --------------------------------------------------------------------------


def _local_rows(pool_local: torch.Tensor, idxs, mesh, axis: str) -> torch.Tensor:
    """Global row indices -> this rank's rows of the pool, on its device.
    An index outside the rank's rows raises: the sampler is not aligned.
    Indices already on the pool's device stay there (no host read): the
    range check is then an asynchronous device assertion."""
    r, dp = coords(mesh, axis)
    per = pool_local.shape[0]  # N / dp
    if torch.is_tensor(idxs) and idxs.device == pool_local.device:
        rows = idxs.long() - r * per
        torch._assert_async(((rows >= 0) & (rows < per)).all(),
                            f"rank {r} of {axis}={dp}: a pool index outside its rows "
                            "(the sampler must be shard-aligned)")
        return rows
    idxs = np.asarray(idxs, np.int64)
    rows = idxs - r * per
    if rows.size and (rows.min() < 0 or rows.max() >= per):
        raise ValueError(
            f"rank {r} of {axis}={dp} owns pool rows [{r * per}, {(r + 1) * per}); "
            f"got indices {idxs.tolist()} (the sampler must be shard-aligned)")
    return torch.from_numpy(rows).to(pool_local.device)


def local_gather(pool_local: torch.Tensor, idxs, mesh, axis: str = "data") -> torch.Tensor:
    """Gather pool rows with rank-local indexing (no collective).

    pool_local: this rank's rows [N/dp, ...] of a pool of N rows (any
    trailing rank: [N, S, D] activations or [N, S] int8 scales); idxs:
    this rank's share of a shard-aligned global index batch, [B/dp] global
    row indices, each in [r N/dp, (r+1) N/dp): on the host (numpy or a CPU
    tensor), or a tensor on the pool's device, which is never read back.
    Returns the rows [B/dp, ...], as shard r of the JAX function's
    output."""
    return pool_local.index_select(0, _local_rows(pool_local, idxs, mesh, axis))


def local_scatter(pool_local: torch.Tensor, idxs, acts: torch.Tensor, mesh,
                  axis: str = "data") -> torch.Tensor:
    """Write this rank's batch rows acts [B/dp, ...] into its pool rows at
    the global indices idxs (as `local_gather` takes them), in place (the
    JAX function returns an updated array instead). Returns the pool."""
    return pool_local.index_copy_(0, _local_rows(pool_local, idxs, mesh, axis), acts)


def shard_aligned_order(n: int, dp: int, *, seed: int = 0) -> np.ndarray:
    """Per-epoch per-shard sample orders compatible with local_gather: shard
    r owns rows [r n//dp, (r+1) n//dp); returns [dp, n//dp], row r a
    shuffle of shard r's rows (the JAX function's bits)."""
    per = n // dp
    rng = np.random.default_rng(seed)
    shard_orders = []
    for r in range(dp):
        rows = np.arange(r * per, (r + 1) * per)
        rng.shuffle(rows)
        shard_orders.append(rows)
    return np.stack(shard_orders, axis=0)


def shard_aligned_batches(n: int, batch_size: int, dp: int, *, seed: int = 0):
    """Yield global index batches [batch_size] aligned with the pool
    sharding: positions [r B/dp, (r+1) B/dp) address shard r (the JAX
    function's batches; the per-shard ragged remainder is dropped)."""
    if batch_size % dp:
        raise ValueError(f"batch of {batch_size} does not divide by data={dp}")
    sub = batch_size // dp
    orders = shard_aligned_order(n, dp, seed=seed)
    per = orders.shape[1]
    for start in range(0, per - per % sub, sub):
        yield np.concatenate([orders[r, start:start + sub] for r in range(dp)])
