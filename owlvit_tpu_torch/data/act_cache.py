"""Frozen-backbone activation cache (disk memmap, one row per image).

The port's copy of owlvit_tpu/data/act_cache.py (the JAX package's data/
__init__ imports its jax loader, so the port cannot import the original).
`fingerprint` and `ActivationCache` are the original's, on-disk layout
included, so a cache written by either package is read by the other
(tests/test_torch_act_cache.py holds this). Added for the port:
`write_tensor` and `read_tensor`, which move torch tensors, bf16 as its
uint16 bit view, so that the port needs no ml_dtypes; and for a store that
several processes share (the trainer on a mesh), `opened`, `create` (one
process makes the files before any write) and `reopen` (the others open
them after a barrier), so that no two processes create or truncate them.

With the reference's freeze set (models.py:173-184) the ViT layers 0..L-k-1
are constant during fine-tuning, yet the reference recomputes them for every
image every epoch (main.py:64-96) — at B/16 that frozen prefix is ~2/3 of the
train step. Since the pipeline has no data augmentation (resize+normalize
only, dataset.py:60-73 — deterministic per image), the prefix output is a
pure function of (frozen params, image) and can be computed once per image
and reused for every later epoch.

This module is the storage half: a numpy memmap of [N, S, D] activations
(bf16 stored as uint16 bit-views — numpy has no native bfloat16) plus a
`filled` bitmap so a cache builds incrementally batch-by-batch during the
first epoch and is complete from epoch 2 on. A fingerprint string (model
config + params identity + dataset identity, built by the trainer) guards
against serving stale rows after a config/checkpoint change.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

try:  # jax's dtype-extension package; present wherever jax is
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BF16 = None

# storage dtype name -> (memmap dtype, view dtype)
_STORE = {
    "bfloat16": (np.uint16, _BF16),
    "float32": (np.float32, np.dtype(np.float32)),
    "float16": (np.float16, np.dtype(np.float16)),
}


def fingerprint(parts: dict) -> str:
    """Stable digest of the identity dict the trainer assembles."""
    blob = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()


class ActivationCache:
    """Incremental [N, S, D] activation memmap keyed by dataset index."""

    def __init__(self, base_path: str, n_items: int, fp: str):
        self.base = base_path
        self.n = n_items
        self.fp = fp
        self._arr = None  # raw-storage memmap, created at first write
        self._filled = None
        self._meta = None
        self._try_open_existing()

    # ------------------------------------------------------------ lifecycle

    @property
    def _paths(self):
        return self.base + ".acts.npy", self.base + ".acts.json", self.base + ".filled.npy"

    def _try_open_existing(self):
        arr_p, meta_p, filled_p = self._paths
        if not (os.path.exists(arr_p) and os.path.exists(meta_p) and os.path.exists(filled_p)):
            return
        with open(meta_p) as f:
            meta = json.load(f)
        if meta.get("fingerprint") != self.fp or meta.get("n") != self.n:
            return  # stale cache: leave on disk, a write will rebuild it
        self._meta = meta
        self._arr = np.lib.format.open_memmap(arr_p, mode="r+")
        self._filled = np.lib.format.open_memmap(filled_p, mode="r+")

    def _create(self, row_shape, dtype_name: str):
        arr_p, meta_p, filled_p = self._paths
        store_dt, _ = _STORE[dtype_name]
        self._arr = np.lib.format.open_memmap(
            arr_p, mode="w+", dtype=store_dt, shape=(self.n, *row_shape)
        )
        self._filled = np.lib.format.open_memmap(
            filled_p, mode="w+", dtype=np.uint8, shape=(self.n,)
        )
        self._filled[:] = 0
        self._meta = {
            "fingerprint": self.fp,
            "n": self.n,
            "row_shape": list(row_shape),
            "dtype": dtype_name,
        }
        with open(meta_p, "w") as f:
            json.dump(self._meta, f)

    @property
    def opened(self) -> bool:
        """Whether the files are open (found valid, or created)."""
        return self._arr is not None

    def create(self, row_shape, dtype: torch.dtype) -> None:
        """Create (truncate) the files for rows of row_shape in dtype now,
        instead of at the first write."""
        self._create(tuple(row_shape), self._torch_name(dtype))

    def reopen(self) -> None:
        """Open the files another process created for this fingerprint;
        raises when there are none."""
        self._try_open_existing()
        if self._arr is None:
            raise RuntimeError(f"no activation store at {self.base} for this "
                               "fingerprint")

    # ------------------------------------------------------------- data API

    @staticmethod
    def _dtype_name(arr) -> str:
        name = str(arr.dtype)
        if name not in _STORE:
            raise ValueError(f"unsupported activation dtype {name}")
        return name

    def write(self, indices, acts) -> None:
        """acts: host array [len(indices), S, D] (bf16/f16/f32)."""
        acts = np.asarray(acts)
        name = self._dtype_name(acts)
        store_dt, _ = _STORE[name]
        self._put(indices, acts.view(store_dt), name)

    def _put(self, indices, raw, name: str) -> None:
        """Store raw rows (the storage dtype of `name`) at `indices`."""
        if self._arr is None:
            self._create(raw.shape[1:], name)
        elif self._meta["dtype"] != name or list(raw.shape[1:]) != self._meta["row_shape"]:
            raise ValueError(
                f"activation shape/dtype changed mid-run: cache has "
                f"{self._meta['row_shape']}/{self._meta['dtype']}, got "
                f"{list(raw.shape[1:])}/{name}"
            )
        idx = np.asarray(indices, np.int64)
        self._arr[idx] = raw
        self._filled[idx] = 1

    def has(self, indices) -> bool:
        if self._filled is None:
            return False
        return bool(self._filled[np.asarray(indices, np.int64)].all())

    def read(self, indices) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        if self._filled is None or not self._filled[idx].all():
            raise KeyError("activation cache miss (call has() first)")
        _, view_dt = _STORE[self._meta["dtype"]]
        if view_dt is None:  # pragma: no cover
            raise RuntimeError("bfloat16 cache requires ml_dtypes")
        return self._arr[idx].view(view_dt)

    @staticmethod
    def _torch_name(dtype: torch.dtype) -> str:
        name = str(dtype).removeprefix("torch.")
        if name not in _STORE:
            raise ValueError(f"unsupported activation dtype {name}")
        return name

    def write_tensor(self, indices, acts: torch.Tensor) -> None:
        """write() for a torch tensor [len(indices), S, D] (bf16/f16/f32) on
        any device: copied to the host, bf16 through its bit view."""
        name = self._torch_name(acts.dtype)
        host = acts.detach().to("cpu").contiguous()
        if name == "bfloat16":
            host = host.view(torch.int16)
        self._put(indices, host.numpy().view(_STORE[name][0]), name)

    def read_tensor(self, indices) -> torch.Tensor:
        """read() as a host torch tensor in the stored activation dtype."""
        idx = np.asarray(indices, np.int64)
        if self._filled is None or not self._filled[idx].all():
            raise KeyError("activation cache miss (call has() first)")
        name = self._meta["dtype"]
        raw = np.ascontiguousarray(self._arr[idx])
        if name == "bfloat16":
            return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(raw)

    @property
    def complete(self) -> bool:
        return self._filled is not None and bool(self._filled.all())

    def flush(self) -> None:
        if self._arr is not None:
            self._arr.flush()
            self._filled.flush()
