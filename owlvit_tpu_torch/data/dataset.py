"""Detection dataset with fixed-shape padded ground truth.

Replaces the reference's OwlDataset + torch DataLoader
(src/dataset.py:24-108). Differences by design:

  * GT is padded to `max_gt` with a validity mask — this is what makes
    batch > 1 possible (the reference is hard-coded to batch_size=1)
  * images are host-resized to the model resolution with PIL bicubic on
    uint8 (bit-identical to the HF processor's resize step); the cheap
    rescale+normalize runs fused on device (ops/preprocess.normalize_image)
  * class-imbalance scales use the reference's formula
    round(log(max_count / count) + 3, 1)  (dataset.py:88-98)

The port's copy of owlvit_tpu/data/dataset.py, the native decode
pointed at the port's copy of native/; tests/test_torch_data.py holds its
batches bit-equal to the original's.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Iterator, Optional

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


class DetectionDataset:
    def __init__(
        self,
        annotations_file: str,
        images_dir: str,
        image_size: int = 768,
        max_gt: int = 64,
        cache_resized: bool = False,
        native_decode: bool = True,
    ):
        """cache_resized: materialize decoded+resized uint8 images into an
        on-disk memmap once, then serve epochs at memcpy speed. The reference
        re-decodes and re-resizes every image every epoch (dataset.py:60-73);
        on few-core hosts that binds the whole train loop (~82 img/s on one
        core vs ~97 img/s device throughput at B/16).

        native_decode: decode+resize whole batches through the C++ thread
        pool (native/image_pool.cpp, PIL-exact bicubic) — the equivalent of
        the reference's num_workers=4 DataLoader. Falls back to PIL per
        image when the native library is unavailable or a decode fails."""
        self.images_dir = images_dir
        self.image_size = image_size
        self.max_gt = max_gt
        self.native_decode = native_decode

        with open(annotations_file) as f:
            data = json.load(f)
        n_total = len(data)
        # Drop images without annotations (reference dataset.py:33-34).
        self.items = [(k, v) for k, v in data.items() if len(v)]
        self.n_dropped = n_total - len(self.items)
        # Fixed shapes require capping GT per image; count what the cap cuts
        # (COCO images can carry >64 annotations — surface it, don't hide it).
        self.n_truncated = sum(1 for _, v in self.items if len(v) > max_gt)
        if self.n_truncated:
            print(
                f"warning: {self.n_truncated}/{len(self.items)} images have "
                f">{max_gt} boxes; extra GT is dropped (raise data.max_gt)",
                flush=True,
            )

        self._cache = None
        if cache_resized:
            self._build_cache(annotations_file)

    def __len__(self) -> int:
        return len(self.items)

    def labels_of(self, idx: int) -> list:
        return [a["label"] for a in self.items[idx][1]]

    def class_counts(self) -> Counter:
        c = Counter()
        for i in range(len(self)):
            c.update(self.labels_of(i))
        return c

    def class_scales(self, n_classes: int) -> np.ndarray:
        """Log-imbalance weights (reference dataset.py:88-98). Classes absent
        from the split get the max weight instead of a div-by-zero."""
        counts = self.class_counts()
        arr = np.array([counts.get(i, 0) for i in range(n_classes)], np.float64)
        mx = arr.max() if arr.max() > 0 else 1.0
        safe = np.where(arr > 0, arr, 1.0)
        scales = np.round(np.log(mx / safe) + 3.0, 1)
        return scales.astype(np.float32)

    def _build_cache(self, annotations_file: str) -> None:
        S, N = self.image_size, len(self.items)
        base = f"{annotations_file}.cache_{S}"
        arr_path, meta_path = base + ".npy", base + ".json"
        keys = [k for k, _ in self.items]
        # Image CONTENT identity, not just keys: regenerated synthetic data
        # (same paths, new pixels), a rewritten file, or a repointed
        # images_dir must invalidate the cache, or training silently
        # consumes stale pixels against fresh GT. Per-image (size, mtime)
        # stat is ~ms for thousands of files — the same validation the act
        # cache uses (ADVICE r2).
        def _stamp():
            out = [os.path.abspath(self.images_dir)]
            for k in keys:
                p = os.path.join(self.images_dir, os.path.basename(k))
                try:
                    st = os.stat(p)
                    out.append(f"{st.st_size}:{int(st.st_mtime)}")
                except OSError:
                    out.append("missing")
            return out

        stamp = _stamp()
        if os.path.exists(arr_path) and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("keys") == keys and meta.get("stamp") == stamp:
                self._cache = np.lib.format.open_memmap(arr_path, mode="r")
                self._sizes = np.asarray(meta["sizes"], np.int32)
                return
        cache = np.lib.format.open_memmap(
            arr_path, mode="w+", dtype=np.uint8, shape=(N, S, S, 3)
        )
        sizes = np.zeros((N, 2), np.int32)
        chunk = 64  # bound native-batch memory during the build
        for lo in range(0, N, chunk):
            sub = keys[lo : lo + chunk]
            imgs, whs = self._decode_resize_many(sub)
            cache[lo : lo + len(sub)] = imgs
            sizes[lo : lo + len(sub)] = whs
        cache.flush()
        with open(meta_path, "w") as f:
            json.dump({"keys": keys, "sizes": sizes.tolist(),
                       "stamp": stamp}, f)
        self._cache = np.lib.format.open_memmap(arr_path, mode="r")
        self._sizes = sizes
        print(f"resized-image cache built: {arr_path} ({N} images)", flush=True)

    def _decode_resize(self, path_key: str) -> tuple[np.ndarray, int, int]:
        path = os.path.join(self.images_dir, os.path.basename(path_key))
        img = Image.open(path).convert("RGB")
        w, h = img.size
        img = img.resize((self.image_size, self.image_size), Image.BICUBIC)
        return np.asarray(img, np.uint8), w, h

    def _decode_resize_many(
        self, path_keys: list
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch decode+resize: C++ thread pool when available, PIL fallback
        per failed/unsupported image. -> (images [n,S,S,3], wh [n,2])."""
        n, S = len(path_keys), self.image_size
        paths = [
            os.path.join(self.images_dir, os.path.basename(k))
            for k in path_keys
        ]
        if self.native_decode:
            from owlvit_tpu_torch import native

            res = native.decode_resize_batch(paths, S)
            if res is not None:
                imgs, wh, ok = res
                for i in np.flatnonzero(~ok):
                    img, w, h = self._decode_resize(path_keys[int(i)])
                    imgs[i] = img
                    wh[i] = (w, h)
                return imgs, wh
        imgs = np.empty((n, S, S, 3), np.uint8)
        wh = np.zeros((n, 2), np.int32)
        for i, key in enumerate(path_keys):
            img, w, h = self._decode_resize(key)
            imgs[i] = img
            wh[i] = (w, h)
        return imgs, wh

    def load_batch(self, idxs, with_images: bool = True) -> list:
        """Assemble samples for a batch of indices, decoding images through
        the native pool in one call when no memmap cache is active.

        with_images=False skips decode/resize entirely (activation-cached
        epochs need only GT + original sizes); sizes come from the resized
        cache metadata or a header-only PIL open."""
        idxs = [int(i) for i in idxs]
        if not with_images:
            out = []
            for i in idxs:
                w, h = self._size_of(i)
                out.append(self._make_sample(i, None, w, h))
            return out
        if self._cache is not None:
            return [self[i] for i in idxs]
        keys = [self.items[i][0] for i in idxs]
        imgs, wh = self._decode_resize_many(keys)
        return [
            self._make_sample(i, imgs[j], int(wh[j, 0]), int(wh[j, 1]))
            for j, i in enumerate(idxs)
        ]

    def _size_of(self, idx: int) -> tuple[int, int]:
        """Original (w, h) without decoding pixels."""
        if self._cache is not None:
            w, h = self._sizes[idx]
            return int(w), int(h)
        key = self.items[idx][0]
        path = os.path.join(self.images_dir, os.path.basename(key))
        with Image.open(path) as im:  # header-only read
            return im.size

    def _load_image(self, path_key: str) -> tuple[np.ndarray, int, int]:
        if self._cache is not None:
            idx = self._key_index.get(path_key)
            if idx is not None:
                w, h = self._sizes[idx]
                return np.asarray(self._cache[idx]), int(w), int(h)
        return self._decode_resize(path_key)

    @property
    def _key_index(self) -> dict:
        if not hasattr(self, "_key_index_map"):
            self._key_index_map = {k: i for i, (k, _) in enumerate(self.items)}
        return self._key_index_map

    def __getitem__(self, idx: int) -> dict:
        key, anns = self.items[idx]
        image, w, h = self._load_image(key)
        return self._make_sample(idx, image, w, h)

    def _make_sample(self, idx: int, image: np.ndarray, w: int, h: int) -> dict:
        key, anns = self.items[idx]
        G = self.max_gt
        boxes = np.zeros((G, 4), np.float32)
        labels = np.zeros((G,), np.int32)
        mask = np.zeros((G,), bool)
        for slot, a in enumerate(anns[:G]):
            x, y, bw, bh = a["bbox"]
            # abs xywh -> normalized xyxy (reference train_util.py:4-13)
            boxes[slot] = [x / w, y / h, (x + bw) / w, (y + bh) / h]
            labels[slot] = a["label"]
            mask[slot] = True

        return {
            "image": image,
            "boxes": boxes,
            "labels": labels,
            "gt_mask": mask,
            "width": np.int32(w),
            "height": np.int32(h),
            "path": os.path.join(self.images_dir, os.path.basename(key)),
        }


def batch_iterator(
    dataset: DetectionDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    pad_final: bool = True,
    index_batches=None,
    want_image=None,
) -> Iterator[dict]:
    """One epoch of fixed-shape batches (numpy). The final ragged batch is
    padded with repeated samples and flagged via `image_valid` so eval can
    skip the padding (training usually drops it instead).

    index_batches: optional iterable of [batch_size] index arrays that
    REPLACES the internal order (e.g. parallel.shard_aligned_batches, whose
    layout keeps the sharded activation pool's gathers rank-local).

    want_image: optional callback idxs -> bool; False skips image
    decode/resize for that batch and omits the "image" key (used by
    activation-cached epochs, which only consume GT + indices)."""

    def _assemble(idxs, valid):
        with_images = want_image(idxs) if want_image is not None else True
        samples = dataset.load_batch(idxs, with_images=with_images)
        keys = ("boxes", "labels", "gt_mask", "width", "height")
        if with_images:
            keys = ("image",) + keys
        batch = {k: np.stack([s[k] for s in samples]) for k in keys}
        batch["image_valid"] = valid
        batch["paths"] = [s["path"] for s in samples]
        batch["indices"] = np.asarray(idxs, np.int64)
        return batch

    if index_batches is not None:
        for idxs in index_batches:
            yield _assemble(idxs, np.ones((len(idxs),), bool))
        return

    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)

    for start in range(0, len(order), batch_size):
        idxs = order[start : start + batch_size]
        valid = np.ones((batch_size,), bool)
        if len(idxs) < batch_size:
            if not pad_final:
                return
            valid[len(idxs) :] = False
            # np.resize wraps, so this is correct even when the whole dataset
            # is smaller than one batch (order alone would be too short).
            pad = np.resize(order, batch_size - len(idxs))
            idxs = np.concatenate([idxs, pad])
        yield _assemble(idxs, valid)
