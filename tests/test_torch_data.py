"""Port: the data feed against the JAX package's.

The copies (`data/{synthetic,coco,dataset}.py`, `native/`) are held to their
originals by output: the synthetic set's files byte-equal, the native decode
bit-equal, every batch of `batch_iterator` bit-equal (shuffled, padded final
batch, `want_image`), the labelmap and COCO subset equal. The rewritten
`prefetch_to_device` is held to the JAX loader's contract on the CPU: tensors
out, host keys untouched, producer errors raised in the consumer, the
producer gone when the consumer drops the iterator, and the card by default.
"""

import filecmp
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from owlvit_tpu import native as jnative
from owlvit_tpu.data import DetectionDataset as JaxDataset
from owlvit_tpu.data import batch_iterator as jax_batch_iterator
from owlvit_tpu.data import coco as jcoco
from owlvit_tpu.data import synthetic as jsynthetic
from owlvit_tpu_torch import native
from owlvit_tpu_torch.data import DetectionDataset, batch_iterator, coco, prefetch_to_device
from owlvit_tpu_torch.data import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The synthetic set written by each package from one seed."""
    root = tmp_path_factory.mktemp("synth")
    args = dict(n_train=10, n_test=5, n_classes=3, seed=3)
    return (jsynthetic.generate(str(root / "jax"), **args),
            synthetic.generate(str(root / "port"), **args))


def test_synthetic_files_byte_equal(sets):
    jax_paths, port_paths = sets
    for key in ("train", "test", "labelmap"):
        assert filecmp.cmp(jax_paths[key], port_paths[key], shallow=False), key
    names = sorted(os.listdir(jax_paths["images_dir"]))
    assert names == sorted(os.listdir(port_paths["images_dir"])) and len(names) == 15
    for name in names:
        assert filecmp.cmp(os.path.join(jax_paths["images_dir"], name),
                           os.path.join(port_paths["images_dir"], name), shallow=False)


def _cpp_code(path):
    """A C++ source without its // comments and blank lines."""
    with open(path) as f:
        lines = (line.split("//")[0].rstrip() for line in f)
        return [line for line in lines if line]


def test_native_sources_are_copies():
    """The port's C++ is the original's code (comments aside)."""
    for name in ("image_pool.cpp", "owlvit_native.cpp"):
        code = _cpp_code(os.path.join(REPO, "owlvit_tpu_torch/native/src", name))
        assert len(code) > 100
        assert code == _cpp_code(os.path.join(REPO, "owlvit_tpu/native/src", name))


def test_native_decode_bit_equal(sets):
    jax_paths, _ = sets
    d = jax_paths["images_dir"]
    paths = [os.path.join(d, n) for n in sorted(os.listdir(d))]
    want, got = jnative.decode_resize_batch(paths, 96), native.decode_resize_batch(paths, 96)
    if want is None or got is None:
        pytest.skip("the native image library does not build here (g++, libjpeg, libpng)")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[2].all()


def _datasets(paths, split, **kw):
    args = (paths[split], paths["images_dir"])
    return JaxDataset(*args, image_size=96, max_gt=8, **kw), DetectionDataset(
        *args, image_size=96, max_gt=8, **kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "paths":
                assert [os.path.basename(p) for p in g[k]] == [
                    os.path.basename(p) for p in w[k]]
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("native_decode", [True, False])
@pytest.mark.parametrize("split,batch,shuffle,pad_final", [
    ("train", 4, True, False), ("train", 4, False, True), ("test", 2, False, True),
    ("test", 8, False, True)])
def test_batch_iterator_bit_equal(sets, native_decode, split, batch, shuffle, pad_final):
    """Shuffled train epochs (ragged remainder dropped) and eval passes
    (final batch padded by wrapping, image_valid False on the padding)."""
    jax_paths, _ = sets
    jds, pds = _datasets(jax_paths, split, native_decode=native_decode)
    kw = dict(shuffle=shuffle, seed=7, pad_final=pad_final)
    _assert_batches_equal(list(batch_iterator(pds, batch, **kw)),
                          list(jax_batch_iterator(jds, batch, **kw)))


def test_batch_iterator_want_image_bit_equal(sets):
    """want_image False leaves the image out (GT and sizes still there)."""
    jax_paths, _ = sets
    jds, pds = _datasets(jax_paths, "train")

    def want(idxs):
        return bool(np.asarray(idxs)[0] % 2)

    got = list(batch_iterator(pds, 3, shuffle=True, seed=1, want_image=want))
    assert any("image" not in b for b in got) and any("image" in b for b in got)
    _assert_batches_equal(got, list(jax_batch_iterator(jds, 3, shuffle=True, seed=1,
                                                       want_image=want)))


def test_dataset_class_scales_and_cache_equal(sets, tmp_path):
    jax_paths, _ = sets
    jds, pds = _datasets(jax_paths, "train")
    np.testing.assert_array_equal(pds.class_scales(3), jds.class_scales(3))
    # the resized-image memmap: built by the port, bit-equal batches
    ann = tmp_path / "train.json"
    ann.write_text(open(jax_paths["train"]).read())
    cached = DetectionDataset(str(ann), jax_paths["images_dir"], image_size=96, max_gt=8,
                              cache_resized=True)
    _assert_batches_equal(list(batch_iterator(cached, 4)),
                          list(jax_batch_iterator(jds, 4)))


def test_coco_labelmap_and_subset_equal(tmp_path):
    rng = np.random.default_rng(0)
    cats = [{"id": i, "name": f"c{i}"} for i in (1, 3, 7, 9)]
    images = [{"id": i, "file_name": f"{i}.jpg", "coco_url": f"http://x/{i}.jpg"}
              for i in range(30)]
    anns = [{"image_id": int(rng.integers(0, 30)), "category_id": int(rng.choice([1, 3, 7, 9])),
             "bbox": [1.0, 2.0, 10.0, 12.0], "id": j} for j in range(90)]
    src = tmp_path / "instances.json"
    src.write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    want = jcoco.build_subset(str(src), str(tmp_path / "jax"), num_train=12, num_test=5, seed=2)
    got = coco.build_subset(str(src), str(tmp_path / "port"), num_train=12, num_test=5, seed=2)
    assert got == want
    for name in ("train.json", "test.json", "labelmap.json", "counts.json"):
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False)
    lm = str(tmp_path / "port" / "labelmap.json")
    assert coco.load_labelmap(lm) == jcoco.load_labelmap(lm)


def test_prefetch_cpu_tensors_and_host_keys():
    """On the CPU every array becomes a tensor sharing the numpy buffer;
    paths, indices and host_keys stay as they were."""
    batches = [{"image": np.full((2, 3), i, np.uint8), "width": np.array([5, 6]),
                "indices": np.array([i, i + 1]), "paths": ["a", "b"]} for i in range(3)]
    got = list(prefetch_to_device(iter(batches), device="cpu", host_keys=("width",)))
    assert len(got) == 3
    for b, want in zip(got, batches):
        assert isinstance(b["image"], torch.Tensor)
        np.testing.assert_array_equal(b["image"].numpy(), want["image"])
        assert b["width"] is want["width"] and b["indices"] is want["indices"]
        assert b["paths"] == ["a", "b"]


def test_prefetch_propagates_producer_errors():
    def bad_iterator():
        yield {"x": np.zeros((2, 2), np.float32)}
        raise RuntimeError("decode exploded")

    it = prefetch_to_device(bad_iterator(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(it)


def test_prefetch_producer_exits_when_consumer_abandons():
    def gen():
        for _ in range(1000):
            yield {"x": np.zeros((8,), np.float32)}

    before = set(threading.enumerate())
    it = prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 10
    while time.time() < deadline:
        leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
        if not leaked:
            break
        time.sleep(0.2)
    assert not leaked, f"producer thread leaked: {leaked}"


def test_prefetch_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([{"x": np.zeros(2)}])))


def test_package_ships_its_build_sources():
    """setup.py's package_data covers every file the port compiles at first
    use: the CUDA sources and their shared header, the host C++ sources."""
    import ast
    import glob

    tree = ast.parse(open(os.path.join(REPO, "setup.py")).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "setup")
    data = ast.literal_eval(next(k.value for k in call.keywords if k.arg == "package_data"))
    pkg = os.path.join(REPO, "owlvit_tpu_torch")
    shipped = {os.path.normpath(p) for pattern in data["owlvit_tpu_torch"]
               for p in glob.glob(os.path.join(pkg, pattern))}
    needed = {os.path.normpath(p) for pattern in ("csrc/*.cu", "csrc/*.cuh", "native/src/*")
              for p in glob.glob(os.path.join(pkg, pattern))}
    assert len(needed) >= 6 and needed <= shipped, needed - shipped
