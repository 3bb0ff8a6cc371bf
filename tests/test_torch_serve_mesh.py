"""Port: DetectorServer(mesh=) on the CPU at `tiny` size — against the JAX
server on a 4-device data mesh (the conftest's virtual CPU devices), against
the port's own direct calls on each shard and against its single-device
server; bulk_detect on the mesh, a failing shard, and the guards.

Tolerances against the JAX server, as tests/test_torch_serve.py: classes
and labels equal, boxes within 2e-5 * S pixels and scores within 2e-5 (fp32
summation order). Against a direct `serve_batch` of the shard's own rows:
bit-equal (the same function on the same inputs). Against the unsharded
server: rtol 1e-5, atol 1e-6 (a shard of b/n rows may sum in another order
than a batch of b).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from owlvit_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.serve import DetectorServer as JaxDetectorServer
from owlvit_tpu_torch.data.tokenizer import HashTokenizer
from owlvit_tpu_torch.models import get_config
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.serve import DetectorServer, _flatten_bucket

TOP_K = 16
CPU4 = ("cpu",) * 4


@pytest.fixture(scope="module")
def detector():
    jax_params = jax.tree.map(np.asarray, jowlvit.init(
        jax.random.PRNGKey(3), jax_get_config("tiny"), num_queries=12))
    cfg = get_config("tiny")
    model, _ = from_jax_tree(jax_params, cfg)
    return model, cfg, jax_params


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:4]), ("data",))


def _rand_images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8)


def _served(srv, images, **kw):
    futs = [srv.submit(im, **kw) for im in images]
    srv.start()
    return [f.result(timeout=120) for f in futs]


def _against_jax(got, ref, S):
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g["classes"], r["classes"])
        assert g.get("labels") == r.get("labels")
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=S * 2e-5)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=2e-5)


def _equal(a, b):
    for key in ("boxes", "scores", "classes"):
        np.testing.assert_array_equal(a[key], b[key])
    assert a.get("labels") == b.get("labels")


def test_mesh_matches_jax_mesh_server(detector):
    """Buckets (4,), 3 images and one pad row over 4 devices, as the JAX
    package's own mesh test serves them."""
    model, cfg, jax_params = detector
    S = cfg.vision.image_size
    images = _rand_images(3, S, seed=41)
    kw = dict(buckets=(4,), max_delay_ms=50, top_k=TOP_K, warmup=False, autostart=False)
    with JaxDetectorServer(jax_params, jax_get_config("tiny"), mesh=_jax_mesh(), **kw) as jsrv:
        ref = _served(jsrv, images)
    with DetectorServer(model, cfg, mesh=CPU4, **kw) as srv:
        got = _served(srv, images)
        st = srv.stats()
    _against_jax(got, ref, S)
    assert all(len(g["scores"]) > 0 for g in got)
    assert st["batches"] == 1 and st["bucket_counts"] == {4: 1} and st["padded_rows"] == 1


def test_mesh_rows_equal_each_shard_and_single_device(detector):
    """Each served row is bit-equal to a direct serve_batch of its own
    shard's rows; the rows are close to the unsharded server's."""
    model, cfg, _ = detector
    S = cfg.vision.image_size
    images = _rand_images(7, S, seed=42)  # one batch of 4 (no pad), one of 3 + 1
    kw = dict(buckets=(4,), max_delay_ms=50, top_k=TOP_K, warmup=False, autostart=False)
    with DetectorServer(model, cfg, mesh=("cpu", "cpu"), **kw) as srv:
        served = _served(srv, images)
        assert srv.stats()["bucket_counts"] == {4: 2}
        for lo in (0, 4):
            flat = torch.from_numpy(_flatten_bucket(list(images[lo:lo + 4]), 4, S))
            for shard in (slice(0, 2), slice(2, 4)):
                packed = srv.serve_batch(flat[shard]).numpy().reshape(2, TOP_K, 7)
                for i, row in zip(range(shard.start, shard.stop), packed):
                    if lo + i < len(images):
                        _equal(served[lo + i], srv._unpack_row(row, (S, S)))
    with DetectorServer(model, cfg, device="cpu", **kw) as one:
        ref = _served(one, images)
    for g, r in zip(served, ref, strict=True):
        np.testing.assert_array_equal(g["classes"], r["classes"])
        np.testing.assert_allclose(g["boxes"] / S, r["boxes"] / S, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=1e-5, atol=1e-6)


def test_mesh_of_one_equals_single_device(detector):
    """mesh=(device,) is the unsharded server, row for row, bit for bit."""
    model, cfg, _ = detector
    images = _rand_images(9, cfg.vision.image_size, seed=43)
    kw = dict(buckets=(1, 8), top_k=TOP_K, warmup=False, autostart=False)
    with DetectorServer(model, cfg, mesh=("cpu",), **kw) as srv:
        got = _served(srv, images)
    with DetectorServer(model, cfg, device="cpu", **kw) as one:
        ref = _served(one, images)
    for g, r in zip(got, ref, strict=True):
        _equal(g, r)


def test_mesh_conditioned_lane_matches_jax_mesh_server(detector):
    """Zero-shot and one-shot requests in one sharded batch, and a bank
    request beside them: the JAX mesh server's results and batches."""
    model, cfg, jax_params = detector
    S = cfg.vision.image_size
    images = _rand_images(6, S, seed=44)
    qimg = _rand_images(1, S, seed=45)[0]
    reqs = [dict(queries=["a red box", "a cat"]), dict(query_image=qimg),
            dict(queries=["a bird"]), dict(query_image=images[5]), dict(queries=["a cat"])]
    kw = dict(buckets=(4,), max_delay_ms=50, top_k=TOP_K, warmup=False, autostart=False,
              max_queries=2, one_shot=True)

    def run(srv):
        futs = [srv.submit(images[i], **r) for i, r in enumerate(reqs)]
        futs.append(srv.submit(images[5]))
        srv.start()
        return [f.result(timeout=120) for f in futs], srv.stats()

    jtok = JaxHashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)
    with JaxDetectorServer(jax_params, jax_get_config("tiny"), tokenizer=jtok,
                           mesh=_jax_mesh(), **kw) as jsrv:
        ref, jst = run(jsrv)
    tok = HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)
    with DetectorServer(model, cfg, tokenizer=tok, mesh=CPU4, **kw) as srv:
        got, st = run(srv)
    _against_jax(got, ref, S)
    for key in ("batches", "zs_batches", "bucket_counts", "padded_rows"):
        assert st[key] == jst[key], key
    assert st["zs_batches"] == 2 and st["bucket_counts"] == {4: 3}


def test_mesh_bulk_detect_equals_online(detector):
    """bulk_detect on the mesh (bank and job-shared queries) is bit-equal to
    the mesh server's online rows for the same batches."""
    model, cfg, _ = detector
    images = list(_rand_images(6, cfg.vision.image_size, seed=46))
    queries = ["a red box", "a striped circle"]
    tok = HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)
    with DetectorServer(model, cfg, buckets=(4,), max_delay_ms=50, top_k=TOP_K,
                        warmup=False, autostart=False, tokenizer=tok, max_queries=2,
                        mesh=("cpu", "cpu")) as srv:
        futs = ([srv.submit(im) for im in images]
                + [srv.submit(im, queries=queries) for im in images])
        srv.start()
        online = [f.result(timeout=120) for f in futs]
        bulk = srv.bulk_detect(images) + srv.bulk_detect(images, queries=queries)
        st = srv.stats()
    for a, b in zip(online, bulk, strict=True):
        _equal(a, b)
    assert st["bulk"]["jobs"] == 2 and st["bulk"]["batches"] == 4


def test_mesh_failing_shard_fails_its_batch(detector, monkeypatch):
    """A shard that raises fails every future of its batch: no shard falls
    back to another device's replica, and the server goes on serving."""
    model, cfg, _ = detector
    images = _rand_images(4, cfg.vision.image_size, seed=47)
    srv = DetectorServer(model, cfg, buckets=(2,), top_k=TOP_K, warmup=False,
                         autostart=False, mesh=("cpu", "cpu"))
    real, calls = srv.serve_batch, []

    def flaky(flat):
        calls.append(flat.shape[0])
        if len(calls) == 2:  # the first batch's second shard
            raise RuntimeError("shard fault")
        return real(flat)

    monkeypatch.setattr(srv, "serve_batch", flaky)
    futs = [srv.submit(im) for im in images]
    srv.start()
    for f in futs[:2]:
        with pytest.raises(RuntimeError, match="shard fault"):
            f.result(timeout=120)
    assert all(len(f.result(timeout=120)["scores"]) >= 0 for f in futs[2:])
    srv.close()
    assert calls == [1, 1, 1, 1]


def test_mesh_guards(detector):
    """A bucket that is not a multiple of the axis, a device that is not
    mesh[0], an empty mesh, and a shard on a device with no replica."""
    model, cfg, _ = detector
    kw = dict(warmup=False, autostart=False)
    with pytest.raises(ValueError, match="divide"):
        DetectorServer(model, cfg, buckets=(2, 3), mesh=CPU4[:2], **kw)
    with pytest.raises(ValueError, match="mesh"):
        DetectorServer(model, cfg, buckets=(2,), mesh=("cpu", "cpu"), device="meta", **kw)
    with pytest.raises(ValueError, match="at least one"):
        DetectorServer(model, cfg, buckets=(2,), mesh=(), **kw)
    srv = DetectorServer(model, cfg, buckets=(2,), mesh=("cpu", "cpu"), device="cpu", **kw)
    assert srv.device == torch.device("cpu") and srv.mesh == (torch.device("cpu"),) * 2
    flat = torch.zeros((1, 3 * cfg.vision.image_size ** 2), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no model replica"):
        srv.serve_batch(flat)
    srv.close()
