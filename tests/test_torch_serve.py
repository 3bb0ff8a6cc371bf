"""Port: DetectorServer on CPU at `tiny` size — against the JAX server on the
same params and images, against a direct forward, and its batching,
admission and shutdown behaviour."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.serve import DetectorServer as JaxDetectorServer
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.ops import nms as nms_ops
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.serve import DetectorServer, ServerOverloaded

N_CLASSES = 4


@pytest.fixture(scope="module")
def detector():
    jax_params = jax.tree.map(np.asarray, jowlvit.init(
        jax.random.PRNGKey(3), jax_get_config("tiny"), num_queries=3 * N_CLASSES))
    cfg = get_config("tiny")
    model, _ = from_jax_tree(jax_params, cfg)
    return model, cfg, jax_params


def _rand_images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8)


def _direct(model, cfg, images, top_k=16):
    with torch.inference_mode():
        boxes, sims = owlvit.forward_train(
            model, cfg.replace(trainable_last_k=0, static_softmax=True),
            normalize_image(torch.tensor(images)))
        out = nms_ops.postprocess(boxes, sims, confidence_threshold=0.01,
                                  iou_threshold=0.6, top_k=top_k)
    return {k: v.numpy() for k, v in out.items()}


def test_matches_jax_server(detector):
    model, cfg, jax_params = detector
    S = cfg.vision.image_size
    images = _rand_images(3, S, seed=5)
    kw = dict(buckets=(4,), max_delay_ms=50, top_k=16, warmup=False)
    with JaxDetectorServer(jax_params, jax_get_config("tiny"), **kw) as jsrv:
        ref = [f.result(timeout=120) for f in [jsrv.submit(im) for im in images]]
    with DetectorServer(model, cfg, **kw) as srv:
        got = [f.result(timeout=120) for f in [srv.submit(im) for im in images]]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g["classes"], r["classes"])
        np.testing.assert_allclose(g["boxes"], r["boxes"], rtol=0, atol=S * 2e-5)
        np.testing.assert_allclose(g["scores"], r["scores"], rtol=0, atol=2e-5)
        assert len(g["scores"]) > 0


def test_padded_batch_matches_direct(detector):
    """A padded partial batch returns the detections of a direct
    exact-shape forward: pad rows are per-image independent."""
    model, cfg, _ = detector
    S = cfg.vision.image_size
    images = _rand_images(3, S)
    ref = _direct(model, cfg, images)
    with DetectorServer(model, cfg, buckets=(8,), max_delay_ms=50, top_k=16,
                        warmup=False) as srv:
        results = [f.result(timeout=120) for f in [srv.submit(im) for im in images]]
    for i, res in enumerate(results):
        keep = ref["valid"][i]
        np.testing.assert_allclose(res["boxes"] / S, ref["boxes"][i][keep],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["scores"], ref["scores"][i][keep],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res["classes"], ref["classes"][i][keep])


def test_bucket_selection_and_stats(detector):
    """Requests queued before start drain as one batch into the smallest
    bucket that fits; stats record the padding."""
    model, cfg, _ = detector
    srv = DetectorServer(model, cfg, buckets=(2, 4, 8), max_delay_ms=20,
                         top_k=8, warmup=False, autostart=False)
    futs = [srv.submit(im) for im in _rand_images(3, cfg.vision.image_size, seed=1)]
    srv.start()
    for f in futs:
        f.result(timeout=120)
    st = srv.stats()
    srv.close()
    assert st["requests"] == 3
    assert st["batches"] == 1
    assert st["bucket_counts"] == {2: 0, 4: 1, 8: 0}
    assert st["padded_rows"] == 1
    assert st["latency_ms"]["n"] == 3


def test_backlog_splits_into_full_batches(detector):
    """9 queued requests over buckets (1, 8): one batch of 8, one of 1."""
    model, cfg, _ = detector
    srv = DetectorServer(model, cfg, buckets=(1, 8), top_k=8, warmup=False,
                         autostart=False)
    futs = [srv.submit(im) for im in _rand_images(9, cfg.vision.image_size, seed=2)]
    srv.start()
    for f in futs:
        f.result(timeout=120)
    st = srv.stats()
    srv.close()
    assert st["bucket_counts"] == {1: 1, 8: 1} and st["padded_rows"] == 0


def test_single_request_flushes_after_delay(detector):
    model, cfg, _ = detector
    with DetectorServer(model, cfg, buckets=(4,), max_delay_ms=10, top_k=8,
                        warmup=True) as srv:
        t0 = time.perf_counter()
        srv.detect(_rand_images(1, cfg.vision.image_size, seed=2)[0], timeout=120)
        elapsed = time.perf_counter() - t0
    assert elapsed < 30  # generous: a full batch of 4 never arrives


def test_client_resolution_rescale(detector):
    """A non-model-size image is resized for the model, and boxes come back
    in the original image's pixels."""
    from PIL import Image

    model, cfg, _ = detector
    S = cfg.vision.image_size
    w, h = 200, 120
    img = np.random.default_rng(4).integers(0, 255, (h, w, 3), dtype=np.uint8)
    with DetectorServer(model, cfg, buckets=(1,), max_delay_ms=1, top_k=8,
                        warmup=False) as srv:
        res = srv.detect(img, timeout=120)
    resized = np.asarray(Image.fromarray(img).resize((S, S), Image.BICUBIC))
    ref = _direct(model, cfg, resized[None], top_k=8)
    keep = ref["valid"][0]
    np.testing.assert_allclose(
        res["boxes"], ref["boxes"][0][keep] * np.array([w, h, w, h], np.float32),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(res["classes"], ref["classes"][0][keep])


def test_overload_and_bad_input(detector):
    model, cfg, _ = detector
    S = cfg.vision.image_size
    srv = DetectorServer(model, cfg, buckets=(1,), warmup=False, autostart=False,
                         max_queue=2)
    imgs = _rand_images(3, S, seed=6)
    with pytest.raises(ValueError):
        srv.submit(imgs[0][..., :2])
    srv.submit(imgs[0])
    srv.submit(imgs[1])
    with pytest.raises(ServerOverloaded):
        srv.submit(imgs[2])
    srv.close()


def test_close_fails_waiting_requests(detector):
    """A server closed before it ran fails its queued futures, and refuses
    submissions after close."""
    model, cfg, _ = detector
    srv = DetectorServer(model, cfg, buckets=(1,), warmup=False, autostart=False)
    fut = srv.submit(_rand_images(1, cfg.vision.image_size)[0])
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_rand_images(1, cfg.vision.image_size)[0])


def test_cancelled_request_does_not_stop_the_server(detector):
    """A client that cancels its future before it is served must not take
    the worker threads down: later requests are still answered."""
    model, cfg, _ = detector
    imgs = _rand_images(3, cfg.vision.image_size, seed=8)
    srv = DetectorServer(model, cfg, buckets=(4,), top_k=4, warmup=False,
                         autostart=False)
    gone = srv.submit(imgs[0])
    kept = srv.submit(imgs[1])
    assert gone.cancel()
    srv.start()
    assert "boxes" in kept.result(timeout=120)
    assert "boxes" in srv.detect(imgs[2], timeout=120)
    srv.close()


def test_submit_racing_close_never_hangs(detector):
    """Submitters racing close(): every accepted request's future resolves
    (with a result), none is stranded behind the stop sentinel."""
    import sys

    model, cfg, _ = detector
    img = _rand_images(1, cfg.vision.image_size, seed=7)[0]
    srv = DetectorServer(model, cfg, buckets=(1, 4), max_delay_ms=1, top_k=4,
                         warmup=False)
    accepted, lock = [], threading.Lock()

    def submitter():
        while True:
            try:
                f = srv.submit(img)
            except RuntimeError:
                return
            with lock:
                accepted.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter) for _ in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        srv.close()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert accepted
    for f in accepted:
        assert "boxes" in f.result(timeout=30)
