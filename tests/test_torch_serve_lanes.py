"""Port: DetectorServer's query-conditioned lane (zero-shot text queries,
one-shot exemplars, both in one batch), `bulk_detect` and the HTTP app, on
the CPU at `tiny` size, against the JAX DetectorServer on the same params
and images, against the port's own direct calls, and their guards.

Tolerances against the JAX server: classes and labels equal, boxes within
2e-5 * S pixels and scores within 2e-5 (fp32 summation order through two
layers, the heads and the sigmoid). Against the port's own direct call on
the server's padded query block: bit-equal (the same function on the same
inputs). Against `forward_zero_shot` / `forward_one_shot` (the whole query
set encoded as one batch, the server encodes strings one at a time):
rtol 1e-4, atol 1e-5.
"""

import asyncio
import io

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.serve import DetectorServer as JaxDetectorServer
from owlvit_tpu_torch.data.tokenizer import HashTokenizer
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.ops import nms as nms_ops
from owlvit_tpu_torch.ops.preprocess import normalize_image
from owlvit_tpu_torch.serve import DetectorServer, _flatten_bucket, make_app

TOP_K = 16


@pytest.fixture(scope="module")
def detector():
    jax_params = jax.tree.map(np.asarray, jowlvit.init(
        jax.random.PRNGKey(3), jax_get_config("tiny"), num_queries=12))
    cfg = get_config("tiny")
    model, _ = from_jax_tree(jax_params, cfg)
    return model, cfg, jax_params


def _tok(cfg):
    return HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)


def _jtok(cfg):
    return JaxHashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)


def _rand_images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8)


def _server(model, cfg, **kw):
    kw = {"top_k": TOP_K, "warmup": False, "device": "cpu", **kw}
    return DetectorServer(model, cfg, **kw)


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


def _requests(images, qimg):
    """Two overlapping query sets, one exemplar twice, then a text request
    and an image request side by side."""
    return [dict(queries=["a red box", "a cat", "a dog"]),
            dict(queries=["a cat", "a bird"]),
            dict(query_image=qimg),
            dict(query_image=qimg),
            dict(queries=["a bird"]),
            dict(query_image=images[0])]


def test_conditioned_lanes_match_jax_server(detector):
    """Zero-shot, one-shot and mixed batches, with bank requests beside
    them: the same results as the JAX server's, and the same batches."""
    model, cfg, jax_params = detector
    S = cfg.vision.image_size
    images = _rand_images(8, S, seed=11)
    qimg = _rand_images(1, S, seed=12)[0]
    reqs = _requests(images, qimg)
    kw = dict(buckets=(2, 4), max_delay_ms=50, top_k=TOP_K, warmup=False,
              autostart=False, max_queries=3, one_shot=True)

    def run(srv):
        futs = [srv.submit(images[2 + i], **r) for i, r in enumerate(reqs)]
        futs += [srv.submit(im) for im in images[:2]]  # bank requests
        srv.start()
        out = [f.result(timeout=120) for f in futs]
        return out, srv.stats()

    with JaxDetectorServer(jax_params, jax_get_config("tiny"), tokenizer=_jtok(cfg),
                           **kw) as jsrv:
        ref, jst = run(jsrv)
    with DetectorServer(model, cfg, tokenizer=_tok(cfg), device="cpu", **kw) as srv:
        got, st = run(srv)
        text_keys, exemplars = set(srv._text_cache), len(srv._qimg_cache)
    _against_jax(got, ref, S)
    assert all(len(g["scores"]) > 0 for g in got)
    for key in ("batches", "zs_batches", "bucket_counts", "padded_rows"):
        assert st[key] == jst[key], key
    # 6 conditioned requests -> one batch of 4 and one of 2; 2 bank -> one
    assert st["zs_batches"] == 2 and st["bucket_counts"] == {2: 2, 4: 1}
    assert text_keys == {"a red box", "a cat", "a dog", "a bird"}
    assert exemplars == 2


def test_conditioned_batch_equals_direct_call(detector):
    """A served conditioned batch is bit-equal to serve_batch_conditioned
    on the server's own padded query block, and close to forward_zero_shot
    / forward_one_shot + sigmoid + NMS."""
    model, cfg, _ = detector
    S = cfg.vision.image_size
    images = _rand_images(2, S, seed=13)
    qimg = _rand_images(1, S, seed=14)[0]
    queries = ["a widget", "a gadget"]
    srv = _server(model, cfg, buckets=(2,), max_delay_ms=50, autostart=False,
                  tokenizer=_tok(cfg), one_shot=True, max_queries=3)
    futs = [srv.submit(images[0], queries=queries), srv.submit(images[1], query_image=qimg)]
    srv.start()
    served = [f.result(timeout=120) for f in futs]
    st = srv.stats()
    srv.close()
    assert st["batches"] == 1 and st["zs_batches"] == 1  # one shared batch

    qemb = np.zeros((2, 3, cfg.projection_dim), np.float32)
    qmask = np.zeros((2, 3), np.int32)
    qemb[0, :2] = [srv._text_cache[q] for q in queries]
    qemb[1, 0] = next(iter(srv._qimg_cache.values()))
    qmask[0, :2] = qmask[1, 0] = 1
    flat = torch.from_numpy(_flatten_bucket(list(images), 2, S))
    packed = srv.serve_batch_conditioned(flat, torch.from_numpy(qemb),
                                         torch.from_numpy(qmask)).numpy()
    packed = packed.reshape(2, TOP_K, 7)
    _equal(served[0], srv._unpack_row(packed[0], (S, S), tuple(queries)))
    _equal(served[1], srv._unpack_row(packed[1], (S, S), None, one_shot=True))

    tok = _tok(cfg)
    enc = tok(queries)
    mcfg = srv.cfg
    with torch.inference_mode():
        px = normalize_image(torch.from_numpy(images))
        zb, zl = owlvit.forward_zero_shot(model, mcfg, px[:1],
                                          torch.from_numpy(enc["input_ids"]),
                                          torch.from_numpy(enc["attention_mask"]))
        ob, ol = owlvit.forward_one_shot(model, mcfg, px[1:],
                                         normalize_image(torch.from_numpy(qimg[None])))
        refs = [nms_ops.postprocess(b, torch.sigmoid(lg), top_k=TOP_K) for b, lg in
                ((zb, zl), (ob, ol))]
    for res, ref in zip(served, refs):
        keep = ref["valid"][0].numpy()
        np.testing.assert_allclose(res["boxes"] / S, ref["boxes"][0].numpy()[keep],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["scores"], ref["scores"][0].numpy()[keep],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(res["classes"], ref["classes"][0].numpy()[keep])
    assert served[0]["labels"] == [queries[c] for c in served[0]["classes"]]
    assert served[1]["labels"] == ["query-object"] * len(served[1]["classes"])


def test_conditioned_guards(detector):
    """The JAX server's refusals and messages."""
    model, cfg, _ = detector
    img = _rand_images(1, cfg.vision.image_size)[0]
    bank_only = _server(model, cfg, buckets=(1,), autostart=False)
    with pytest.raises(ValueError, match="tokenizer"):
        bank_only.submit(img, queries=["x"])
    with pytest.raises(ValueError, match="one_shot"):
        bank_only.submit(img, query_image=img)
    with pytest.raises(ValueError, match="tokenizer"):
        bank_only.bulk_detect([img], queries=["x"])
    assert bank_only.bulk_detect([]) == []
    srv = _server(model, cfg, buckets=(1,), autostart=False, tokenizer=_tok(cfg),
                  one_shot=True, max_queries=2)
    with pytest.raises(ValueError, match="queries"):
        srv.submit(img, queries=["a", "b", "c"])
    with pytest.raises(ValueError, match="queries"):
        srv.submit(img, queries=[])
    with pytest.raises(ValueError, match="not both"):
        srv.submit(img, queries=["x"], query_image=img)
    with pytest.raises(ValueError, match="query_image"):
        srv.submit(img, query_image=img[..., :2])
    with pytest.raises(ValueError, match="orig_whs"):
        srv.bulk_detect([img, img], orig_whs=[(1, 1)])
    bank_only.close()
    srv.close()


def test_caches_are_bounded_fifo(detector):
    """Distinct strings and exemplars beyond the cap evict the oldest."""
    model, cfg, _ = detector
    S = cfg.vision.image_size
    imgs = _rand_images(4, S, seed=15)
    srv = _server(model, cfg, buckets=(4,), max_delay_ms=1, tokenizer=_tok(cfg),
                  one_shot=True, max_queries=2)
    srv._cache_cap = 3
    for q in ["q0", "q1", "q2", "q3", "q4"]:
        srv.detect(imgs[0], queries=[q], timeout=120)
    for qi in imgs:
        srv.detect(imgs[0], query_image=qi, timeout=120)
    srv.close()
    assert list(srv._text_cache) == ["q2", "q3", "q4"]
    assert len(srv._qimg_cache) == 3


def test_bulk_detect_matches_online(detector):
    """bulk_detect's rows are bit-equal to the online server's for the same
    batches, on the bank lane and with job-shared queries, in input order;
    its stats count the job."""
    model, cfg, _ = detector
    S = cfg.vision.image_size
    images = list(_rand_images(5, S, seed=21))
    queries = ["a red box", "a striped circle"]
    srv = _server(model, cfg, buckets=(2,), max_delay_ms=50, autostart=False,
                  tokenizer=_tok(cfg), max_queries=3)
    futs = [srv.submit(im) for im in images] + [srv.submit(im, queries=queries)
                                                for im in images]
    srv.start()
    online = [f.result(timeout=120) for f in futs]
    bank = srv.bulk_detect(images)
    zs = srv.bulk_detect(images, queries=queries)
    st = srv.stats()
    srv.close()
    assert len(bank) == len(zs) == 5
    for a, b in zip(online, bank + zs):
        _equal(a, b)
    assert "labels" not in bank[0]
    assert st["bulk"]["jobs"] == 2 and st["bulk"]["images"] == 10
    assert st["bulk"]["batches"] == 6 and st["bulk"]["last_job_secs"] > 0
    # the bulk job encodes through the server's text cache
    assert set(srv._text_cache) == set(queries)


@pytest.mark.parametrize("queries", [None, ("thing", "other thing")])
def test_bulk_detect_matches_jax_bulk(detector, queries):
    model, cfg, jax_params = detector
    S = cfg.vision.image_size
    rng = np.random.default_rng(22)
    # two model-sized images and one that is resized on the host
    images = list(_rand_images(2, S, seed=22)) + [
        rng.integers(0, 255, (120, 200, 3), dtype=np.uint8)]
    kw = dict(buckets=(2,), top_k=TOP_K, warmup=False, autostart=False, max_queries=2)
    with JaxDetectorServer(jax_params, jax_get_config("tiny"), tokenizer=_jtok(cfg),
                           **kw) as jsrv:
        ref = jsrv.bulk_detect(images, queries=queries)
    with DetectorServer(model, cfg, tokenizer=_tok(cfg), device="cpu", **kw) as srv:
        got = srv.bulk_detect(images, queries=queries)
    _against_jax(got, ref, 200)
    assert got[2]["boxes"].size == 0 or got[2]["boxes"].max() > S  # original pixels


def test_bulk_detect_original_sizes(detector):
    """orig_whs rescales boxes to the sizes the caller decoded from."""
    model, cfg, _ = detector
    S = cfg.vision.image_size
    images = list(_rand_images(3, S, seed=23))
    whs = [(2 * S, S), (S, 3 * S), (S, S)]
    srv = _server(model, cfg, buckets=(2,), autostart=False)
    plain = srv.bulk_detect(images)
    scaled = srv.bulk_detect(images, orig_whs=whs)
    srv.close()
    for p, s, (w, h) in zip(plain, scaled, whs):
        np.testing.assert_allclose(s["boxes"], p["boxes"] / S * np.array([w, h, w, h]),
                                   rtol=1e-6, atol=1e-4)


def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_http_app(detector):
    """POST /detect on the three lanes (raw bytes, ?queries=, multipart
    image + query_image), GET /healthz and /stats, and the error codes: 400
    for an undecodable upload and for a refused request, 503 when the
    queue is full. Each answer agrees with the in-process call."""
    pytest.importorskip("aiohttp")
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    model, cfg, _ = detector
    S = cfg.vision.image_size
    img, qimg = _rand_images(2, S, seed=5)

    async def run(srv, bank_only):
        app = make_app(srv, labelmap={0: "thing"})
        async with TestClient(TestServer(app)) as client:
            out = {}
            r = await client.get("/healthz")
            assert (await r.json())["ok"]
            r = await client.post("/detect", data=_png(img))
            assert r.status == 200
            out["bank"] = (await r.json())["detections"]
            r = await client.post("/detect", data=b"not an image")
            assert r.status == 400
            r = await client.post("/detect?queries=a%20cat,a%20dog", data=_png(img))
            out["zs_status"] = r.status
            if r.status == 200:
                out["zs"] = (await r.json())["detections"]
            form = aiohttp.FormData()
            form.add_field("image", _png(img), filename="i.png", content_type="image/png")
            form.add_field("query_image", _png(qimg), filename="q.png",
                           content_type="image/png")
            r = await client.post("/detect", data=form)
            out["os_status"] = r.status
            if r.status == 200:
                out["os"] = (await r.json())["detections"]
            r = await client.get("/stats")
            out["stats"] = await r.json()
            return out

    with _server(model, cfg, buckets=(1,), max_delay_ms=1, tokenizer=_tok(cfg),
                 one_shot=True, max_queries=4) as srv:
        out = asyncio.run(run(srv, False))
        direct = [srv.detect(img, timeout=120),
                  srv.detect(img, queries=["a cat", "a dog"], timeout=120),
                  srv.detect(img, query_image=qimg, timeout=120)]
    assert out["zs_status"] == out["os_status"] == 200
    # batches are counted before their futures resolve (requests after)
    assert out["stats"]["batches"] == 3 and out["stats"]["zs_batches"] == 2
    for dets, ref, names in zip((out["bank"], out["zs"], out["os"]), direct,
                                ({0: "thing"}, {0: "a cat", 1: "a dog"},
                                 {0: "query-object"})):
        assert dets and len(dets) == len(ref["scores"])
        for d, b, s, c in zip(dets, ref["boxes"], ref["scores"], ref["classes"]):
            assert set(d) == {"box", "score", "class_id", "class_name"}
            assert d["class_id"] == c and d["class_name"] == names.get(int(c), str(c))
            np.testing.assert_allclose(d["box"], np.round(b, 2), atol=0.011)
            assert abs(d["score"] - s) <= 1e-4

    with _server(model, cfg, buckets=(1,), max_delay_ms=1) as srv:  # bank only
        out = asyncio.run(run(srv, True))
    assert out["zs_status"] == out["os_status"] == 400

    overloaded = _server(model, cfg, buckets=(1,), autostart=False, max_queue=0)

    async def shed():
        async with TestClient(TestServer(make_app(overloaded))) as client:
            r = await client.post("/detect", data=_png(img))
            return r.status, await r.json()

    status, body = asyncio.run(shed())
    overloaded.close()
    assert status == 503 and "max_queue" in body["error"]
