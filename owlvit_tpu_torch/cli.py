"""Command-line interface of the port (counterpart of owlvit_tpu/cli.py).

    python -m owlvit_tpu_torch.cli train --config config.yaml [--device cuda|cpu]
    python -m owlvit_tpu_torch.cli eval --config config.yaml [--save-detections d.json] \
        [--from-export det.pt2 [--export-params det.pt2.npz]]
    python -m owlvit_tpu_torch.cli infer --config config.yaml --image img.png \
        [--queries "a cat" "a dog" | --query-image exemplar.png]
    python -m owlvit_tpu_torch.cli bulk-infer --config config.yaml \
        --input-dir imgs/ --out dets.json [--queries ...]
    python -m owlvit_tpu_torch.cli serve --config config.yaml --port 8750 [--one-shot]
    python -m owlvit_tpu_torch.cli make-synthetic --root /tmp/synth
    python -m owlvit_tpu_torch.cli make-coco-subset --config config.yaml
    python -m owlvit_tpu_torch.cli export --config config.yaml --out det.pt2 \
        [--batch-size 8] [--weightless] [--ema]
    python -m owlvit_tpu_torch.cli convert --model b32 --src <hf-name-or-dir> --out p.npz

train, eval, infer, bulk-infer, serve and export run on the card unless
--device cpu is given, and raise where there is no card. An exported
artifact (torch.export) calls the port's custom ops, so loading it needs
this package (train/export.py).
"""

from __future__ import annotations

import argparse
import json
import sys


def _trainer(args):
    from owlvit_tpu_torch.train import Trainer
    from owlvit_tpu_torch.utils.config import load_config

    return Trainer.from_config(load_config(args.config), workdir=args.workdir,
                               device=args.device)


def _build_tokenizer(cfg, mcfg, *, fallback: bool):
    """The one place commands build a text tokenizer: the CLIP BPE from
    `model.clip_vocab/clip_merges` when the assets exist; otherwise None
    (the caller disables free-text queries) or, with fallback=True, the
    deterministic HashTokenizer and a warning on stderr: its embeddings are
    meaningless for a real checkpoint."""
    from owlvit_tpu_torch.data.tokenizer import CLIPTokenizer, HashTokenizer

    if cfg.model.clip_vocab:
        return CLIPTokenizer(cfg.model.clip_vocab, cfg.model.clip_merges,
                             max_len=mcfg.text.max_len)
    if not fallback:
        return None
    print(
        "warning: model.clip_vocab is not set — free-text queries are "
        "encoded by the FALLBACK HashTokenizer, so the text embeddings "
        "(and the resulting detections) are meaningless for a real "
        "checkpoint. Fetch the CLIP BPE assets (scripts/fetch_assets.py) "
        "and set model.clip_vocab/clip_merges.", file=sys.stderr, flush=True,
    )
    return HashTokenizer(mcfg.text.vocab_size, max_len=mcfg.text.max_len)


def _cmd_train(args):
    metrics = _trainer(args).run()
    print(json.dumps({k: v for k, v in metrics.items()
                      if not hasattr(v, "shape")}, indent=2))


def _cmd_eval(args):
    trainer = _trainer(args)
    infer_fn = None
    if args.from_export:
        # eval through the loaded serving artifact: the same protocol, so
        # its mAP must reproduce the direct eval's
        from owlvit_tpu_torch.train.export import load_exported, load_exported_weightless

        if args.export_params:
            from owlvit_tpu_torch.models.convert import load_params

            infer_fn = load_exported_weightless(
                args.from_export, load_params(args.export_params), device=trainer.device)
        else:
            infer_fn = load_exported(args.from_export)
        print(f"eval through exported artifact: {args.from_export}", flush=True)
    metrics = trainer.evaluate(infer_fn=infer_fn, save_detections=args.save_detections)
    print(json.dumps({k: (v.tolist() if hasattr(v, "tolist") else v)
                      for k, v in metrics.items()}, indent=2))


def _cmd_infer(args):
    """Detect with the trained query bank, free-text queries (zero-shot) or
    a query image (one-shot), chosen by --queries / --query-image."""
    import numpy as np
    import torch
    from PIL import Image

    from owlvit_tpu_torch.models import owlvit
    from owlvit_tpu_torch.ops import nms as nms_ops
    from owlvit_tpu_torch.ops.preprocess import normalize_image
    from owlvit_tpu_torch.serve import ONE_SHOT_LABEL, _size_to_model
    from owlvit_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    trainer = _trainer(args)
    # inference only: every layer frozen, the fixed-shift softmax
    mcfg = trainer.model_cfg.replace(trainable_last_k=0, static_softmax=True)
    size = mcfg.vision.image_size
    model, dev = trainer.model, trainer.device

    def pixels(path):
        img = Image.open(path).convert("RGB")
        arr = _size_to_model(np.asarray(img), size)
        return img.size, normalize_image(torch.from_numpy(arr[None].copy()).to(dev))

    (w, h), px = pixels(args.image)
    with torch.inference_mode():
        if args.queries:  # zero-shot: free-text conditioning
            tok = _build_tokenizer(cfg, mcfg, fallback=True)
            enc = tok(args.queries)
            boxes, logits = owlvit.forward_zero_shot(
                model, mcfg, px, torch.from_numpy(enc["input_ids"]).to(dev),
                torch.from_numpy(enc["attention_mask"]).to(dev))
            sims = torch.sigmoid(logits)  # the HF decode protocol
            names = dict(enumerate(args.queries))
        elif args.query_image:  # one-shot: image conditioning
            _, qpx = pixels(args.query_image)
            boxes, logits = owlvit.forward_one_shot(model, mcfg, px, qpx)
            sims = torch.sigmoid(logits)
            names = {0: ONE_SHOT_LABEL}
        else:  # the trained query bank
            boxes, sims = owlvit.forward_train(model, mcfg, px)
            names = trainer.labelmap
        out = nms_ops.postprocess(
            boxes, sims, confidence_threshold=cfg.training.confidence_threshold,
            iou_threshold=cfg.training.iou_threshold, top_k=cfg.training.top_k)
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
    keep = out["valid"]
    rows = zip(out["boxes"][keep] * np.array([w, h, w, h]), out["classes"][keep],
               out["scores"][keep])
    for b, c, s in list(rows)[: args.top]:
        name = names.get(int(c), str(int(c)))
        print(f"{name:24s} {s:.3f}  [{b[0]:.1f}, {b[1]:.1f}, {b[2]:.1f}, {b[3]:.1f}]")


def _cmd_serve(args):
    """Serve detections over HTTP with dynamic request batching (serve.py)."""
    try:
        from aiohttp import web
    except ImportError:
        raise SystemExit("serve needs the aiohttp package, which is not "
                         "installed") from None

    from owlvit_tpu_torch.serve import DetectorServer, make_app
    from owlvit_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    trainer = _trainer(args)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    # no fallback: without the vocabulary the zero-shot lane is off rather
    # than served with meaningless embeddings
    tok = _build_tokenizer(cfg, trainer.model_cfg, fallback=False)
    server = DetectorServer(
        trainer.model, trainer.model_cfg, buckets=buckets,
        max_delay_ms=args.max_delay_ms,
        confidence_threshold=cfg.training.confidence_threshold,
        iou_threshold=cfg.training.iou_threshold,
        top_k=cfg.training.top_k, tokenizer=tok, one_shot=args.one_shot,
        device=trainer.device)
    print(f"serving {cfg.model.name} on {args.host}:{args.port} "
          f"buckets={buckets} max_delay_ms={args.max_delay_ms}", flush=True)
    try:
        web.run_app(make_app(server, trainer.labelmap),
                    host=args.host, port=args.port)
    finally:
        server.close()


def _decode_dir(paths, S: int):
    """Decode and resize every file to S x S: the native threaded decoder
    where it reads the file, PIL where it does not. -> (images, (w, h) per
    image, the paths kept, {name: error} of the files skipped)."""
    import numpy as np
    from PIL import Image

    from owlvit_tpu_torch import native
    from owlvit_tpu_torch.serve import _size_to_model

    def pil_one(p):
        with Image.open(p) as im:
            im = im.convert("RGB")
            return _size_to_model(np.asarray(im), S), im.size

    res = native.decode_resize_batch([str(p) for p in paths], S)
    images, whs, kept, failures = [], [], [], {}
    for i, p in enumerate(paths):
        try:
            if res is not None and bool(res[2][i]):
                img, wh = res[0][i], (int(res[1][i, 0]), int(res[1][i, 1]))
            else:
                img, wh = pil_one(p)  # a format the native decoder skips
        except Exception as e:  # noqa: BLE001 — per-file skip, the job survives
            failures[p.name] = f"{type(e).__name__}: {e}"
            continue
        images.append(img)
        whs.append(wh)
        kept.append(p)
    return images, whs, kept, failures


def _cmd_bulk_infer(args):
    """Offline detection over a directory of images through
    DetectorServer.bulk_detect; writes {filename: detections} JSON, and
    {filename: {"error": ...}} for files that could not be read."""
    import time
    from pathlib import Path

    import numpy as np

    from owlvit_tpu_torch.models import get_config
    from owlvit_tpu_torch.serve import DetectorServer
    from owlvit_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
    paths = sorted(p for p in Path(args.input_dir).iterdir()
                   if p.suffix.lower() in exts)
    if not paths:
        print(f"no images in {args.input_dir}", file=sys.stderr)
        return 1
    S = get_config(cfg.model.name).vision.image_size
    t0 = time.perf_counter()
    images, whs, paths, failures = _decode_dir(paths, S)
    if failures:
        print(f"warning: skipped {len(failures)} unreadable image(s): "
              + ", ".join(list(failures)[:5])
              + ("..." if len(failures) > 5 else ""),
              file=sys.stderr, flush=True)
    if not paths:
        print("no decodable images", file=sys.stderr)
        return 1

    trainer = _trainer(args)
    tok = (_build_tokenizer(cfg, trainer.model_cfg, fallback=True)
           if args.queries else None)
    srv = DetectorServer(
        trainer.model, trainer.model_cfg, buckets=(args.batch_size,),
        confidence_threshold=cfg.training.confidence_threshold,
        iou_threshold=cfg.training.iou_threshold, top_k=cfg.training.top_k,
        warmup=False, autostart=False, tokenizer=tok,
        max_queries=max(8, len(args.queries or ())), device=trainer.device)
    results = srv.bulk_detect(images, queries=args.queries, orig_whs=whs)
    wall = time.perf_counter() - t0
    names = (dict(enumerate(args.queries)) if args.queries
             else (trainer.labelmap or {}))
    out = {}
    for p, r in zip(paths, results):
        out[p.name] = {
            "boxes": np.round(r["boxes"], 2).tolist(),
            "scores": np.round(r["scores"], 4).tolist(),
            "classes": r["classes"].tolist(),
            "labels": [names.get(int(c), str(int(c))) for c in r["classes"]],
        }
    for name, err in failures.items():  # skipped files are reported, not lost
        out[name] = {"error": err}
    with open(args.out, "w") as f:
        json.dump(out, f)
    st = srv.stats()["bulk"]
    print(f"{len(paths)} images in {wall:.1f}s ({len(paths) / wall:.1f} img/s; "
          f"detection {st['last_job_secs']:.1f}s) -> {args.out}", flush=True)


def _cmd_make_synthetic(args):
    from owlvit_tpu_torch.data import synthetic

    paths = synthetic.generate(
        args.root, n_train=args.n_train, n_test=args.n_test,
        n_classes=args.n_classes, seed=args.seed,
    )
    print(json.dumps(paths, indent=2))


def _cmd_make_coco_subset(args):
    from owlvit_tpu_torch.data import coco
    from owlvit_tpu_torch.utils.config import load_config

    cfg = load_config(args.config).data
    out = coco.build_subset(
        cfg.annotations_file, args.out_dir,
        num_train=cfg.num_train_images, num_test=cfg.num_test_images,
        seed=args.seed,
    )
    print(json.dumps({"n_train": out["n_train"], "n_test": out["n_test"],
                      "counts": out["counts"]}, indent=2))


def _cmd_export(args):
    """Export the (optionally fine-tuned) detector as a serving artifact."""
    import torch

    from owlvit_tpu_torch.models.convert import save_params, to_jax_tree
    from owlvit_tpu_torch.train.export import (export_detector,
                                               export_detector_weightless, save_exported)

    trainer = _trainer(args)
    if args.ema:
        if trainer.ema is None:
            raise SystemExit(
                "--ema needs training.ema_decay set in the config (the EMA "
                "tree is restored from the checkpoint next to the trainer state)")
        with torch.no_grad():  # the EMA into the trainable parameters
            for p, e in zip(trainer.params, trainer.ema):
                p.copy_(e)
    model, mcfg = trainer.model, trainer.model_cfg
    if args.weightless:
        blob = export_detector_weightless(model, mcfg, batch_size=args.batch_size)
        # the artifact is graph-only: the current (fine-tuned) weights go
        # beside it, since binding a stale npz would serve other weights
        save_params(args.out + ".npz", to_jax_tree(model))
        print(f"wrote {args.out}.npz (weights for load_exported_weightless)")
    else:
        blob = export_detector(model, mcfg, batch_size=args.batch_size)
    save_exported(args.out, blob)
    print(f"wrote {args.out} ({len(blob)} bytes)")


def _cmd_convert(args):
    """Offline HF -> npz conversion (transformers is needed here only)."""
    from transformers import OwlViTForObjectDetection

    from owlvit_tpu_torch.models import get_config
    from owlvit_tpu_torch.models.convert import convert_state_dict, save_params

    model = OwlViTForObjectDetection.from_pretrained(args.src)
    params = convert_state_dict(dict(model.state_dict()), get_config(args.model))
    save_params(args.out, params)
    print(f"wrote {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="owlvit_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", required=True)
        sp.add_argument("--workdir", default=".")
        sp.add_argument("--device", default="cuda", help="cuda (the default) or cpu")

    for name, fn in [("train", _cmd_train), ("eval", _cmd_eval)]:
        sp = sub.add_parser(name)
        common(sp)
        if name == "eval":
            sp.add_argument("--from-export", default=None,
                            help="serving artifact: eval through it (its "
                                 "batch size must be the eval batch size)")
            sp.add_argument("--export-params", default=None,
                            help="npz for a --weightless artifact")
            sp.add_argument("--save-detections", default=None,
                            help="write COCO-results-style JSON of every "
                                 "kept detection (external re-scoring)")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("infer")
    common(sp)
    sp.add_argument("--image", required=True)
    sp.add_argument("--top", type=int, default=10)
    sp.add_argument("--queries", nargs="+", default=None,
                    help="free-text queries -> zero-shot detection")
    sp.add_argument("--query-image", default=None,
                    help="exemplar image -> one-shot detection")
    sp.set_defaults(fn=_cmd_infer)

    sp = sub.add_parser("bulk-infer")
    common(sp)
    sp.add_argument("--input-dir", required=True)
    sp.add_argument("--out", required=True,
                    help="output JSON: {filename: boxes/scores/classes/labels}")
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--queries", nargs="+", default=None,
                    help="job-shared free-text queries (zero-shot)")
    sp.set_defaults(fn=_cmd_bulk_infer)

    sp = sub.add_parser("serve")
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8750)
    sp.add_argument("--buckets", default="1,8,32",
                    help="comma-separated batch sizes")
    sp.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="batching window for the first request of a batch")
    sp.add_argument("--one-shot", action="store_true",
                    help="accept multipart query_image uploads (one-shot)")
    sp.set_defaults(fn=_cmd_serve)

    sp = sub.add_parser("make-synthetic")
    sp.add_argument("--root", required=True)
    sp.add_argument("--n-train", type=int, default=64)
    sp.add_argument("--n-test", type=int, default=16)
    sp.add_argument("--n-classes", type=int, default=4)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=_cmd_make_synthetic)

    sp = sub.add_parser("make-coco-subset")
    sp.add_argument("--config", required=True)
    sp.add_argument("--out-dir", default="data")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=_cmd_make_coco_subset)

    sp = sub.add_parser("export")
    common(sp)
    sp.add_argument("--out", required=True)
    sp.add_argument("--batch-size", type=int, default=1)
    sp.add_argument("--weightless", action="store_true",
                    help="export the graph only; bind weights at load time")
    sp.add_argument("--ema", action="store_true",
                    help="export the EMA weights (training.ema_decay)")
    sp.set_defaults(fn=_cmd_export)

    sp = sub.add_parser("convert")
    sp.add_argument("--model", default="b32")
    sp.add_argument("--src", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=_cmd_convert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
