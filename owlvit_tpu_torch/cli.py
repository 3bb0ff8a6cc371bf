"""Command-line interface of the port (counterpart of owlvit_tpu/cli.py).

    python -m owlvit_tpu_torch.cli train --config config.yaml [--device cuda|cpu]
    python -m owlvit_tpu_torch.cli eval --config config.yaml [--save-detections d.json]
    python -m owlvit_tpu_torch.cli make-synthetic --root /tmp/synth
    python -m owlvit_tpu_torch.cli make-coco-subset --config config.yaml

train and eval run on the card unless --device cpu is given, and raise
where there is no card. infer, bulk-infer, serve, export and convert are not
ported yet: use the JAX package's CLI for them.
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


def _cmd_train(args):
    metrics = _trainer(args).run()
    print(json.dumps({k: v for k, v in metrics.items()
                      if not hasattr(v, "shape")}, indent=2))


def _cmd_eval(args):
    metrics = _trainer(args).evaluate(save_detections=args.save_detections)
    print(json.dumps({k: (v.tolist() if hasattr(v, "tolist") else v)
                      for k, v in metrics.items()}, indent=2))


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


def main(argv=None):
    p = argparse.ArgumentParser(prog="owlvit_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    for name, fn in [("train", _cmd_train), ("eval", _cmd_eval)]:
        sp = sub.add_parser(name)
        sp.add_argument("--config", required=True)
        sp.add_argument("--workdir", default=".")
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
        if name == "eval":
            sp.add_argument("--save-detections", default=None,
                            help="write COCO-results-style JSON of every "
                                 "kept detection (external re-scoring)")
        sp.set_defaults(fn=fn)

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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
