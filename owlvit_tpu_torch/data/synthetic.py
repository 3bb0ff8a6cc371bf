"""Synthetic detection data: colored-shape scenes with exact boxes.

Stands in for COCO in this zero-egress environment: end-to-end training,
eval, and benchmarks run against generated scenes whose classes are
(shape x color) combinations a detector can genuinely learn. Files are
written in the reference's annotation format (see data/coco.py) so the same
pipeline consumes either source.

The port's copy of owlvit_tpu/data/synthetic.py; tests/test_torch_data.py
holds the files it writes byte-equal to the original's.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image, ImageDraw

_COLORS = [
    (220, 50, 50),
    (50, 180, 60),
    (50, 90, 220),
    (230, 200, 40),
    (160, 60, 200),
    (40, 200, 200),
]
_SHAPES = ["rectangle", "ellipse"]


def class_names(n_classes: int) -> list:
    names = []
    for s in _SHAPES:
        for c in range(len(_COLORS)):
            names.append(f"{s}_{c}")
    return names[:n_classes]


def generate(
    root: str,
    n_train: int = 64,
    n_test: int = 16,
    n_classes: int = 4,
    image_size: tuple = (640, 480),
    max_objects: int = 4,
    seed: int = 0,
) -> dict:
    """Write images + annotations under root; returns paths dict."""
    assert n_classes <= len(_COLORS) * len(_SHAPES)
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    def make_split(n: int, prefix: str) -> dict:
        ann = {}
        for i in range(n):
            W, H = image_size
            img = Image.new(
                "RGB", (W, H), tuple(int(v) for v in rng.integers(180, 256, 3))
            )
            draw = ImageDraw.Draw(img)
            boxes = []
            for _ in range(int(rng.integers(1, max_objects + 1))):
                cls = int(rng.integers(0, n_classes))
                shape = _SHAPES[cls // len(_COLORS)]
                color = _COLORS[cls % len(_COLORS)]
                w = int(rng.integers(W // 10, W // 3))
                h = int(rng.integers(H // 10, H // 3))
                x = int(rng.integers(0, W - w))
                y = int(rng.integers(0, H - h))
                if shape == "rectangle":
                    draw.rectangle([x, y, x + w, y + h], fill=color)
                else:
                    draw.ellipse([x, y, x + w, y + h], fill=color)
                boxes.append({"bbox": [x, y, w, h], "label": cls})
            fname = f"{prefix}_{i:05d}.png"
            img.save(os.path.join(img_dir, fname))
            ann[fname] = boxes
        return ann

    train = make_split(n_train, "train")
    test = make_split(n_test, "test")

    names = class_names(n_classes)
    paths = {
        "images_dir": img_dir,
        "train": os.path.join(root, "train.json"),
        "test": os.path.join(root, "test.json"),
        "labelmap": os.path.join(root, "labelmap.json"),
    }
    with open(paths["train"], "w") as f:
        json.dump(train, f)
    with open(paths["test"], "w") as f:
        json.dump(test, f)
    with open(paths["labelmap"], "w") as f:
        json.dump({str(i): n for i, n in enumerate(names)}, f)
    return paths
