"""COCO annotations: category remapping and subset building.

Re-implements the reference's offline subset tool
(scripts/make_coco_subset.py) without the interactive
accept/reject loop (a --seed + optional min-count criterion replaces the
human): remap COCO's 90 sparse category ids to dense 0..79, sample train/test
images, write the same four json artifacts (train/test/counts/labelmap).

Annotation file format (identical to the reference's data/train.json):
    { "<coco_url_or_filename>": [ {"bbox": [x, y, w, h], "label": int}, ... ] }

The port's copy of owlvit_tpu/data/coco.py; tests/test_torch_data.py
holds it equal.
"""

from __future__ import annotations

import json
import os
import random
from collections import Counter, OrderedDict, defaultdict

# The 80 COCO-2014 class names in dense order. COCO's category ids are sparse
# (1..90 with gaps); the gap ids below are unused in the annotations.
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]
_UNUSED_SPARSE_IDS = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}


def sparse_to_dense() -> dict:
    """COCO sparse category id -> dense 0..79."""
    mapping = {}
    dense = 0
    for sparse in range(1, 91):
        if sparse in _UNUSED_SPARSE_IDS:
            continue
        mapping[sparse] = dense
        dense += 1
    assert dense == 80
    return mapping


def dense_labelmap() -> dict:
    """{dense_idx (int): class name} — reference's data/labelmap.json."""
    return dict(enumerate(COCO_CLASSES))


def build_subset(
    instances_file: str,
    out_dir: str,
    num_train: int = 2500,
    num_test: int = 100,
    seed: int = 0,
    min_class_count: int = 1,
    max_attempts: int = 50,
) -> dict:
    """Sample a train/test subset from a COCO instances json and write the
    reference-compatible artifacts to out_dir.

    The interactive accept? (y/n) loop is replaced by resampling until every
    class appears at least `min_class_count` times (or attempts exhaust).
    Returns {"counts": ..., "n_train": ..., "n_test": ...}.
    """
    with open(instances_file) as f:
        raw = json.load(f)

    remap = sparse_to_dense()
    per_image = defaultdict(list)
    for ann in raw["annotations"]:
        per_image[ann["image_id"]].append(
            {"bbox": ann["bbox"], "label": remap[ann["category_id"]]}
        )

    images = raw["images"]
    rng = random.Random(seed)
    names = dense_labelmap()

    for attempt in range(max_attempts):
        ids = [im["id"] for im in images]
        rng.shuffle(ids)
        train_ids = set(ids[:num_train])
        test_ids = set(ids[num_train : num_train + num_test])

        train, test, class_names = {}, {}, []
        for im in images:
            key = im.get("coco_url", im.get("file_name"))
            if im["id"] in train_ids:
                train[key] = per_image[im["id"]]
            elif im["id"] in test_ids:
                test[key] = per_image[im["id"]]
            else:
                continue
            class_names.extend(names[a["label"]] for a in per_image[im["id"]])

        counts = OrderedDict(Counter(class_names).most_common())
        missing = [n for n in names.values()
                   if counts.get(n, 0) < min_class_count]
        if not missing:
            break
    else:
        # exhausted max_attempts without full coverage — write the last
        # subset anyway (matches the reference's best-effort spirit) but
        # SAY SO: absent classes silently get max class weight downstream
        # and eval scores them 0
        import sys

        print(
            f"warning: subset covers {len(names) - len(missing)}/{len(names)}"
            f" classes after {max_attempts} attempts — below "
            f"min_class_count={min_class_count}: {', '.join(missing[:10])}"
            + ("..." if len(missing) > 10 else "")
            + ". Increase num_train or lower min_class_count.",
            file=sys.stderr, flush=True,
        )

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(out_dir, "test.json"), "w") as f:
        json.dump(test, f)
    with open(os.path.join(out_dir, "counts.json"), "w") as f:
        json.dump(counts, f)
    with open(os.path.join(out_dir, "labelmap.json"), "w") as f:
        json.dump({str(k): v for k, v in names.items()}, f)
    return {"counts": counts, "n_train": len(train), "n_test": len(test)}


def load_labelmap(path: str) -> dict:
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}
