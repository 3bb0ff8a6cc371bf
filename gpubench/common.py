"""What every cell of the benchmark shares: the manifest and its data files,
seeds, the weights, images and ground truth made from a seed, the device's
description, and the checks of a run's process.

Nothing here imports the program; the drivers do.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level modules a run may not hold once its window has closed
BANNED_MODULES = ("jax", "jaxlib", "flax", "owlvit_tpu")

# tags that keep the seeded streams of one run apart
TAG_WEIGHTS, TAG_IMAGE, TAG_GT, TAG_ORDER, TAG_SAMPLE = range(5)
TAG_CLASSW = 6


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload `name` with its configuration, traffic and limits
    resolved from their own files, in the checkout at `root`."""
    m = manifest(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    bench = root / HERE.name
    return {
        "name": name,
        "chips": w["chips"],
        "config_name": w["config"],
        "config": load_json(root / conf["file"]),
        "traffic_name": w["traffic"],
        "traffic": load_json(bench / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(bench / "limits" / f"{name}.json"),
        "end_to_end": [e for e in m["end_to_end"] if name in e.get("workloads", [name])],
        "per_layer": [p for p in m["per_layer"] if name in p.get("workloads", [name])],
    }


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed (any
    whole number) and the stream's tags."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *map(int, tags)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, *tags))


# ------------------------------------------------------------------ weights

def reference(c: dict):
    """The plain reference module that the configuration file `c` names
    under "reference" (gpubench/reference/<name>.py; owlvit where it names
    none). It exports its model class `Model` and `leaves(c)`, the
    (name, shape, init) of every parameter the benchmark draws for it."""
    return importlib.import_module(f"gpubench.reference.{c.get('reference', 'owlvit')}")


def make_weights(c: dict, seed: int, device) -> dict:
    """Every parameter of the configuration's reference leaves, fp32 (the
    master type the port keeps), drawn on `device` from the seed in one call
    and scaled leaf by leaf, in the leaves' order. The same seed and device
    give the same weights."""
    leaves = reference(c).leaves(c)
    total = sum(math.prod(s) for _, s, _ in leaves)
    g = torch.Generator(device=device).manual_seed(subseed(seed, TAG_WEIGHTS))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, (kind, std) in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape).mul(std)
        out[name] = t.add_(1.0) if kind == "one" else t
        at += n
    return out


# ------------------------------------------------------------------ inputs

def host_images(seed: int, rows, S: int) -> np.ndarray:
    """uint8 [len(rows), S, S, 3]: image r of the run drawn from (seed, r)
    on the host."""
    return np.stack([rng(seed, TAG_IMAGE, r).integers(0, 256, (S, S, 3), dtype=np.uint8)
                     for r in rows])


def device_images(seed: int, rows, S: int, device) -> torch.Tensor:
    """uint8 [len(rows), S, S, 3] on `device`: image r drawn there from
    (seed, r) (another stream than host_images')."""
    out = torch.empty((len(rows), S, S, 3), dtype=torch.uint8, device=device)
    g = torch.Generator(device=device)
    for i, r in enumerate(rows):
        g.manual_seed(subseed(seed, TAG_IMAGE, int(r), 1))
        out[i].random_(0, 256, generator=g)
    return out


def ground_truth(seed: int, rows, t: dict) -> dict:
    """The boxes of image r: boxes_min..boxes_max valid slots of max_gt,
    centres in [0.1, 0.9], sides in [0.05, 0.4], xyxy clipped to [0, 1],
    labels uniform over n_classes."""
    G, C = t["max_gt"], t["n_classes"]
    n = len(rows)
    labels = np.zeros((n, G), np.int32)
    boxes = np.zeros((n, G, 4), np.float32)
    mask = np.zeros((n, G), bool)
    for i, r in enumerate(rows):
        g = rng(seed, TAG_GT, r)
        k = int(g.integers(t["boxes_min"], t["boxes_max"] + 1))
        c, wh = g.uniform(0.1, 0.9, (k, 2)), g.uniform(0.05, 0.4, (k, 2))
        boxes[i, :k] = np.clip(np.concatenate([c - wh / 2, c + wh / 2], 1), 0, 1)
        labels[i, :k] = g.integers(0, C, k)
        mask[i, :k] = True
    return {"labels": labels, "boxes": boxes, "gt_mask": mask}


def class_weights(seed: int, n_classes: int) -> np.ndarray:
    """Per-class BCE weights in [0.5, 1.5], as a train set's class scales."""
    return rng(seed, TAG_CLASSW).uniform(0.5, 1.5, n_classes).astype(np.float32)


# ------------------------------------------------------------------ the run

def say(*parts) -> None:
    """A line on standard error (the run's log)."""
    print(*parts, file=sys.stderr, flush=True)


def require_devices(chips: int) -> None:
    """Exit with 3 and no result where the cell's cards are not there."""
    if not torch.cuda.is_available():
        say("gpubench: torch.cuda.is_available() is false: this benchmark runs on the card")
        sys.exit(3)
    if torch.cuda.device_count() < chips:
        say(f"gpubench: the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
        sys.exit(3)


def banned_modules() -> list:
    """Top-level names in sys.modules that a run may not load, compared
    whole (owlvit_tpu_torch is not owlvit_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only the first run of a cell there builds and compiles."""
    base = ROOT / ".gpubench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
