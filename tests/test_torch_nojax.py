"""Port: owlvit_tpu_torch runs with jax impossible to import (the machine
with the card has no JAX), and never touches the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.serve import DetectorServer

cfg = get_config("tiny")
model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=12)
img = np.random.default_rng(0).integers(0, 255, (96, 96, 3), dtype=np.uint8)
with DetectorServer(model, cfg, buckets=(1,), top_k=8) as srv:
    res = srv.detect(img, timeout=120)
assert res["boxes"].shape[1] == 4 and np.isfinite(res["boxes"]).all()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
assert not leaked, leaked
print("ok", len(res["scores"]))
"""


def test_port_serves_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CODE], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
