"""Each traffic mix's driver runs one short window on the CPU at the tiny
size, in float32, through the program's plain paths, and what its window
produced agrees with the plain reference; the run leaves no JAX module
loaded, and the reference loads nothing of the program."""

import subprocess
import sys

import pytest

from gpubench import common
from gpubench.tests.conftest import CACHED, tiny_spec

CELLS = [w["name"] for w in common.manifest()["workloads"]]


TRAIN = [w for w in CELLS if common.cell(w)["traffic"]["driver"] == "train"]
RUNS = [(w, {}) for w in CELLS] + [(w, CACHED) for w in TRAIN]


@pytest.mark.parametrize("workload,traffic", RUNS,
                         ids=[w + (".cached" if t else "") for w, t in RUNS])
def test_window_agrees_with_the_reference(cpu_run, workload, traffic):
    res = cpu_run(tiny_spec(workload, **traffic))
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    # float32 against float32: rounding alone
    assert all(v["value"] < 1e-3 for v in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in common.cell(workload)["end_to_end"]}
    assert not common.banned_modules()


def test_banned_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "owlvit_tpu_torch_like", sys)
    assert "owlvit_tpu" not in common.banned_modules()
    monkeypatch.setitem(sys.modules, "owlvit_tpu.ops", sys)
    assert common.banned_modules() == ["owlvit_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpubench.reference.owlvit, gpubench.reference.detect, "
            "gpubench.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'owlvit_tpu_torch', 'owlvit_tpu', 'jax', 'jaxlib', 'flax'}))") % str(common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip()
    assert out == "[]"


@pytest.mark.chip
def test_cells_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for w in CELLS:
        out = subprocess.run([sys.executable, str(common.HERE / "run.py"), "--workload", w,
                              "--seed", "3", "--seconds", "2", "--trace", "0"],
                             capture_output=True, text=True, timeout=1200, cwd=common.ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        assert '"correct": true' in out.stdout.splitlines()[-1]
