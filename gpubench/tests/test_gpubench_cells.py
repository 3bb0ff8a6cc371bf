"""Each traffic mix's driver runs one short window on the CPU at the tiny
size, in float32, through the program's plain paths, and what its window
produced agrees with the plain reference; the run leaves no JAX module
loaded, and the reference loads nothing of the program."""

import json
import shutil
import subprocess
import sys

import pytest

from gpubench import common
from gpubench.tests.conftest import TINY, shared_driver, tiny_spec

CELLS = [w["name"] for w in common.manifest()["workloads"]]
# the training driver's activation pool, which no cell of the manifest runs
# yet: the cached fine-tune is a mix of its own once its cell holds
CACHED = dict(cached=True, pool_rows=40)
TRAIN = [w for w in CELLS if common.cell(w)["traffic"]["driver"] == "train"]
RUNS = [(w, {}) for w in CELLS] + [(w, CACHED) for w in TRAIN]


def _agrees(res: dict, spec: dict) -> None:
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    # float32 against float32: rounding alone
    assert all(v["value"] < 1e-3 for v in res["checks"].values()), res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert not common.banned_modules()


@pytest.mark.parametrize("workload,traffic", RUNS,
                         ids=[w + (".cached" if t else "") for w, t in RUNS])
def test_window_agrees_with_the_reference(cpu_run, workload, traffic):
    shared_driver(workload)
    spec = tiny_spec(workload, **traffic)
    _agrees(cpu_run(spec), spec)


def test_a_cell_enters_as_files_alone(cpu_run, tmp_path):
    """A configuration and a mix that no code names, written as a later
    change would write them (their files, their tiny counterparts, the
    manifest's entries), run the window's comparison with no edit of the
    harness."""
    here, m = common.HERE, common.manifest()
    bench = tmp_path / "gpubench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    conf = next(c for c in m["configs"] if c["name"] == "owlvit-l14")
    cell = next(w for w in m["workloads"] if w["name"] == "l14.train.uncached")
    shutil.copy(common.ROOT / conf["file"], bench / "configs" / "throwaway.json")
    shutil.copy(here / "traffic" / "train_uncached.json", bench / "traffic" / "throwaway_mix.json")
    shutil.copy(here / "limits" / "l14.train.uncached.json",
                bench / "limits" / "throwaway.cell.json")
    m["configs"].append({**conf, "name": "throwaway", "file": "gpubench/configs/throwaway.json"})
    m["workloads"].append({**cell, "name": "throwaway.cell", "config": "throwaway",
                           "traffic": "throwaway_mix"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "l14.train.uncached" in e.get("workloads", []):
            e["workloads"].append("throwaway.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    tiny = tmp_path / "tiny"
    (tiny / "configs").mkdir(parents=True)
    (tiny / "traffic").mkdir()
    shutil.copy(TINY / "configs" / "owlvit-l14.json", tiny / "configs" / "throwaway.json")
    shutil.copy(TINY / "traffic" / "train_uncached.json", tiny / "traffic" / "throwaway_mix.json")
    spec = tiny_spec("throwaway.cell", root=tmp_path, tiny=tiny)
    assert spec["config_name"] == "throwaway" and spec["traffic_name"] == "throwaway_mix"
    _agrees(cpu_run(spec), spec)


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
