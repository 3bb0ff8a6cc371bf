"""BENCHMARK.json against the form the benchmark's manifest takes, and every file it names."""

import json
import re

import pytest

from gpubench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = common.manifest()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "gpubench/run.py"]
    assert M["paths"] == ["gpubench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    keys = ("why", "layer", "source") if section == "configs" else ("why", "layer")
    for e in M[section]:
        for text in (e[k] for k in keys if k in e):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_workloads_form():
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (common.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (common.HERE / "limits" / f"{w['name']}.json").is_file()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_metrics_form():
    names = {w["name"] for w in M["workloads"]}
    e2e = {e["name"] for e in M["end_to_end"]}
    assert "setup_s" in e2e
    for e in M["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert set(e.get("workloads", names)) <= names
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= names
        moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", names))
        assert (common.HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_every_cell_resolves_and_reports(w):
    cell = common.cell(w)
    assert cell["chips"] in (1, 4)
    assert any(e["name"] == "setup_s" for e in cell["end_to_end"])
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    assert all(v > 0 for v in cell["limits"].values())
    # a roofline or an mfu beside the kernels' rooflines for every end-to-end metric
    for e in cell["end_to_end"]:
        if e["name"] != "setup_s":
            moves = [m["name"] for m in cell["per_layer"] if m["moves"] == e["name"]]
            assert any("mfu" in n for n in moves), (w, e["name"])


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("gpubench/configs/")
    f = common.load_json(common.ROOT / c["file"])
    assert f["source"] == c["source"] and f["reduced"] == c["reduced"] == []
    for k in ("image_size", "patch_size", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size", "projection_dim"):
        assert isinstance(f[k], int) and f[k] > 0


def test_config_files_match_the_program():
    from gpubench.drivers import program

    for c in M["configs"]:
        program.config(common.load_json(common.ROOT / c["file"]))
