"""The pure helpers of tools/torch_serve_profile.py (device-time sums),
tools/torch_pk_bwd_profile.py (turn order, median and spread) and
tools/torch_matcher_profile.py (the slowest image, summaries), on the CPU."""

import importlib.util
from pathlib import Path

import pytest

_PATH = Path(__file__).resolve().parent.parent / "tools" / "torch_serve_profile.py"
_spec = importlib.util.spec_from_file_location("torch_serve_profile", _PATH)
prof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(prof)


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0.0, 2.0), (5.0, 6.0)], 3.0),          # disjoint
    ([(0.0, 4.0), (1.0, 2.0), (3.0, 6.0)], 6.0),  # nested and overlapping
    ([(3.0, 6.0), (0.0, 3.0)], 6.0),          # unsorted, touching
])
def test_union_us(intervals, busy):
    assert prof.union_us(intervals) == busy


@pytest.mark.parametrize("name, cat", [
    ("void (anonymous namespace)::pk_fwd_bf16<true>(...)", "attention kernel"),
    ("nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN", "gemm"),
    ("void at::native::vectorized_layer_norm_kernel<float>", "layernorm"),
    ("Memcpy DtoD (Device -> Device)", "copy / cast"),
    ("void at::native::reduce_kernel<512, 1, ArgMaxOps>", "reduce / index"),
    ("void at::native::sigmoid_kernel_cuda", "elementwise / other"),
])
def test_category(name, cat):
    assert prof.category(name) == cat


_BWD_PATH = Path(__file__).resolve().parent.parent / "tools" / "torch_pk_bwd_profile.py"
_bwd_spec = importlib.util.spec_from_file_location("torch_pk_bwd_profile", _BWD_PATH)
bwd_prof = importlib.util.module_from_spec(_bwd_spec)
_bwd_spec.loader.exec_module(bwd_prof)


@pytest.mark.parametrize("names, rounds, order", [
    (("baseline", "tree"), 1, ["baseline", "tree", "tree", "baseline"]),
    (("a", "b", "c"), 1, ["a", "b", "c", "c", "b", "a"]),
    (("baseline", "tree"), 2, ["baseline", "tree", "tree", "baseline"] * 2),
])
def test_in_turns_order(names, rounds, order):
    """Each build is measured once on the way out and once on the way back,
    in every round."""
    calls = []

    def measure(name):
        calls.append(name)
        return float(len(calls))

    out = bwd_prof.in_turns(measure, names, rounds)
    assert calls == order
    assert out == {n: [float(i + 1) for i, c in enumerate(order) if c == n] for n in names}


@pytest.mark.parametrize("readings, median, spread", [
    ([2.0, 2.0], 2.0, 0.0),
    ([1.0, 3.0], 2.0, 1.0),
    ([4.0, 1.0, 2.0], 2.0, 1.5),
])
def test_summary(readings, median, spread):
    assert bwd_prof.summary(readings) == {"median": median, "spread": spread}


_MATCH_PATH = Path(__file__).resolve().parent.parent / "tools" / "torch_matcher_profile.py"
_match_spec = importlib.util.spec_from_file_location("torch_matcher_profile", _MATCH_PATH)
match_prof = importlib.util.module_from_spec(_match_spec)
_match_spec.loader.exec_module(match_prof)


@pytest.mark.parametrize("counts, image, count", [
    ([3], 0, 3),
    ([10, 2080, 7, 2080], 1, 2080),  # the first of equal counts
    ([0, 0], 0, 0),
])
def test_slowest_image(counts, image, count):
    assert match_prof.slowest(counts) == (image, count)


def test_summaries_keep_readings_that_are_not_times():
    """A build whose profile saw no device events keeps its raw readings;
    the others get their median and spread."""
    none = "not measured: the profiler saw no device events"
    out = match_prof.summaries({"base": [1.0, 3.0], "tree": [none, 0.5]})
    assert out == {"base": {"median": 2.0, "spread": 1.0}, "tree": [none, 0.5]}
