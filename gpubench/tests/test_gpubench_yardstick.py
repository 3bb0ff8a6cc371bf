"""The frozen arithmetic: FLOP counts, attention work, the trace's
reductions, the metric readers on hand-built events."""

import importlib.util

import pytest

from gpubench import common, yardstick
from owlvit_tpu_torch.models import get_config
from owlvit_tpu_torch.utils import flops as program_flops

# every configuration file, those of cells left out of the manifest too
CONFIGS = {p.stem: common.load_json(p) for p in (common.HERE / "configs").glob("*.json")}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_flops_equal_the_programs_count(name):
    c = CONFIGS[name]
    cfg = get_config(c["program_config"], trainable_last_k=1)
    assert yardstick.serve_flops_per_image(c) == program_flops.serve_flops_per_image(cfg, 240)
    for cached in (False, True):
        assert yardstick.train_flops_per_image(c, 1, cached) == \
            program_flops.train_flops_per_image(cfg, 240, cached=cached)


def test_flops_by_hand():
    c = CONFIGS["owlvit-l14"]
    # an L/14 image is 3.476 TFLOP of forward work (utils/flops.py's count)
    assert yardstick.serve_flops_per_image(c) == pytest.approx(3.476e12, rel=1e-3)
    S, D = 3601, 1024
    assert yardstick.attention_fwd_flops(c, 2, 3) == 4 * 2 * 3 * S * S * D
    assert yardstick.attention_bwd_flops(c, 2, 3) == 2.5 * 4 * 2 * 3 * S * S * D


def test_union_gaps_and_idle():
    ev = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 3.0)]
    assert yardstick.union_s([(s, e) for _, s, e in ev]) == pytest.approx(2.5)
    assert yardstick.gaps([(s, e) for _, s, e in ev], 0.0, 4.0) == [(1.5, 2.0), (3.0, 4.0)]
    host = [("step", 0.0, 4.0), ("aten::mm", 1.4, 1.9)]
    idle = dict(map(tuple, yardstick.idle_gaps(ev, host, 4.0)))
    assert idle == pytest.approx({"aten::mm": 0.5, "step": 1.0})
    ops = dict(map(tuple, yardstick.device_ops(ev + [("a", 3.0, 3.5)])))
    assert ops == pytest.approx({"a": 1.5, "b": 1.0, "c": 1.0})


def test_peak_by_name():
    assert yardstick.peak("NVIDIA H100 80GB HBM3")[0] == 989e12
    with pytest.raises(KeyError):
        yardstick.peak("NVIDIA A100-SXM4-80GB")


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, common.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(device, traced, window_s=1.0):
    c = CONFIGS["owlvit-l14"]
    from gpubench.yardstick import union_s
    return {"config": c, "traffic": {"trainable_last_k": 1, "cached": True},
            "peak_flops": 989e12, "traced": traced, "e2e": {"train_img_per_s": 1000.0},
            "window": {"phase_ms": {"forward": [1.0, 3.0, 2.0]}},
            "trace": {"device": device, "window_s": window_s,
                      "busy_s": union_s([(s, e) for _, s, e in device])}}


def test_readers_on_hand_built_events():
    work = yardstick.attention_fwd_flops(CONFIGS["owlvit-l14"], 32, 1)
    t = work / 989e12 / 0.4  # the kernels at 40% of the bound
    device = [("pk_fwd_bf16<0>", 0.0, t / 2), ("pk_fwd_bf16<0>", 0.5, 0.5 + t / 2),
              ("gemm", 0.1, 0.2)]
    ctx = _ctx(device, {"images": 32, "attn_fwd_layers": 1, "attn_bwd_layers": 1})
    assert _reader("attn_fwd_roofline.train")(ctx) == pytest.approx(40.0)
    assert _reader("attn_bwd_roofline.train")(ctx) is None  # no backward kernel ran
    busy = t + 0.1
    assert _reader("device_idle_pct.train")(ctx) == pytest.approx(100 * (1 - busy))
    assert _reader("forward_ms.train")(ctx) == 2.0
    f = yardstick.train_flops_per_image(CONFIGS["owlvit-l14"], 1, True)
    assert _reader("mfu.train")(ctx) == pytest.approx(100 * f * 1000 / 989e12)
