"""The frozen arithmetic: FLOP counts, attention work, the trace's
reductions, the metric readers on hand-built events."""

import hashlib
import importlib.util

import pytest
import torch

from gpubench import common, yardstick
from gpubench.tests.conftest import SEED, TINY
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


# SHA-256 of owlvit-l14's weights at the tiny size and SEED, each leaf's
# name then its float32 bytes in the draw's order, as the benchmark first
# drew them (common.vision_leaves, before a configuration chose its
# reference)
FIRST_DRAW_SHA256 = "c6adf962256f1daa29c8ed96e9078823e13860fc32a8d1f1bb5011441b01db43"


def test_owlvit_l14_weights_are_drawn_as_before():
    """owlvit-l14 names no reference (owlvit): its weights, at the tiny size
    and a fixed seed, are bit-equal to the first draw's."""
    c = common.load_json(TINY / "configs" / "owlvit-l14.json")
    h = hashlib.sha256()
    for name, w in common.make_weights(c, SEED, "cpu").items():
        h.update(name.encode())
        h.update(w.contiguous().numpy().tobytes())
    assert h.hexdigest() == FIRST_DRAW_SHA256


@pytest.mark.parametrize("log,pole", [(torch.log, 0.0), (lambda v: torch.log1p(-v), 1.0)],
                         ids=["log", "log1p"])
def test_reference_logs_have_no_nan_gradient_at_their_poles(log, pole):
    """The reference loss's clamped logs take the values of the plain
    log(x).clamp(min=-100) everywhere and its gradient off the pole; at the
    pole (a similarity of exactly 0, or 1) the plain form's gradient is NaN
    (0 * inf) and theirs 0."""
    from gpubench.reference import train as ref_train

    x = torch.tensor([0.0, 1e-30, 0.3, 1 - 2 ** -24, 1.0], requires_grad=True)
    y = x.detach().clone().requires_grad_(True)
    got = ref_train.clamped_log(x, log, pole)
    plain = log(y).clamp(min=ref_train.LOG_CLAMP)
    assert torch.equal(got, plain)
    got.sum().backward()
    plain.sum().backward()
    at = x.detach() == pole
    assert torch.isnan(y.grad[at]).all() and (x.grad[at] == 0).all()
    assert torch.equal(x.grad[~at], y.grad[~at])
