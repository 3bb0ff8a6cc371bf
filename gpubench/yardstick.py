"""The benchmark's fixed arithmetic: the card's peaks, the model's FLOPs per
image, the attention kernels' work, and the reduction of a profiler trace
to busy time, idle gaps and the heaviest device operations.

The FLOP counts are a frozen copy of owlvit_tpu_torch/utils/flops.py (the
same formulas, read from the configuration's file rather than the
program's config object); the bounds are those of chip_smoke.py's kernels
line (FLOPs at 989 TFLOP/s, bytes at 3.35 TB/s). They live here so that a
change to the program cannot move them.
"""

from __future__ import annotations

# dense bf16 FLOP/s and HBM bytes/s of one card, by a substring of
# torch.cuda.get_device_name() (NVIDIA's data sheet, SXM part, 700 W)
PEAKS = [
    ("h100 80gb hbm3", 989e12, 3.35e12),
    ("h100 sxm", 989e12, 3.35e12),
]


def peak(device_name: str) -> tuple:
    """(bf16 FLOP/s, bytes/s) of the card named `device_name`; a card not
    in the table raises, so that no share is read against a guessed peak."""
    n = device_name.lower()
    for sub, flops, bw in PEAKS:
        if sub in n:
            return flops, bw
    raise KeyError(f"no peak known for {device_name!r}")


# ------------------------------------------------------------ FLOPs per image

def _sizes(c: dict) -> tuple:
    T = c["patch_size"]
    P = (c["image_size"] // T) ** 2
    return P, P + 1, c["hidden_size"], c["intermediate_size"], T


def encoder_layer_fwd(c: dict) -> float:
    """Matmul FLOPs of one encoder layer's forward for one image: QKV and
    the output projection 8SD^2, QK^T and PV 4S^2D, the MLP 4SDM."""
    _, S, D, M, _ = _sizes(c)
    return 8 * S * D * D + 4 * S * S * D + 4 * S * D * M


def heads_fwd(c: dict) -> float:
    """The box MLP (two D x D layers and D x 4) and the class projection
    with the cosine product against the query bank, on the P patches."""
    P, _, D, _, _ = _sizes(c)
    box = 2 * P * D * D * 2 + 2 * P * D * 4
    cls = 2 * P * D * c["projection_dim"] + 2 * P * c["projection_dim"] * c["num_queries"]
    return box + cls


def patch_embed_fwd(c: dict) -> float:
    P, _, D, _, T = _sizes(c)
    return 2 * P * (T * T * 3) * D


def serve_flops_per_image(c: dict) -> float:
    """Full forward, no backward."""
    return patch_embed_fwd(c) + c["num_hidden_layers"] * encoder_layer_fwd(c) + heads_fwd(c)


def train_flops_per_image(c: dict, trainable_last_k: int, cached: bool) -> float:
    """Forward of everything the step runs plus ~2x the forward of what
    takes a gradient (the trainable tail and the heads). cached: the
    frozen prefix is a gather, only the tail runs."""
    tail = trainable_last_k * encoder_layer_fwd(c) + heads_fwd(c)
    if cached:
        return 3 * tail
    return serve_flops_per_image(c) + 2 * tail


# ---------------------------------------------------------- attention work

def attention_fwd_flops(c: dict, images: int, layers: int) -> float:
    """QK^T and PV of `layers` layers over `images` images: 4 B H S^2 hd."""
    _, S, D, _, _ = _sizes(c)
    return 4.0 * images * layers * S * S * D


def attention_bwd_flops(c: dict, images: int, layers: int) -> float:
    """The backward's products (S = QK^T again, dV, dP, dQ, dK): 2.5x the
    forward, FlashAttention's count."""
    return 2.5 * attention_fwd_flops(c, images, layers)


# --------------------------------------------------------------- the trace

def union_s(intervals) -> float:
    """Seconds covered by the union of (start_s, end_s) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """(start_s, end_s) of the stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def top(totals: dict, n: int = 10) -> list:
    """The n largest, each name cut to 96 characters."""
    return [[k[:96], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def device_ops(device_events) -> list:
    """The device's time by operation name, the largest ten. Events are
    (name, start_s, end_s)."""
    ops: dict = {}
    for name, s, e in device_events:
        ops[name] = ops.get(name, 0.0) + (e - s)
    return top(ops)


def idle_gaps(device_events, host_events, window_s: float) -> list:
    """The seconds of [0, window_s] in which the device ran nothing, by the
    innermost host event running at each gap's midpoint ("no_host_event"
    where none ran), the largest ten."""
    # host events by the 1 ms bins they span, so that each gap looks only
    # at the events of its midpoint's bin
    bins: dict = {}
    for ev in host_events:
        for b in range(int(ev[1] * 1e3), int(ev[2] * 1e3) + 1):
            bins.setdefault(b, []).append(ev)
    idle: dict = {}
    for s, e in gaps([(a, b) for _, a, b in device_events], 0.0, window_s):
        mid = 0.5 * (s + e)
        inner = [ev for ev in bins.get(int(mid * 1e3), ()) if ev[1] <= mid <= ev[2]]
        name = min(inner, key=lambda ev: ev[2] - ev[1])[0] if inner else "no_host_event"
        idle[name] = idle.get(name, 0.0) + (e - s)
    return top(idle)
