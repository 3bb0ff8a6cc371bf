"""The program under test, built from the benchmark's weights."""

from __future__ import annotations

import gc

import torch

from owlvit_tpu_torch.models import get_config, owlvit


def config(c: dict, **overrides):
    """The program's model configuration for the configuration file `c`,
    held to the file's published sizes."""
    cfg = get_config(c["program_config"], dtype=c["dtype"], **overrides)
    v = cfg.vision
    have = {"image_size": v.image_size, "patch_size": v.patch_size,
            "hidden_size": v.hidden_size, "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads, "intermediate_size": v.mlp_dim,
            "layer_norm_eps": v.layer_norm_eps, "projection_dim": cfg.projection_dim}
    differ = {k: (have[k], c[k]) for k in have if have[k] != c[k]}
    if differ:
        raise ValueError(f"the program's {c['program_config']} differs from the "
                         f"configuration file: {differ}")
    return cfg


def model(c: dict, cfg, W: dict, device) -> owlvit.OwlViT:
    """The program's detector on `device` holding the weights W (the text
    tower, which no cell runs, is left as allocated)."""
    with torch.device(device):
        m = owlvit.OwlViT(cfg, num_queries=c["num_queries"])
    params = dict(m.named_parameters())
    missing = [n for n in W if n not in params or params[n].shape != W[n].shape]
    if missing:
        raise ValueError(f"the program has no parameter of these names and shapes: {missing}")
    with torch.no_grad():
        for n, w in W.items():
            params[n].copy_(w)
    return m


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Marks:
    """The trainer's `mark` callback: a CUDA event at the step's start and at
    each phase it names."""

    def __init__(self):
        self.events = {}
        self("start")

    def __call__(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name] = ev

    def ms(self, a: str, b: str) -> float:
        return self.events[a].elapsed_time(self.events[b])
