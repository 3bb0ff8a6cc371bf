"""OWL-ViT's image side in plain PyTorch, float32 (TF32 off by the caller):
the CLIP vision transformer, the merged features, the box head and the
query-bank class head of Minderer et al. 2022 (arXiv:2205.06230; HF
transformers modeling_owlvit.py), as the fine-tune recipe runs them.

It reads the weights by the names of `leaves`, which the benchmark draws
in their order (gpubench/common.make_weights): the patch embedding is
[D, T*T*3] over (row, column, channel) of a patch, every linear weight is
[out, in]. It imports nothing of the program.

Departures from the published model, both of the recipe the program
follows: the query bank's rows are normalised as q / |q| + 1e-6, and a
class's similarity is the best of its prompts_per_class rows.

precision "fp8" is the control: the reference computed in float8 e4m3
where the program computes in bfloat16. Every product's two inputs and
every activation the program holds in bfloat16 (each linear's and
LayerNorm's output, the residual stream, the attention's probabilities)
are rounded to e4m3 with one scale per tensor; products accumulate in
float32, as the program's do. The gradient passes straight through the
rounding. precision "bf16" rounds the same tensors to bfloat16 instead:
the program's own precision, a look at what rounding alone reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5


def fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    y = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (y - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x + (x.detach().bfloat16().float() - x.detach())


ROUNDING = {"fp32": lambda x: x, "fp8": fp8, "bf16": bf16}


def box_bias(grid: int) -> torch.Tensor:
    """[grid*grid, 4] (cx, cy, w, h) prior in logit space: each patch's box
    centred on its cell's far corner ((c+1)/grid, (r+1)/grid), one cell in
    size, patches in row-major order (HF compute_box_bias)."""
    centre = torch.arange(1, grid + 1, dtype=torch.float64) / grid
    yy, xx = torch.meshgrid(centre, centre, indexing="ij")
    xy = torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)
    logit = lambda p: torch.log(p + 1e-4) - torch.log1p(-p + 1e-4)  # noqa: E731
    wh = torch.full_like(xy, 1.0 / grid)
    return torch.cat([logit(xy), logit(wh)], -1).float()


def xyxy(cxcywh: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = cxcywh.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def leaves(c: dict) -> list:
    """(name, shape, init) of every parameter the detector's vision tower
    and heads hold, in the names of the port's parameter tree. init: ("w",
    std) normal, ("one", std) 1 + normal (LayerNorm scales)."""
    D, M, T = c["hidden_size"], c["intermediate_size"], c["patch_size"]
    P = (c["image_size"] // T) ** 2
    proj, Q = c["projection_dim"], c["num_queries"]
    small = ("w", 0.02)
    out = [("vision.patch_embedding.weight", (D, T * T * 3), small),
           ("vision.class_embedding", (D,), small),
           ("vision.position_embedding", (P + 1, D), small)]

    def ln(name):
        out.extend([(f"{name}.weight", (D,), ("one", 0.02)), (f"{name}.bias", (D,), small)])

    def lin(name, d_in, d_out):
        out.extend([(f"{name}.weight", (d_out, d_in), ("w", d_in ** -0.5)),
                    (f"{name}.bias", (d_out,), small)])

    ln("vision.pre_ln")
    for i in range(c["num_hidden_layers"]):
        p = f"vision.layers.{i}"
        ln(f"{p}.ln1")
        for n in ("q", "k", "v", "out"):
            lin(f"{p}.attn.{n}", D, D)
        ln(f"{p}.ln2")
        lin(f"{p}.mlp.fc1", D, M)
        lin(f"{p}.mlp.fc2", M, D)
    ln("vision.post_ln")
    ln("merged_ln")
    lin("box_head.dense0", D, D)
    lin("box_head.dense1", D, D)
    lin("box_head.dense2", D, 4)
    lin("class_head.dense0", D, proj)
    lin("class_head.logit_shift", D, 1)
    lin("class_head.logit_scale", D, 1)
    out.append(("queries", (Q, proj), small))
    return out


class OwlViT:
    """c: the configuration file's sizes; W: name -> fp32 tensor."""

    def __init__(self, W: dict, c: dict, precision: str = "fp32"):
        if precision not in ROUNDING:
            raise ValueError(f"precision {precision!r}")
        self.W, self.c = W, c
        self.round = ROUNDING[precision]
        self.grid = c["image_size"] // c["patch_size"]
        self.bias = box_bias(self.grid).to(W["queries"].device)

    def lin(self, x, name, bias=True):
        b = self.W[f"{name}.bias"] if bias else None
        return self.round(F.linear(self.round(x), self.round(self.W[f"{name}.weight"]), b))

    def ln(self, x, name):
        return self.round(F.layer_norm(x, x.shape[-1:], self.W[f"{name}.weight"],
                                       self.W[f"{name}.bias"], LN_EPS))

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 [B, S, S, 3] -> tokens after the pre-LN [B, 1 + P, D]."""
        B, T, g = images.shape[0], self.c["patch_size"], self.grid
        mean = images.new_tensor(CLIP_MEAN, dtype=torch.float32)
        std = images.new_tensor(CLIP_STD, dtype=torch.float32)
        x = (images.float() / 255.0 - mean) / std
        x = x.reshape(B, g, T, g, T, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, T * T * 3)
        x = self.lin(x, "vision.patch_embedding", bias=False)
        cls = self.W["vision.class_embedding"].expand(B, 1, -1)
        x = self.round(torch.cat([cls, x], 1) + self.W["vision.position_embedding"])
        return self.ln(x, "vision.pre_ln")

    def block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = f"vision.layers.{i}"
        B, S, D = x.shape
        H = self.c["num_attention_heads"]
        hd = D // H
        h = self.ln(x, f"{p}.ln1")
        q, k, v = (self.lin(h, f"{p}.attn.{n}").view(B, S, H, hd).transpose(1, 2)
                   for n in "qkv")
        a = torch.softmax(self.round(q * hd ** -0.5) @ self.round(k).transpose(-1, -2), -1)
        o = (self.round(a) @ self.round(v)).transpose(1, 2).reshape(B, S, D)
        x = self.round(x + self.lin(o, f"{p}.attn.out"))
        h = self.lin(self.ln(x, f"{p}.ln2"), f"{p}.mlp.fc1")
        h = self.round(h * torch.sigmoid(1.702 * h))  # quick GELU
        return self.round(x + self.lin(h, f"{p}.mlp.fc2"))

    def layers(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        for i in range(lo, hi):
            x = self.block(x, i)
        return x

    def heads(self, x: torch.Tensor):
        """Last hidden state [B, 1 + P, D] -> (xyxy boxes [B, P, 4] in [0, 1],
        class similarities [B, P, n_classes])."""
        x = self.ln(x, "vision.post_ln")
        f = self.ln(self.round(x[:, 1:] * x[:, :1]), "merged_ln")
        h = self.round(F.gelu(self.lin(f, "box_head.dense0")))
        h = self.round(F.gelu(self.lin(h, "box_head.dense1")))
        boxes = xyxy(torch.sigmoid(self.lin(h, "box_head.dense2") + self.bias))
        img = self.lin(f, "class_head.dense0")
        img = img / (img.norm(dim=-1, keepdim=True) + 1e-6)
        q = self.W["queries"]
        q = q / q.norm(dim=-1, keepdim=True) + 1e-6
        sims = self.round(img) @ self.round(q).T
        B, P, Q = sims.shape
        k = self.c["prompts_per_class"]
        return boxes, sims.reshape(B, P, Q // k, k).amax(-1)

    @torch.no_grad()
    def detect(self, images: torch.Tensor, block: int = 4):
        """uint8 [N, S, S, 3] -> (boxes [N, P, 4], sims [N, P, C]), `block`
        images at a time."""
        out = [self.heads(self.layers(self.embed(images[i:i + block]), 0,
                                      self.c["num_hidden_layers"]))
               for i in range(0, images.shape[0], block)]
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


# the model class a configuration that names this reference runs
Model = OwlViT
