"""Serving export (counterpart of owlvit_tpu/train/export.py): the inference
step (uint8 pixels -> `normalize_image` -> `forward_train` over every layer
-> (boxes, sims)) traced by `torch.export` into an artifact that a process
loads and calls without the model's Python code.

    from owlvit_tpu_torch.train.export import export_detector, load_exported
    blob = export_detector(model, cfg, batch_size=1)
    fn = load_exported(blob)
    boxes, sims = fn(images_uint8)

Unlike the JAX package's StableHLO, a `torch.export` artifact is not self-
contained: its attention (and, under OWLVIT_FUSED_LN=1, its add+LayerNorm)
is a call of the port's custom ops `owlvit::pk_fwd` and `owlvit::add_ln_fwd`
(ops/flash_attention.py, ops/fused_ln.py), so the loading process needs the
port installed; `load_exported*` import those modules. On the card the ops
run the port's CUDA kernels (built at their first call), on the CPU their
plain versions. The artifact holds the parameters the forward reads (the
detector without its text tower), or none (`export_detector_weightless`:
they are call-time inputs, bound from the JAX package's npz tree). The
input shape is static: [batch_size, S, S, 3] uint8 at the model's S.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch
from torch import nn

from owlvit_tpu_torch.models import owlvit
from owlvit_tpu_torch.models.convert import _state_dict
# the custom ops the artifact calls: registered on import
from owlvit_tpu_torch.ops import flash_attention, fused_ln  # noqa: F401
from owlvit_tpu_torch.ops.preprocess import normalize_image


class _Detector(nn.Module):
    """The parameters `forward_train` reads (the vision tower, the heads and
    the query bank; no text tower), called on uint8 pixels."""

    def __init__(self, params: owlvit.OwlViT, cfg):
        super().__init__()
        self.vision, self.merged_ln = params.vision, params.merged_ln
        self.box_head, self.class_head = params.box_head, params.class_head
        self.queries = params.queries
        self.cfg = cfg

    def forward(self, images: torch.Tensor):
        return owlvit.forward_train(self, self.cfg, normalize_image(images))


class _Weightless(nn.Module):
    """A `_Detector` whose parameters come with each call (a {name: tensor}
    dict), through torch.func.functional_call: the traced program holds
    none of them."""

    def __init__(self, detector: _Detector):
        super().__init__()
        self.__dict__["detector"] = detector  # not a submodule: nothing lifted

    def forward(self, params: dict, images: torch.Tensor):
        return torch.func.functional_call(self.detector, params, (images,))


def make_infer_fn(params: owlvit.OwlViT, cfg):
    """Closure over the model: uint8 images [B, S, S, 3] -> (boxes, sims),
    every layer, no gradient."""
    detector = _Detector(params, cfg.replace(trainable_last_k=None))

    def infer(images):
        with torch.no_grad():
            return detector(images)

    return infer


def _example(params: owlvit.OwlViT, cfg, batch_size: int) -> torch.Tensor:
    size = cfg.vision.image_size
    device = params.vision.class_embedding.device
    example = torch.zeros((batch_size, size, size, 3), dtype=torch.uint8, device=device)
    normalize_image(example)  # its constants are made for the device outside the trace
    return example


# the weightless artifact's parameter names, in the order of its dict input
_NAMES = "owlvit_params.json"


def _serialize(program, names=None) -> bytes:
    program.example_inputs = None  # the example (weights included) is not kept
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files=None if names is None else {_NAMES: json.dumps(names)})
    return buf.getvalue()


def export_detector(params: owlvit.OwlViT, cfg, batch_size: int = 1) -> bytes:
    """The inference step, traced on the model's device at [batch_size, S,
    S, 3] uint8, serialized with its weights: one file, as big as the
    detector without its text tower."""
    detector = _Detector(params, cfg.replace(trainable_last_k=None))
    example = _example(params, cfg, batch_size)
    with torch.no_grad():  # Attention takes pk_fwd, not the autograd Function
        program = torch.export.export(detector, (example,))
    return _serialize(program)


def export_detector_weightless(params: owlvit.OwlViT, cfg, batch_size: int = 1) -> bytes:
    """The inference graph with the parameters as call-time inputs: the
    artifact holds only the program (and the parameters' names). `cli export
    --weightless` writes the weights beside it (`<out>.npz`, the JAX
    package's layout); pair with `load_exported_weightless(blob,
    convert.load_params(npz))`."""
    detector = _Detector(params, cfg.replace(trainable_last_k=None))
    example = _example(params, cfg, batch_size)
    weights = {k: v.detach() for k, v in detector.named_parameters()}
    with torch.no_grad():
        program = torch.export.export(_Weightless(detector), (weights, example))
    return _serialize(program, names=list(weights))


def save_exported(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def _load(blob_or_path, extra_files=None):
    f = blob_or_path if isinstance(blob_or_path, str) else io.BytesIO(bytes(blob_or_path))
    return torch.export.load(f, extra_files=extra_files)


def _images(images, device) -> torch.Tensor:
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images, dtype=np.uint8))
    return images.to(device=device, dtype=torch.uint8)


def load_exported(blob_or_path):
    """Load an artifact of `export_detector` on the device it was traced on;
    returns a callable: uint8 images (numpy or tensor) -> (boxes, sims)."""
    module = _load(blob_or_path).module()
    device = next(iter(module.state_dict().values())).device

    def call(images):
        with torch.no_grad():
            return module(_images(images, device))

    return call


def load_exported_weightless(blob_or_path, params: dict, device: str = "cuda"):
    """Load an artifact of `export_detector_weightless` and bind `params`,
    the JAX package's parameter tree of numpy arrays (e.g.
    `convert.load_params(npz)`; what the program does not read, the text
    tower, is left out), on `device`: the card unless the caller asks for the
    CPU, and the device the artifact was traced on. Returns a callable:
    uint8 images -> (boxes, sims)."""
    extra = {_NAMES: ""}
    module = _load(blob_or_path, extra_files=extra).module()
    state = _state_dict(params)
    weights = {k: state[k].to(device) for k in json.loads(extra[_NAMES])}

    def call(images):
        with torch.no_grad():
            return module(weights, _images(images, device))

    return call
