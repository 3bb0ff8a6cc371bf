"""Driver of the training mixes: `Trainer.train_step` at the mix's batch,
on the device pool of prefix activations (cached) or on uint8 images
handed from the host every step (uncached).

Set-up builds the trainer from the seed's weights; cached, it fills the
pool with the prefix of every row through the trainer's own fill path
(the images drawn on the card). The run's first three steps are the
checked ones: they go through the window's call and feed, on rows that all
differ, and their loss terms, the first step's gradients (from AdamW's
first moment) and the three steps' change of every trained leaf are kept
for the comparison. The first step's class similarities (the step hands them to its loss)
are kept element by element. The window then steps on through the seeded
order.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from gpubench import common
from gpubench.drivers import program
from gpubench.reference import train as ref_train
from gpubench.reference.owlvit import OwlViT as Reference
from owlvit_tpu_torch.train.trainer import Trainer
from owlvit_tpu_torch.utils.config import Config, DataConfig, ModelConfig, TrainingConfig

CHECK_STEPS = 3


@contextlib.contextmanager
def _outputs_kept():
    """The class similarities the step hands its loss, kept (as float32 on
    the host) while the step runs."""
    from owlvit_tpu_torch.ops import losses

    full, kept = losses.push_pull_loss, {}

    def keep(sims, boxes, *a, **kw):
        kept["sims"] = sims.detach().float().cpu()
        return full(sims, boxes, *a, **kw)

    losses.push_pull_loss = keep
    try:
        yield kept
    finally:
        losses.push_pull_loss = full


class Cell:
    def __init__(self, spec: dict, seed: int, device, run_program: bool = True):
        """run_program False: only what the reference needs (the control's
        readings run no program)."""
        c, t = spec["config"], spec["traffic"]
        self.c, self.t, self.seed, self.device = c, t, seed, torch.device(device)
        self.B, self.cached = t["batch"], t["cached"]
        self.rows = t["pool_rows"] if self.cached else t["host_images"]
        self.S = c["image_size"]
        self.gt = common.ground_truth(seed, range(self.rows), t)
        self.epoch, self.order, self.at, self.images = -1, None, 0, None
        if not run_program:
            self.prog = {"rows": []}
            for _ in range(CHECK_STEPS):
                self._next()
                self.prog["rows"].append(self.last_rows.copy())
            return
        t0 = time.perf_counter()
        cfg = program.config(c)
        W = common.make_weights(c, seed, self.device)
        model = program.model(c, cfg, W, self.device)
        del W
        config = Config(DataConfig(max_gt=t["max_gt"]),
                        TrainingConfig(learning_rate=t["learning_rate"],
                                       weight_decay=t["weight_decay"], batch_size=self.B,
                                       checkpoint_dir=None, cache_backbone=self.cached,
                                       cache_backbone_store="device"),
                        ModelConfig(name=c["program_config"], dtype=c["dtype"],
                                    trainable_last_k=t["trainable_last_k"]))
        self.trainer = Trainer(config, model, t["n_classes"],
                               steps_per_epoch=self.rows // self.B,
                               class_weights=common.class_weights(seed, t["n_classes"]),
                               device=self.device,
                               n_images=self.rows if self.cached else None)
        self.names = {id(p): n for n, p in model.named_parameters()}
        t1 = time.perf_counter()
        if self.cached:
            self._fill()
        else:
            # the host's images, each batch's rows contiguous, as a loader hands them
            self.images = common.host_images(seed, range(self.rows), self.S).reshape(
                self.rows // self.B, self.B, -1)
        t2 = time.perf_counter()
        self._checked_steps()
        program.sync(self.device)
        self.phases = {"trainer_s": t1 - t0, "inputs_s": t2 - t1,
                       "checked_steps_s": time.perf_counter() - t2}

    # ------------------------------------------------------------ the feed

    def _fill(self):
        """Every pool row through the trainer's fill path (embed_prefix, the
        scatter): batches of B rows, the last one ending at the last row."""
        for lo in range(0, self.rows, self.B):
            rows = np.arange(min(lo, self.rows - self.B), min(lo, self.rows - self.B) + self.B)
            batch = {"indices": rows,
                     "image": common.device_images(self.seed, rows, self.S, self.device)}
            self.trainer._cached_acts(batch, lambda name: None)
        program.sync(self.device)

    def _next(self) -> dict:
        """The next batch of the seeded order: cached, consecutive slices of
        a permutation of the pool's rows an epoch; uncached, the host's
        batches in a permuted order an epoch."""
        n = self.rows // self.B
        if self.order is None or self.at >= n:
            self.epoch += 1
            g = common.rng(self.seed, common.TAG_ORDER, self.epoch)
            self.order = g.permutation(self.rows if self.cached else n)
            self.at = 0
        if self.cached:
            rows = self.order[self.at * self.B:(self.at + 1) * self.B]
            batch = {"indices": rows}
        else:
            j = self.order[self.at]
            rows = np.arange(j * self.B, (j + 1) * self.B)
            batch = {} if self.images is None else {"image": self.images[j]}
        self.at += 1
        batch.update({k: v[rows] for k, v in self.gt.items()})
        self.last_rows = rows
        return batch

    def _step(self, mark=None) -> bool:
        terms = self.trainer.train_step(self._next(), mark=mark)
        return bool(np.isfinite(terms).all())

    # ---------------------------------------------------------- the run

    def _checked_steps(self):
        tr = self.trainer
        p0 = {self.names[id(p)]: p.detach().clone() for p in tr.params}
        self.prog = {"terms": [], "rows": []}
        b1 = tr.opt.param_groups[0]["betas"][0]
        for step in range(1, CHECK_STEPS + 1):
            batch = self._next()
            with _outputs_kept() if step == 1 else contextlib.nullcontext({}) as outputs:
                self.prog["terms"].append(tr.train_step(batch).tolist())
            self.prog.update(outputs)
            self.prog["rows"].append(self.last_rows.copy())
            if step == 1:
                # AdamW's first moment after one step is (1 - b1) g; a step
                # that left no state behind read as no gradient
                state = {self.names[id(p)]: tr.opt.state[p]["exp_avg"] / (1 - b1)
                         for p in tr.params if "exp_avg" in tr.opt.state.get(p, {})}
                self.prog["grad"] = {n: (state[n].norm().item() if n in state else 0.0)
                                     for n in p0}
        self.prog["change"] = {self.names[id(p)]: (p.detach() - p0[self.names[id(p)]])
                               .norm().item() for p in tr.params}

    def warm(self):
        self._step()

    def window(self, seconds: float, marks: bool) -> dict:
        program.sync(self.device)
        t0, steps, failed, phases = time.perf_counter(), 0, 0, []
        while time.perf_counter() - t0 < seconds:
            m = program.Marks() if marks else None
            failed += not self._step(m)
            steps += 1
            if m:
                phases.append(m)
        program.sync(self.device)
        wall = time.perf_counter() - t0
        out = {"attempted": steps, "failed": failed, "wall_s": wall,
               "e2e": {"train_img_per_s": steps * self.B / wall}}
        if marks:
            out["phase_ms"] = {
                "forward": [m.ms("start", "forward") for m in phases],
                "match": [m.ms("cost", "match") for m in phases],
                "backward": [m.ms("loss", "backward") for m in phases]}
        return out

    def traced(self, seconds: float, trace) -> dict:
        steps = 0
        with trace:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with torch.profiler.record_function("gpubench.train_step"):
                    self._step()
                steps += 1
        L, k = self.c["num_hidden_layers"], self.t["trainable_last_k"]
        return {"images": steps * self.B, "attn_fwd_layers": k if self.cached else L,
                "attn_bwd_layers": k}

    def free(self):
        del self.trainer
        program.free()

    # ------------------------------------------------------ the comparison

    def _reference_batches(self):
        out = []
        for rows in self.prog["rows"]:
            if self.cached:
                images = common.device_images(self.seed, rows, self.S, self.device)
            else:
                images = torch.from_numpy(
                    common.host_images(self.seed, rows, self.S)).to(self.device)
            out.append({"images": images, **{k: v[rows] for k, v in self.gt.items()}})
        return out

    def _weights(self):
        W0 = common.make_weights(self.c, self.seed, self.device)
        w = torch.from_numpy(common.class_weights(self.seed, self.t["n_classes"])).to(self.device)
        return W0, w

    def _reference(self) -> tuple:
        """The reference's three steps, and its first step's class
        similarities computed in bf16."""
        W0, w = self._weights()
        batches = self._reference_batches()
        ref = ref_train.trajectory(W0, self.c, self.t, batches, w)
        with torch.no_grad():
            sims_bf16 = Reference(W0, self.c, "bf16").detect(batches[0]["images"])[1].cpu()
        return ref, sims_bf16

    def check(self) -> dict:
        ref, sims_bf16 = self._reference()
        self.detail = ref_train.detail(self.prog, ref)
        return ref_train.compare(self.prog, ref, sims_bf16)

    def control(self) -> dict:
        """Readings against the reference of: the control (the reference in
        fp8 in the program's place), the half-batch fault, and the look at
        what rounding alone moves (the reference in bf16, the program's
        precision)."""
        ref, sims_bf16 = self._reference()
        W0, w = self._weights()
        out = {}
        for name, kw in (("control_fp8", {"precision": "fp8"}),
                         ("fault_half_batch", {"half_batch": True}),
                         ("look_reference_bf16", {"precision": "bf16"})):
            other = ref_train.trajectory(W0, self.c, self.t, self._reference_batches(), w, **kw)
            out[name] = {"numbers": ref_train.compare(other, ref, sims_bf16),
                         "detail": ref_train.detail(other, ref)}
        return out
