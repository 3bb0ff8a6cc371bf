#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printing its numbers on a line of its own:
  1. device: refuse to run without CUDA; TF32 off; the card's name and power
     limit from nvidia-smi.
  2. build: the kernels from owlvit_tpu_torch/csrc (attention forward and
     backward, fused add+LayerNorm, the matcher's assignment and label
     propagation), one nvcc per source, started together;
     nvcc's registers, stack and spills per kernel, the bf16 attention
     forward's, fused backward's and split pair's under keys of their own
     (the forward and the pair's dq and dkv kernels must not spill; none
     may carry a note that ptxas serialises its wgmma), the dq and dkv
     kernels' dynamic shared memory, and
     the bf16 add+LN backward's per width with its dynamic shared memory
     and blocks per SM (it must not spill).
  3. kernel: pk_fwd against its plain PyTorch version on the card at the
     B/32, B/16 and L/14 attention shapes (batch 4, valid_len < padded S),
     bf16 and fp32, fixed-shift (C=20) and per-row-max softmax; then bf16
     at a B/16 layer's local shape under tp=2, [32, 2305, 384] with 6 heads
     (timed beside scaled_dot_product_attention).
  4. kernel_bwd: pk_bwd (mode "fused") and the split pair pk_dq + pk_dkv
     (mode "both", the default) against the plain version at the same
     shapes and at [8, 2305, 768] unpadded, bf16 and fp32; two launches of
     the pair bit-equal; the pair again at scale 0.1 (the dq kernel's
     k * scale scratch, the dkv kernel's q * scale tiles); then
     pk_bwd and the pair at the tp=2 local [32, 2305, 384] with 6 heads, as
     at the train shape in phase 9.
  5. kernel_ln: add_ln forward and backward against their plain versions at
     [32*2305, 768] (the trained shape), [8*2305, 768], [4*3601, 1024]
     (L/14) and [2305, 768], bf16 and fp32: r exact, the backward's sums the
     same from launch to launch; at the trained shape in bf16 the times
     beside the bound, the plain versions' and the yardstick x + h then
     F.layer_norm (forward, backward alone, and forward + backward); at the
     other three in bf16 the backward's time (CUDA events through the
     wrapper, and the profiler's device time) beside its bound; then the
     same checks at 999 rows for every other D the kernels take.
  6. kernel_transposed: the transposed Function flash_attention ([B, S, H,
     64], the packed kernels at one head per sequence) driven once forward
     and backward at [32, 2305, 12, 64] bf16 and [4, 2305, 12, 64] fp32 (the
     only launches of the transposed forward: no model reaches it), then
     its kernels (the forward and the split pair at one head) against the
     plain versions, with times at the bf16 shape (the pair in turns with
     the fused kernel at one head, and SDPA's forward + backward).
  7. slice: B/16 bf16 with random weights behind DetectorServer(buckets=(1,
     8)); 9 model-sized images; results checked; the forward kernel's launch
     count, a batch bit-equal to a direct forward + NMS, and the kernel path
     against the plain-attention path.
  8. open_vocab: B/16 bf16, random weights (seed 0), 240 bank queries, the
     HashTokenizer. DetectorServer(buckets=(1, 8), max_queries=8,
     one_shot=True) warmed up on both lanes; 17 conditioned requests (two
     overlapping query sets of 3 and 8 strings, two exemplars, one of them
     not model-sized, text and image requests mixed in a batch) and 9 bank
     requests queued before start(). Checks: the batches the queue implies;
     each conditioned batch bit-equal to serve_batch_conditioned on the
     server's own query block; within TOL_SLICE of forward_zero_shot /
     forward_one_shot (pre-NMS scores, boxes) and of plain attention
     (scores, boxes, logits max-rel); the text cache holding exactly the
     distinct strings and the exemplar cache the distinct digests; pk_fwd
     launched 12 times per forward (warm-up batches and exemplar, image
     batches, cold exemplars) and no other kernel. Then each lane's img/s
     per bucket (bank, zero-shot, one-shot in turns: 4 windows each of at
     least 0.75 s and 8 batches; median and spread), the host's us per
     small launch, 20 cold text encodes and 10 cold exemplar embeds;
     bulk_detect over 64 images at bucket 32 (bank, zero-shot, bank again)
     bit-equal to the online server's rows, then timed over 256-image jobs
     (3 per lane, in turns); the
     CLI's infer (bank, --queries, --query-image) and bulk-infer on 8
     make-synthetic images with --device cuda.
 8b. mesh_serve: DetectorServer(mesh=), B/16 bf16, random weights (seed 0),
     240 bank queries, the slice phase's 9 images. A mesh of one
     (cuda:0,), buckets (1, 8), bit-equal to the single-device server row
     for row. Two shards on cuda:0, buckets (2, 8), both lanes (9 bank and
     9 conditioned requests): each row bit-equal to a direct call on its
     own 4-row or 1-row shard (the server's own query block for the
     conditioned lane), each shard's pre-NMS output within TOL_SLICE of the
     unsharded bucket's, the post-NMS rows against the single-device
     server's counted; bulk_detect over 64 images (bank and zero-shot)
     bit-equal to the mesh server's online rows; pk_fwd launched 12 times
     per shard per batch (warm-up: every bucket of both lanes on every
     shard). Then the dispatch's img/s per bucket in turns (no mesh, a mesh
     of one, and at bucket 8 two shards on one card: no scaling figure; the
     machine has one H100, so NCCL and multi-card serving are not
     measured), open_vocab's windows.
  9. main_path_kernel: pk_fwd against its plain version at the shapes the
     served forward gives it ([8, 2305, 768] and [1, 2305, 768], C = 20, no
     padding) and at the train step's [32, 2305, 768] (per-row max), with
     scaled_dot_product_attention's forward time beside it, each launched
     twice (o and lse bit-equal); then pk_bwd and the split pair at [32,
     2305, 768] bf16 beside the plain versions (on batch slices of 4) and
     scaled_dot_product_attention's forward + backward, each launched twice
     (pk_bwd: dk and dv bit-equal, dq within its reductions' fp32 order; the
     pair: dq, dk and dv bit-equal), timed in turns; then one line with the
     attention kernels' times (attention_times).
 10. train: 4 uncached steps of Trainer.train_step, B/16 bf16, random
     weights (seed 0), a 240-query bank, batch 32, max_gt 64, ~7 random
     boxes per image, lr 3e-6, weight decay 0.1: finite terms, launch counts
     (12 pk_fwd, 1 pk_dq and 1 pk_dkv per step: the default backward is the
     split pair), frozen parameters bit-unchanged, every trainable one
     moved; the first step again twice from the same state: terms equal and
     every gradient bit-equal; host wall of steps 2-4, CUDA-event times of
     each phase of the step, peak memory; jv_assign and propagate_labels
     once a step, the matcher's inputs and the assignment kept. Then the trained layer on
     the prefix output of 8 images: kernel path against the plain path,
     forward and backward, and both against fp32 (the default backward's q
     and k weight grads within 0.15 of it; the same layer under
     OWLVIT_PACKED_BWD=fused printed beside).
 10b. kernel_matcher: jv_assign and propagate_labels against the host
     solver and the host walk, exact: on the 4 train steps' own costs,
     boxes and classes (read back here only), then jv_assign on tie-heavy
     integer costs (duplicated columns, masked rows, an image of identical
     rows) at [32, 16, 2304], [32, 64, 2304], [32, 64, 576], [4, 64, 3600]
     and propagate_labels on chains of overlapping boxes (the walk's order
     decides) and pairs at IoU 0.85 to a few ulps at [32, 2304] and [4,
     3600]; times at the train step's shapes beside the host versions with
     their device read and the bound by bytes.
 11. train_cached: the same recipe with training.cache_backbone, the device
     pool sized for config.yaml's 2500 images, 64 of them trained on: epoch
     1 (2 steps) fills the pool, epoch 2 (2 steps, no pixels) gathers.
     Default run (bf16 pool): launch counts (11 pk_fwd per filled batch, 1
     pk_fwd, 1 pk_dq and 1 pk_dkv per step), stored rows bit-equal to a fresh
     embed_prefix, finite terms, frozen and trainable parameters; then one
     tail step under OWLVIT_PACKED_FLASH=0 (the transposed backward) against
     the packed step from the same state (terms equal, gradients and update
     within 1e-4 in L2); then OWLVIT_FUSED_LN=1 with the int8 pool (22
     add_ln_fwd per filled batch, 2 add_ln_fwd and 2 add_ln_bwd per step,
     the attention backward the split pair as on the JAX fused branch;
     rows within rowmax/254; epoch-1 terms against the unfused run). Host wall, CUDA events per phase and peak memory of each.
 11b. bench_cached: utils/bench_cached.measure_cached_steady_state("b16",
     32, 20): the prefix once, then 1 + 20 steps each of the resident, the
     gathered (a 2 GB zero pool, 564 rows) and the split tail step
     (AdamW 3e-6, weight decay 0.1; 16 GT slots, 8 valid); then the
     uncached full step on the same recipe, 1 + 20 steps timed with
     utils/profiling.StepTimer. Between them the gathered step in turns
     with the default backward (the pair) and under OWLVIT_PACKED_BWD=fused
     (pair, fused, fused, pair; resident and gathered steps each turn).
     img/s, the losses (finite), MFU from utils/flops.py against
     chip_peak_flops(the card's name), launches (11 + 63 pk_fwd and 63 of
     each of pk_dq, pk_dkv, jv_assign, propagate_labels; each turn 11 + 42
     pk_fwd and 42 pk_bwd or pair launches; then 12, 1, 1, 1, 1 per uncached
     step), peak memory of each part.
 12. run: the fine-tune run as users start it, through Trainer.with_data
     (the smoke's own in-memory data: 96 train and 32 test 768x768 images
     of 1-4 filled rectangles on plain backgrounds, 4 classes, made with
     numpy from the seed; a GPU host may have no image decoder):
     B/16 bf16, random weights (seed 0), the query bank built on the card
     by the text tower from the HashTokenizer ids of 3 prompts x 4 classes,
     trainable_last_k 1, the device store, batch 32, lr 3e-6, weight decay
     0.1. Run 1: 2 epochs, eval after each, checkpoints and the JSONL log
     in a temporary directory; run 2 (n_epochs 3) resumes at step 6 and
     trains one epoch; run 3 trains nothing and evaluates. Checks: JSONL
     rows 2 then 3 (finite train terms, val_map in [-1, 1], 4 per-class
     mAPs), class_maps.json, the resumed trainable parameters bit-equal to
     the saved ones, the bank on the card with unit rows, the first eval
     batch's packed detections bit-equal to a direct forward + NMS, and the
     launches of each run (run 1: 12 pk_fwd per filled step and per eval
     batch, 1 per gathered step, 1 pk_dq and 1 pk_dkv per step). Epoch walls and img/s,
     eval s/image, the bank's build time, peak memory, and whether Pillow,
     png.h and jpeglib.h exist on the machine.
 13. export: B/16 bf16, random weights (seed 0), 240 queries, batch 8:
     export_detector and export_detector_weightless (torch.export) saved
     and loaded; each loaded program on 8 random uint8 images within 1e-5
     max-rel of the eager forward_train (and whether bit-equal), 12 pk_fwd
     launches a call and no plain attention, its ms per batch beside
     eager's; the artifacts' bytes and the export and load walls. Then the
     CLI's export --weightless and eval --from-export --export-params on
     phase 12's checkpoints (a synthetic PNG test set of 16 images), the
     metrics within 1e-8 of the CLI's direct eval and the kept detections
     (--save-detections) equal.
 13b. stage: training.stage_pixels: on through Trainer.with_data, B/16
     bf16, batch 32, max_gt 16, 256 + 32 in-memory images, the split
     backward (OWLVIT_PACKED_BWD=both): the cached device store for 3
     epochs (the first fills the store from the staged pixels, then 2
     device epochs under torch.cuda.set_sync_debug_mode("error")) and one
     uncached epoch (a device epoch), each against the streamed run of the
     same config (the cached pair in turns: staged, streamed, streamed,
     staged): JSONL terms, val_map and trained parameters bit-equal, the
     image pool released after the fill, launches as the paths imply;
     epoch walls and img/s of the six runs, and the "match" phase's device
     ms on one more gathered step.
 14. train_options: the fine-tune options at B/16 bf16, batch 32, random
     weights (seed 0). (a) The hflip recipe through Trainer.with_data on
     phase 12's in-memory images (96 + 32): cache_backbone with the "auto"
     store, augment_hflip, grad_accum 2, ema_decay 0.999, ema_eval,
     keep_best, the device pool sized for config.yaml's 2500 images x 2 rows
     (17.7 GB); 2 epochs, then a run resumed from the epoch-1 checkpoint
     (step 3, in the middle of an accumulation) for one more epoch. Checks:
     auto resolves to the device and the banner prints the pool and the
     budget; 22 + 1 pk_fwd and 1 pk_dq and 1 pk_dkv per filled step, 1 and
     1 and 1 per gathered step; the stored rows 2i and 2i+1 bit-equal to a fresh
     embed_prefix of the pixels and of their mirror; the trainable
     parameters bit-unchanged after each odd micro-step, every one moved
     after each even one; the EMA bit-equal to its recursion recomputed from
     the parameters; the resumed accumulator, micro-step and EMA bit-equal
     to those saved; evaluate's packed detections bit-equal to a direct
     forward on the EMA weights, the trained parameters left as they were.
     (b) One cached and one uncached hflip step from the same state and
     flips: the stored rows bit-equal to the uncached step's prefix, the
     terms within 1e-3. (c) trainable_last_k 12, uncached (JAX's scanned
     case: the split pair): 2 steps with remat off and on from the same
     states (12 pk_fwd + 12 pk_dq + 12 pk_dkv against 24 + 12 + 12), terms
     bit-equal, the no-remat step repeated from the same state bit-equal in
     every gradient, remat against no remat within 1e-3 in L2, peak memory
     lower with remat; one remat step under OWLVIT_FUSED_LN=1 (add_ln_fwd
     twice per boundary, add_ln_bwd once). (d) 2 uncached steps with augment (colour 0.4, scale
     0.7-1.3), replayed from the same states: terms bit-equal. (e) A cached
     run with profile_dir: the Chrome trace of steps 1-2 names pk_fwd,
     pk_dq and pk_dkv; its device kernels summed by name per step.
 15. mesh: (a) a mesh of one rank on NCCL (create_mesh(1, 1, backend=
     "nccl")): one B/16 bf16 step through the loss's count all_reduce, the
     gradient all_reduce and the tensor-parallel Functions on groups of one,
     bit-equal to the plain step (terms, gradients, parameters). (b) Two
     ranks spawned on cuda:0 over gloo (NCCL refuses two ranks on one
     device): dp=2 at a global batch of 32, uncached and cached (the device
     pool of 64 images, 32 rows a rank, fill, fill, gather), and dp=1 x
     tp=2 (6 heads a rank), 3 steps each in backward mode "both", and tp=2's
     step 1 in fp32; each held against the single-device run of the same
     global batches in this call (TOL_MESH: terms; step-1 gradient and the
     update against the single-device bf16 run's own distance from fp32),
     launches per rank, and each rank's step wall ("two ranks share one
     card": no scaling figure).
The kernels JSON (second-to-last line) gives each kernel's launches summed
over the paths driven (serving, the open-vocabulary lanes, bulk_detect
and the CLI's inference commands, the mesh servers, the uncached and
cached train runs, bench_cached's steps, the
three fine-tune runs, the exported programs and the CLI's evals through
and beside them, the staged and streamed runs, the training options'
drives, the mesh phase's runs (each rank's counts added), and for the
transposed
entries alone the drives of phase 6; each counted from 0 just
before it and read just after, each launch once, where the wrapper makes it),
its error, time, plain time, bound and library time at its main-path shape;
the line before it is nvidia-smi's name and power limit again, the last line
the device JSON. Any failure raises, so the exit code is non-zero.
"""

import contextlib
import copy
import dataclasses
import gc
import hashlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import tempfile
import time
import types

# bitwise-reproducible cuBLAS across the server's thread and the main thread,
# for the bit-equality check of phase 5; a production server does not set it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from owlvit_tpu_torch import cli  # noqa: E402
from owlvit_tpu_torch.data.dataset import DetectionDataset  # noqa: E402
from owlvit_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from owlvit_tpu_torch.models import get_config, owlvit, vit  # noqa: E402
from owlvit_tpu_torch.ops import _cuda, fused_ln, losses, matcher  # noqa: E402
from owlvit_tpu_torch.ops import flash_attention as fa  # noqa: E402
from owlvit_tpu_torch.ops import nms as nms_ops  # noqa: E402
from owlvit_tpu_torch.ops.quant import dequantize_rows  # noqa: E402
from owlvit_tpu_torch.ops.preprocess import normalize_image  # noqa: E402
from owlvit_tpu_torch.parallel import create_mesh, shard_aligned_batches  # noqa: E402
from owlvit_tpu_torch.serve import (  # noqa: E402
    DetectorServer, _flatten_bucket, _Request, _size_to_model)
from owlvit_tpu_torch.train import Trainer  # noqa: E402
from owlvit_tpu_torch.train.state import partition_params  # noqa: E402
from owlvit_tpu_torch.utils import bench_cached, flops  # noqa: E402
from owlvit_tpu_torch.utils.profiling import StepTimer  # noqa: E402
from owlvit_tpu_torch.utils.config import (  # noqa: E402
    Config, DataConfig, ModelConfig, TrainingConfig)

_BWD_SRC = "owlvit_tpu_torch/csrc/flash_attention_bwd.cu"
KERNELS = {
    "pk_fwd": ("owlvit_tpu_torch/csrc/flash_attention_fwd.cu",
               "owlvit_tpu/ops/flash_attention.py:368"),
    "pk_bwd": (_BWD_SRC, "owlvit_tpu/ops/flash_attention.py:654"),
    # the split pair (mode "both"): dq by query tile, dk and dv by key tile
    "pk_dq": (_BWD_SRC, "owlvit_tpu/ops/flash_attention.py:567"),
    "pk_dkv": (_BWD_SRC, "owlvit_tpu/ops/flash_attention.py:608"),
    "add_ln_fwd": ("owlvit_tpu_torch/csrc/fused_ln.cu",
                   "owlvit_tpu/ops/fused_ln.py:50"),
    "add_ln_bwd": ("owlvit_tpu_torch/csrc/fused_ln.cu",
                   "owlvit_tpu/ops/fused_ln.py:63"),
    # the transposed functions run the packed kernels at num_heads=1: the
    # forward and, in the backward, the split pair
    "transposed_fwd": ("owlvit_tpu_torch/csrc/flash_attention_fwd.cu",
                       "owlvit_tpu/ops/flash_attention.py:73"),
    "transposed_dq": (_BWD_SRC, "owlvit_tpu/ops/flash_attention.py:136"),
    "transposed_dkv": (_BWD_SRC, "owlvit_tpu/ops/flash_attention.py:159"),
    # not Pallas kernels: the JAX matcher's solver and the label propagation,
    # lax loops that XLA runs on the device inside the train step
    "jv_assign": ("owlvit_tpu_torch/csrc/matcher.cu", "owlvit_tpu/ops/matcher.py:32"),
    "propagate_labels": ("owlvit_tpu_torch/csrc/matcher.cu", "owlvit_tpu/ops/losses.py:55"),
}
# each kernel's launch counter: (wrapper, attribute), added to where the
# wrapper launches; pk_fwd, pk_dq and pk_dkv count a one-head launch (the
# transposed layout) under transposed_launches and no other
COUNTERS = {"pk_fwd": (fa.pk_fwd, "launches"), "pk_bwd": (fa.pk_bwd, "launches"),
            "pk_dq": (fa.pk_dq, "launches"), "pk_dkv": (fa.pk_dkv, "launches"),
            "add_ln_fwd": (fused_ln.add_ln_fwd, "launches"),
            "add_ln_bwd": (fused_ln.add_ln_bwd, "launches"),
            "transposed_fwd": (fa.pk_fwd, "transposed_launches"),
            "transposed_dq": (fa.pk_dq, "transposed_launches"),
            "transposed_dkv": (fa.pk_dkv, "transposed_launches"),
            "jv_assign": (matcher.jv_assign, "launches"),
            "propagate_labels": (losses.propagate_labels, "launches")}
SWITCHES = ("OWLVIT_FUSED_LN", "OWLVIT_PACKED_FLASH", "OWLVIT_PACKED_BWD")
BATCH = 4
C = fa.STATIC_MAX_DEFAULT
# Tolerances. Forward, bf16: both sides round p to bf16 and differ in
# summation order, so o is held to 2e-2 of its largest magnitude; lse is fp32
# on both. fp32: summation order and exp rounding only.
TOL_BF16_O_REL, TOL_BF16_LSE = 2e-2, 1e-3
TOL_F32 = 1e-4
# Backward, bf16: both sides round ds and p to bf16 at the same points, but a
# value at a rounding boundary can fall either way (exp and sums differ in
# their last fp32 bits, and the fused kernel adds dq up with fp32 reductions
# in an order that changes from run to run), so dq, dk and dv are held to
# 2e-2 of their largest magnitude, as the forward's o; the fused kernel and
# the split pair alike. fp32 (no atomics): 1e-4 of the largest magnitude,
# summation order over up to 3712 keys.
TOL_BWD_BF16_REL, TOL_BWD_F32_REL = 2e-2, 1e-4
# Two launches of the fused bf16 backward (OWLVIT_PACKED_BWD=fused) on the
# same inputs: dk and dv bit-equal; dq adds its key tiles' partials with
# reductions in an order that changes from run to run, so its fp32 sums
# differ in their last bits and the cast to bf16 may round an element one
# ulp the other way: at most 2^-7 of that element, so of the largest
# magnitude. The split pair, the default, sums dq, dk and dv in a fixed
# order: its two launches are bit-equal in all three.
TOL_DQ_REPEAT_REL = 2.0**-7
TOL_SLICE = 3e-2  # kernel vs plain attention, pre-NMS sims and boxes, 12 bf16 layers
# The trained layer, kernel path vs plain path under autograd, bf16, max-rel.
# y, dx and the v and out weight grads: 3e-2, as the served slice (the two
# backward graphs round at different points: the plain path's autograd
# rounds dp to bf16, the kernel ds). The q and k weight grads: 0.15. The
# kernel rounds ds to bf16 before the dq and dk products, as the TPU kernel
# does; the rounded rows of ds no longer sum to zero, and the keys' shared
# mean turns that into a few % of error on these two grads (4-6% against an
# fp32 reference at B/16 with the plain versions of the same rounding, on the
# CPU, where the plain path errs by 0.6%). An fp32 run of the layer is the
# reference both bf16 paths are reported against.
TOL_LAYER = {"y": 3e-2, "dx": 3e-2, "dq_w": 0.15, "dk_w": 0.15, "dv_w": 3e-2,
             "dout_w": 3e-2}
# add_ln, kernel vs plain on the same inputs. r: exact (one add, rounded
# once on both sides). y and g: bf16 1e-2 of the largest magnitude (the
# fp32 statistics differ in their last bits, so a value at a bf16 rounding
# boundary can fall either way: one ulp, 0.4-0.8%); fp32 1e-5 of it
# (summation order and rsqrt over D <= 1024). dscale and dbias: sums over N
# rows in another order, held to 1e-5 of the column's sum of magnitudes.
TOL_LN = {"bf16": 1e-2, "f32": 1e-5}
TOL_LN_SUM = 1e-5
# The cached train step. Under OWLVIT_FUSED_LN=1 an LN output may differ by
# one bf16 ulp where the rounding falls either way; that propagates through
# the 11 frozen bf16 layers at bf16 noise, and a Hungarian assignment may
# flip on a near-tie: epoch-1 loss terms rtol 2e-2 against the unfused run.
# OWLVIT_PACKED_FLASH=0 changes only the backward (the split pair at one head
# per sequence against the pair at the layer's heads), so the terms are
# bit-equal, and the gradients of every trained parameter are within 1e-4 of
# the packed step's in L2 norm (2.8e-6 read on the update on an H100 80GB
# when the packed step took the fused kernel).
# The update is held to the same 1e-4, without the key bias: its gradient is
# 0 in exact arithmetic (a per-query shift of all scores leaves the softmax
# unchanged), so it is rounding noise that AdamW scales to a full step. Its
# gradient is in the gradient check.
TOL_FUSED_TERMS = 2e-2
TOL_HYBRID_GRAD = TOL_HYBRID_UPDATE = 1e-4
# H100 SXM datasheet peaks (dense): the bound of a launch is the larger of
# its bytes over the memory rate and its flops over the tensor-core rate
# (fp32 outside the tensor cores for elementwise work).
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
PEAK_F32_FLOPS = 67e12
# A B/16 layer's attention on one rank at tp=2: [B, 2305, 384], 6 heads of 64
TP2_LOCAL = dataclasses.replace(get_config("b16").vision, hidden_size=384, num_heads=6)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=5):
    """Device time per call of fn, summed over the kernels it launches
    (torch.profiler): at small shapes the wrapper's host work, which CUDA
    events between calls include, can take longer than its kernels."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us else "not measured: the profiler saw no device events"


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def max_rel(a, b):
    return max_abs(a, b) / b.float().abs().max().item()


def matched(steps):
    """The matcher's launches in `steps` train steps: one assignment and one
    label propagation a step (the loss of each micro-step)."""
    return {"jv_assign": steps, "propagate_labels": steps}


def pair(n):
    """The default attention backward's launches in n trained-layer
    backwards: the split pair, pk_dq then pk_dkv, once each."""
    return {"pk_dq": n, "pk_dkv": n}


def reset_counts():
    for wrapper, attr in COUNTERS.values():
        setattr(wrapper, attr, 0)


def read_counts():
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in COUNTERS.items()}


@contextlib.contextmanager
def switches(**values):
    """Set the JAX package's switches (None: unset) for one run, then
    restore the environment."""
    def apply(settings):
        for k, v in settings.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    old = {k: os.environ.get(k) for k in values}
    try:
        apply(values)
        yield
    finally:
        apply(old)


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the least time for the work on an H100 SXM."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fwd_bound(B, S, D, H, elt=2):
    """q, k, v read, o written, lse written; two products of 2*S*S*hd."""
    return bound(4 * B * H * S * S * (D // H), 4 * B * S * D * elt + B * H * S * 4)


def bwd_bound(B, S, D, H, elt=2):
    """q, k, v, o, do and lse read, dq, dk, dv written; five products."""
    return bound(10 * B * H * S * S * (D // H), 8 * B * S * D * elt + B * H * S * 4)


def dq_bound(B, S, D, H, elt=2):
    """The pair's dq kernel: q, k, v, o, do and lse read, dq and delta
    written; three products (s, dp, dq)."""
    return bound(6 * B * H * S * S * (D // H), 6 * B * S * D * elt + 2 * B * H * S * 4)


def dkv_bound(B, S, D, H, elt=2):
    """The pair's dkv kernel: q, k, v, do, lse and delta read, dk and dv
    written; four products (s, dp, dv, dk)."""
    return bound(8 * B * H * S * S * (D // H), 6 * B * S * D * elt + 2 * B * H * S * 4)


def heads4(x, H):
    B, S, D = x.shape
    return x.view(B, S, H, D // H).transpose(1, 2)


def sdpa_ms(q, k, v, H, scale, do=None):
    """scaled_dot_product_attention at the same shape, forward alone (no
    grad), or forward + backward with cotangent do: a yardstick only, the
    port never calls it."""
    qh, kh, vh = (heads4(x, H) for x in (q, k, v))
    if do is None:
        with torch.no_grad():
            return cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 10)
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]

    def fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, scale=scale)
        torch.autograd.grad(o, leaves, heads4(do, H))

    return cuda_ms(fwd_bwd, 10)


def sdpa_bwd_ms(q, k, v, H, scale, do):
    """The library's attention backward alone at the same shape: the flash
    backward, else the memory-efficient one where the flash kernel is not
    built, fed with the outputs and logsumexp of that library's own forward
    (called once, outside the timing). A yardstick only, the port never
    calls it. Returns (ms, the op's name)."""
    aten = torch.ops.aten
    try:
        qh, kh, vh, doh = (heads4(x, H) for x in (q, k, v, do))
        o, lse, cum_q, cum_k, max_q, max_k, seed, offset = \
            aten._scaled_dot_product_flash_attention(qh, kh, vh, scale=scale)[:8]
        return cuda_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            doh, qh, kh, vh, o, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset,
            scale=scale), 10), "aten._scaled_dot_product_flash_attention_backward"
    except RuntimeError:  # no flash kernel for this card or build
        B, S, D = q.shape
        qm, km, vm, dom = (x.view(B, S, H, D // H) for x in (q, k, v, do))  # [B, S, H, hd]
        o, lse, seed, offset, max_q, max_k = aten._efficient_attention_forward(
            qm, km, vm, None, None, None, None, None, 0.0, 0, True, scale=scale)
        return cuda_ms(lambda: aten._efficient_attention_backward(
            dom, qm, km, vm, None, o, None, None, max_q, max_k, lse, 0.0, seed, offset, 0,
            False, scale=scale), 10), "aten._efficient_attention_backward"


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)


def phase_build():
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    report = _cuda.ptxas_report(lib_path)
    # the bf16 attention kernels on keys of their own: the forward (both
    # softmax modes), the fused backward (and its delta kernel), the pair's
    # dq kernel and its dkv kernel (with and without q * scale tiles)
    fwd, bwd, dq, dkv = ({name: lines for name, lines in report.items()
                          if kern in name and "bf16" in name}
                         for kern in ("pk_fwd", "pk_bwd", "pk_dq", "pk_dkv"))
    check(len(fwd) == 2 and len(bwd) == 2 and len(dq) == 1 and len(dkv) == 2,
          f"ptxas report of the bf16 attention kernels: {fwd} {bwd} {dq} {dkv}")
    check(all("0 bytes spill stores" in " ".join(lines)
              for lines in (*fwd.values(), *dq.values(), *dkv.values())),
          f"the bf16 attention forward or the split pair spills registers: {fwd} {dq} {dkv}")
    serialized = {name: lines for name, lines in {**fwd, **bwd, **dq, **dkv}.items()
                  if _cuda.wgmma_serialized(lines)}
    check(not serialized, f"ptxas serialises the wgmma of bf16 attention kernels: {serialized}")
    # the bf16 add+LN backward, one instantiation per width (D = 256 .. 1024):
    # registers and spills, its dynamic shared memory and blocks per SM
    ln_bwd = {name: lines for name, lines in report.items()
              if "add_ln_bwd_kernel" in name and "bfloat16" in name}
    check(len(ln_bwd) == 4, f"ptxas report of the bf16 add_ln backward: {ln_bwd}")
    check(all("0 bytes spill stores" in " ".join(lines) for lines in ln_bwd.values()),
          f"the bf16 add_ln backward spills registers: {ln_bwd}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ln_widths = {D: {"dynamic_smem_bytes": fused_ln.bwd_smem_bytes(D, torch.bfloat16, "cuda"),
                     "blocks_per_sm": fused_ln._bwd_resident_blocks(
                         0, fused_ln.DTYPE_CODE[torch.bfloat16], D) / sms}
                 for D in (256, 512, 768, 1024)}
    dev0 = torch.device("cuda", 0)
    pk_dq_bf16 = {"ptxas": next(iter(dq.values())),
                  "dynamic_smem_bytes": _cuda.query("owlvit_pk_dq_smem_bytes", dev0)}
    # pk_dkv_bf16<false> (the scale folded) and <true> (q * scale tiles)
    pk_dkv_bf16 = {"ptxas": dkv, "dynamic_smem_bytes": {
        kind: _cuda.query("owlvit_pk_dkv_smem_bytes", dev0, qs)
        for qs, kind in ((0, "scale_folded"), (1, "q_scaled_tiles"))}}
    # the matcher's two kernels (csrc/matcher.cu), one instantiation each
    match_kernels = {name: lines for name, lines in report.items()
                     if "jv_assign_kernel" in name or "propagate_labels_kernel" in name}
    check(len(match_kernels) == 2, f"ptxas report of the matcher kernels: {match_kernels}")
    emit("build", seconds=build_s, library=lib_path.name, ptxas=report,
         ptxas_matcher=match_kernels,
         ptxas_pk_fwd_bf16=fwd, ptxas_pk_bwd_bf16=bwd, ptxas_pk_dq_bf16=dq, pk_dq_bf16=pk_dq_bf16,
         pk_dkv_bf16=pk_dkv_bf16,
         ptxas_add_ln_bwd_bf16=ln_bwd,
         add_ln_bwd_bf16_by_width=ln_widths)


def attention_shapes():
    """(name, S padded to a 128 multiple, valid_len, H, D, scale) per model."""
    for name in ("b32", "b16", "l14"):
        vc = get_config(name).vision
        valid = vc.num_patches + 1
        yield (name, -(-valid // 128) * 128, valid, vc.num_heads, vc.hidden_size,
               vc.head_dim**-0.5)


def phase_kernel():
    """Forward kernel vs plain at the three attention shapes; raises on a
    disagreement."""
    for name, S, valid, H, D, scale in attention_shapes():
        g = torch.Generator(device="cuda").manual_seed(len(name) + S)
        q, k, v = (torch.randn(BATCH, S, D, generator=g, device="cuda")
                   for _ in range(3))
        row = {"shape": [BATCH, S, D], "heads": H, "valid_len": valid}
        for dtype, static, ref_static in ((torch.bfloat16, C, C),
                                          (torch.bfloat16, None, None),
                                          (torch.float32, None, None),
                                          (torch.float32, C, None)):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            args = dict(scale=scale, num_heads=H, valid_len=valid)
            o_k, l_k = fa.pk_fwd(qd, kd, vd, static_max=static, **args)
            o_p, l_p = fa.pk_fwd_plain(qd, kd, vd, static_max=ref_static, **args)
            torch.cuda.synchronize()
            o_k, o_p = o_k[:, :valid], o_p[:, :valid]
            l_k, l_p = l_k[..., :valid], l_p[..., :valid]
            check(torch.isfinite(o_k).all().item() and torch.isfinite(l_k).all().item(),
                  f"{name} {dtype} static={static}: non-finite kernel output")
            key = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_" \
                  f"{'static' if static is not None else 'dynamic'}"
            err = {"o_max_abs": max_abs(o_k, o_p), "o_max_rel": max_rel(o_k, o_p),
                   "lse_max_abs": max_abs(l_k, l_p)}
            if dtype == torch.bfloat16:
                check(err["o_max_rel"] <= TOL_BF16_O_REL and err["lse_max_abs"] <= TOL_BF16_LSE,
                      f"{name} {key}: {err}")
            else:
                check(err["o_max_abs"] <= TOL_F32 and err["lse_max_abs"] <= TOL_F32,
                      f"{name} {key}: {err}")
            if key in ("bf16_static", "f32_dynamic"):
                err["ms"] = cuda_ms(lambda: fa.pk_fwd(qd, kd, vd, static_max=static, **args), 10)
                err["plain_ms"] = cuda_ms(
                    lambda: fa.pk_fwd_plain(qd, kd, vd, static_max=static, **args), 3)
            row[key] = err
            del o_k, o_p, l_k, l_p
        emit("kernel", model=name, **row)
        del q, k, v
        torch.cuda.empty_cache()
    # a B/16 layer's local shape at tp=2 on the mesh (phase 15): 6 of 12 heads
    emit("kernel", model="b16_tp2_local", heads=TP2_LOCAL.num_heads,
         **fwd_row(TP2_LOCAL, 32, None))


def bwd_errors(got, want, valid):
    """Max abs / rel of dq, dk, dv over real rows, and whether the rows at
    and past valid_len are exactly zero in the kernel's output."""
    err = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(torch.isfinite(g).all().item(), f"non-finite kernel {name}")
        err[f"{name}_max_abs"] = max_abs(g[:, :valid], w[:, :valid])
        err[f"{name}_max_rel"] = max_rel(g[:, :valid], w[:, :valid])
        check(not g[:, valid:].any().item(), f"kernel {name} rows >= valid_len not 0")
    return err


def check_bwd(err, dtype, what):
    tol = TOL_BWD_BF16_REL if dtype == torch.bfloat16 else TOL_BWD_F32_REL
    worst = max(err[f"{n}_max_rel"] for n in ("dq", "dk", "dv"))
    check(worst <= tol, f"{what}: {err}")


def phase_kernel_bwd():
    """Backward kernels vs plain at the padded model shapes and at the
    unpadded [8, 2305, 768], bf16 and fp32: the fused kernel, and the split
    pair (pk_dq then pk_dkv), whose two launches are bit-equal; then the
    pair in bf16 at B/16's padded shape with scale 0.1, where the dq kernel
    reads k * scale from its scratch instead of folding the scale."""
    b16 = get_config("b16").vision
    shapes = [*attention_shapes(),
              ("b16_unpadded_b8", b16.num_patches + 1, b16.num_patches + 1,
               b16.num_heads, b16.hidden_size, b16.head_dim**-0.5)]
    for name, S, valid, H, D, scale in shapes:
        batch = 8 if name.endswith("_b8") else BATCH
        g = torch.Generator(device="cuda").manual_seed(101 + S)
        q, k, v, do = (torch.randn(batch, S, D, generator=g, device="cuda")
                       for _ in range(4))
        row = {"shape": [batch, S, D], "heads": H, "valid_len": valid}
        for dtype in (torch.bfloat16, torch.float32):
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            args = dict(scale=scale, num_heads=H, valid_len=valid)
            o, lse = fa.pk_fwd(qd, kd, vd, **args)
            got = fa.pk_bwd(qd, kd, vd, o, lse, dod, **args)
            pair = fa.pk_bwd_split(qd, kd, vd, o, lse, dod, **args)
            again = fa.pk_bwd_split(qd, kd, vd, o, lse, dod, **args)
            want = fa.pk_bwd_plain(qd, kd, vd, o, lse, dod, **args)
            torch.cuda.synchronize()
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            err = bwd_errors(got, want, valid)
            check_bwd(err, dtype, f"{name} {key}")
            err["pair"] = bwd_errors(pair, want, valid)
            check_bwd(err["pair"], dtype, f"{name} {key} split pair")
            err["pair"]["repeat_bit_equal"] = all(torch.equal(a, b) for a, b in zip(pair, again))
            check(err["pair"]["repeat_bit_equal"],
                  f"{name} {key}: two launches of the split pair differ")
            del got, pair, again, want
            err["ms"] = cuda_ms(lambda: fa.pk_bwd(qd, kd, vd, o, lse, dod, **args), 5)
            err["pair"]["ms"] = cuda_ms(lambda: fa.pk_bwd_split(qd, kd, vd, o, lse, dod, **args), 5)
            err["plain_ms"] = cuda_ms(
                lambda: fa.pk_bwd_plain(qd, kd, vd, o, lse, dod, **args), 2)
            row[key] = err
            del qd, kd, vd, dod, o, lse
            torch.cuda.empty_cache()
        emit("kernel_bwd", model=name, **row)
        del q, k, v, do
        torch.cuda.empty_cache()
    # the dq kernel's other path: at a scale that is not a power of two,
    # bf16(k * scale) is not exact and the kernel reads a scratch that a
    # launch before it fills (every model here has scale 1/8, which it folds)
    name, S, valid, H, D, _ = next(shape for shape in shapes if shape[0] == "b16")
    g = torch.Generator(device="cuda").manual_seed(103)
    q, k, v, do = (torch.randn(BATCH, S, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    args = dict(scale=0.1, num_heads=H, valid_len=valid)
    check(not fa.scale_is_exact_in_bf16(args["scale"]), "scale 0.1 is exact in bf16")
    o, lse = fa.pk_fwd(q, k, v, **args)
    pair = fa.pk_bwd_split(q, k, v, o, lse, do, **args)
    again = fa.pk_bwd_split(q, k, v, o, lse, do, **args)
    err = bwd_errors(pair, fa.pk_bwd_plain(q, k, v, o, lse, do, **args), valid)
    check_bwd(err, torch.bfloat16, f"{name} bf16 split pair, scale 0.1")
    err["repeat_bit_equal"] = all(torch.equal(a, b) for a, b in zip(pair, again))
    check(err["repeat_bit_equal"], f"{name} bf16 scale 0.1: two launches of the split pair differ")
    emit("kernel_bwd", model=name, scale=args["scale"], shape=[BATCH, S, D], heads=H,
         valid_len=valid, pair_bf16=err)
    del q, k, v, do, o, lse, pair, again
    torch.cuda.empty_cache()
    # the fused kernel and the pair at the tp=2 local shape, 6 heads
    trained_shape_bwd(types.SimpleNamespace(vision=TP2_LOCAL), label="kernel_bwd_tp2_local")


def trained_shape_bwd(cfg, batch=32, slice_=4, label="kernel_bwd_trained_shape"):
    """pk_bwd and the split pair (pk_dq, pk_dkv) at the train step's shape,
    bf16, per-row max, all 2305 tokens real. The plain versions (one [B, H,
    S, S] fp32 tensor is 8.2 GB at batch 32) run on batch slices of 4, for
    the comparison and their times. Two launches each: the fused kernel's dk
    and dv bit-equal and dq within its reductions' fp32 order, the pair's
    dq, dk and dv bit-equal. Times in turns (fused, pair, pair, fused)
    beside the library's attention backward alone (`sdpa_bwd_ms`: the
    library time of the fused kernel, of the pair and of each half) and
    scaled_dot_product_attention's forward + backward."""
    vc = cfg.vision
    S, D, H, scale = vc.num_patches + 1, vc.hidden_size, vc.num_heads, vc.head_dim**-0.5
    g = torch.Generator(device="cuda").manual_seed(32)
    q, k, v, do = (torch.randn(batch, S, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    args = dict(scale=scale, num_heads=H)
    o, lse = fa.pk_fwd(q, k, v, **args)
    got = fa.pk_bwd(q, k, v, o, lse, do, **args)
    dq_k, delta = fa.pk_dq(q, k, v, o, lse, do, **args)
    pair = (dq_k, *fa.pk_dkv(q, k, v, lse, do, delta, **args))
    diff, diff_pair, peak = [0.0] * 3, [0.0] * 3, [0.0] * 3
    plain_ms = dq_plain_ms = dkv_plain_ms = 0.0
    for i in range(0, batch, slice_):
        part = [x[i:i + slice_] for x in (q, k, v, o, lse, do)]
        want = fa.pk_bwd_plain(*part, **args)
        for j in range(3):
            diff[j] = max(diff[j], max_abs(got[j][i:i + slice_], want[j]))
            diff_pair[j] = max(diff_pair[j], max_abs(pair[j][i:i + slice_], want[j]))
            peak[j] = max(peak[j], want[j].float().abs().max().item())
        del want
        plain_ms += cuda_ms(lambda: fa.pk_bwd_plain(*part, **args), 1)
        dq_plain_ms += cuda_ms(lambda: fa.pk_dq_plain(*part, **args), 1)
        qp, kp, vp, _, lp, dp = part
        dkv_plain_ms += cuda_ms(lambda: fa.pk_dkv_plain(
            qp, kp, vp, lp, dp, delta[i:i + slice_], **args), 1)
    err, err_pair = {}, {}
    for j, name in enumerate(("dq", "dk", "dv")):
        check(torch.isfinite(got[j]).all().item() and torch.isfinite(pair[j]).all().item(),
              f"non-finite kernel {name}")
        err[f"{name}_max_abs"], err[f"{name}_max_rel"] = diff[j], diff[j] / peak[j]
        err_pair[f"{name}_max_abs"] = diff_pair[j]
        err_pair[f"{name}_max_rel"] = diff_pair[j] / peak[j]
    check_bwd(err, torch.bfloat16, f"trained shape [{batch}, {S}, {D}]")
    check_bwd(err_pair, torch.bfloat16, f"trained shape [{batch}, {S}, {D}], split pair")
    # dq again: the reductions add in another order, dk and dv do not change
    again = fa.pk_bwd(q, k, v, o, lse, do, **args)
    check(torch.equal(again[1], got[1]) and torch.equal(again[2], got[2]),
          "dk, dv differ between two launches")
    dq_diff = max_abs(again[0], got[0])
    err["dq_repeat_max_abs"] = dq_diff
    err["dq_repeat_max_rel"] = dq_diff / got[0].float().abs().max().item()
    err["dq_repeat_elements_differing"] = int((again[0] != got[0]).sum().item())
    check(err["dq_repeat_max_rel"] <= TOL_DQ_REPEAT_REL,
          f"dq differs between two launches beyond the fp32 order: {err}")
    # the pair again: every output bit-equal
    again = fa.pk_bwd_split(q, k, v, o, lse, do, **args)
    err_pair["repeat_bit_equal"] = all(torch.equal(a, b) for a, b in zip(again, pair))
    check(err_pair["repeat_bit_equal"], "two launches of the split pair differ")
    del got, again, pair
    turns = []
    for fn in (fa.pk_bwd, fa.pk_bwd_split, fa.pk_bwd_split, fa.pk_bwd):
        turns.append(cuda_ms(lambda: fn(q, k, v, o, lse, do, **args), 10))
    dq_ms = cuda_ms(lambda: fa.pk_dq(q, k, v, o, lse, do, **args), 10)
    dkv_ms = cuda_ms(lambda: fa.pk_dkv(q, k, v, lse, do, delta, **args), 10)
    lib_fwd = sdpa_ms(q, k, v, H, scale)
    lib_fwd_bwd = sdpa_ms(q, k, v, H, scale, do=do)
    lib, lib_op = sdpa_bwd_ms(q, k, v, H, scale, do)
    bound_ms, bound_by = bwd_bound(batch, S, D, H)
    dq_b, dkv_b = dq_bound(batch, S, D, H), dkv_bound(batch, S, D, H)
    pair_op = f"{lib_op} (dq, dk and dv: the pair's)"
    row = {"shape": [batch, S, D], **err, "ms": (turns[0] + turns[3]) / 2,
           "plain_ms": plain_ms, "library_ms": lib, "library_op": lib_op,
           "library_fwd_ms": lib_fwd, "library_fwd_bwd_ms": lib_fwd_bwd,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "pair": {**err_pair, "ms": (turns[1] + turns[2]) / 2,
                    "plain_ms": dq_plain_ms + dkv_plain_ms, "library_ms": lib,
                    "bound_ms": dq_b[0] + dkv_b[0], "turns_ms": turns},
           # each half of the pair on its own, beside the pair's library
           # time: no library call computes only dq, or only dk and dv
           "dq": {"max_abs_err": err_pair["dq_max_abs"], "ms": dq_ms, "plain_ms": dq_plain_ms,
                  "bound_ms": dq_b[0], "bound_by": dq_b[1], "library_ms": lib,
                  "library_op": pair_op},
           "dkv": {"max_abs_err": max(err_pair["dk_max_abs"], err_pair["dv_max_abs"]),
                   "ms": dkv_ms, "plain_ms": dkv_plain_ms, "bound_ms": dkv_b[0],
                   "bound_by": dkv_b[1], "library_ms": lib, "library_op": pair_op}}
    emit(label, heads=H, **row)
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return row


def fwd_row(vc, batch, static, slice_=8):
    """pk_fwd at [batch, 2305, D] (no padding, so the last query tile is
    ragged) against its plain version on batch slices of 8, launched twice
    (o and lse bit-equal), with times and scaled_dot_product_attention's
    forward beside it."""
    S, D, H, scale = vc.num_patches + 1, vc.hidden_size, vc.num_heads, vc.head_dim**-0.5
    args = dict(scale=scale, num_heads=H, static_max=static)
    g = torch.Generator(device="cuda").manual_seed(7 + batch)
    q, k, v = (torch.randn(batch, S, D, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o_k, l_k = fa.pk_fwd(q, k, v, **args)
    check(torch.isfinite(o_k).all().item() and torch.isfinite(l_k).all().item(),
          f"shape [{batch}, {S}, {D}]: non-finite kernel output")
    o_abs = o_peak = l_abs = plain_ms = 0.0
    for i in range(0, batch, slice_):
        part = [x[i:i + slice_] for x in (q, k, v)]
        o_p, l_p = fa.pk_fwd_plain(*part, **args)
        o_abs = max(o_abs, max_abs(o_k[i:i + slice_], o_p))
        o_peak = max(o_peak, o_p.float().abs().max().item())
        l_abs = max(l_abs, max_abs(l_k[i:i + slice_], l_p))
        del o_p, l_p
        plain_ms += cuda_ms(lambda: fa.pk_fwd_plain(*part, **args), 3)
    err = {"o_max_abs": o_abs, "o_max_rel": o_abs / o_peak, "lse_max_abs": l_abs}
    check(err["o_max_rel"] <= TOL_BF16_O_REL and err["lse_max_abs"] <= TOL_BF16_LSE,
          f"shape [{batch}, {S}, {D}]: {err}")
    # the forward adds nothing up across blocks: a second launch is bit-equal
    o_again, l_again = fa.pk_fwd(q, k, v, **args)
    err["repeat_bit_equal"] = torch.equal(o_again, o_k) and torch.equal(l_again, l_k)
    check(err["repeat_bit_equal"], f"shape [{batch}, {S}, {D}]: two launches differ")
    del o_again, l_again
    bound_ms, bound_by = fwd_bound(batch, S, D, H)
    row = {"shape": [batch, S, D], "softmax": "dynamic" if static is None else f"C={static}",
           **err, "ms": cuda_ms(lambda: fa.pk_fwd(q, k, v, **args), 20),
           "plain_ms": plain_ms,
           "library_ms": sdpa_ms(q, k, v, H, scale),
           "bound_ms": bound_ms, "bound_by": bound_by}
    del q, k, v, o_k, l_k
    torch.cuda.empty_cache()
    return row


def phase_slice():
    cfg = get_config("b16", dtype="bfloat16")
    params = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=240).to("cuda")
    S = cfg.vision.image_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (9, S, S, 3), dtype=np.uint8)

    reset_counts()
    t_start = time.perf_counter()
    srv = DetectorServer(params, cfg, buckets=(1, 8), device="cuda",
                         autostart=False)  # warms up both buckets
    warmup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    futs = [srv.submit(im) for im in images]
    srv.start()  # all 9 are queued: one batch of 8, one of 1
    results = [f.result() for f in futs]
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    stats = srv.stats()
    srv.close()

    forward_batches = stats["batches"] + len(srv.buckets)  # + warmup
    check(stats["bucket_counts"] == {1: 1, 8: 1}, f"buckets {stats['bucket_counts']}")
    check(launches["pk_fwd"] == cfg.vision.num_layers * forward_batches,
          f"{launches} launches for {forward_batches} forward batches")
    check(all(n == 0 for k, n in launches.items() if k != "pk_fwd"),
          f"serving launched another kernel: {launches}")
    for res in results:
        b, s = res["boxes"], res["scores"]
        check(np.isfinite(b).all() and np.isfinite(s).all(), "non-finite result")
        check(((s >= 0) & (s <= 1)).all(), "score outside [0, 1]")
        check(((b[:, 2] >= b[:, 0]) & (b[:, 3] >= b[:, 1])).all(), "unordered box")
        # the box head puts centres in [0, 1] (sigmoid); edges may pass it
        cx, cy = (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2
        check(((cx >= 0) & (cx <= S) & (cy >= 0) & (cy <= S)).all(),
              "box centre outside the image")

    # the 8-image batch again, directly: forward + postprocess + pack
    flat = torch.from_numpy(_flatten_bucket(list(images[:8]), 8, S)).cuda()
    with torch.inference_mode():
        px = normalize_image(flat.reshape(8, S, S, 3))
        boxes, sims = owlvit.forward_train(params, srv.cfg, px)
        packed = nms_ops.pack_detections(
            nms_ops.postprocess(boxes, sims, confidence_threshold=0.01,
                                iou_threshold=0.6, top_k=200)).cpu().numpy()
        boxes_p, sims_p = owlvit.forward_train(
            params, srv.cfg.replace(attention_impl="xla"), px)
    for i in range(8):
        direct = srv._unpack_row(packed[i], (S, S))
        for key in ("boxes", "scores", "classes"):
            check(np.array_equal(direct[key], results[i][key]),
                  f"served image {i} {key} differs from the direct call")
    err_sims, err_boxes = max_abs(sims, sims_p), max_abs(boxes, boxes_p)
    check(err_sims <= TOL_SLICE and err_boxes <= TOL_SLICE,
          f"kernel vs plain attention: sims {err_sims} boxes {err_boxes}")
    emit("slice", model="b16", dtype="bfloat16", requests=len(images),
         img_per_s=len(images) / serve_s, serve_s=serve_s, warmup_s=warmup_s,
         stats=stats, launches=launches, forward_batches=forward_batches,
         detections=[len(r["scores"]) for r in results],
         kernel_vs_plain={"sims_max_abs": err_sims, "boxes_max_abs": err_boxes})
    del params, srv
    torch.cuda.empty_cache()
    return cfg, launches


OV_BUCKETS = (1, 8)
OV_MAX_QUERIES = 8
# two overlapping query sets of 3 and 8 strings
OV_QUERIES = (("a red box", "a green box", "a blue box"),
              ("a red box", "a green box", "a blue box", "a yellow box", "a cat", "a dog",
               "a bird", "a person"))
# the conditioned requests in queue order: ("zs", query set) or ("os", exemplar);
# with buckets (1, 8) they form batches [0:8] and [8:16] (text and image
# requests mixed) and [16:17]
OV_REQUESTS = (("zs", 0), ("os", 0), ("zs", 1), ("os", 0), ("zs", 0), ("os", 1), ("zs", 1),
               ("os", 0), ("zs", 0), ("zs", 1), ("os", 1), ("zs", 0), ("os", 0), ("zs", 1),
               ("zs", 0), ("os", 0), ("zs", 1))
OV_BANK_REQUESTS = 9  # one batch of 8, one of 1
OV_BULK_IMAGES, OV_BULK_BUCKET = 64, 32
OV_CLI_TOP = 5
# lane timing: OV_ROUNDS windows per lane and bucket, the lanes in turns
OV_ROUNDS, OV_WINDOW_S, OV_WINDOW_BATCHES = 4, 0.75, 8
OV_COLD_TEXT, OV_COLD_EXEMPLAR = 20, 10
OV_BULK_TIMING_REPEAT, OV_BULK_ROUNDS = 4, 3  # 256-image jobs, bank and zero-shot in turns


def conditioned_prenms(params, cfg, flat, qemb, qmask):
    """The conditioned lane's forward up to NMS: (boxes [b, P, 4], scores
    [b, P, Q] = sigmoid(logits), logits)."""
    S = cfg.vision.image_size
    with torch.inference_mode():
        px = normalize_image(flat.reshape(flat.shape[0], S, S, 3))
        feats = owlvit.image_embedder(params, cfg, px)
        boxes = owlvit.box_predictor(params, cfg, feats)
        logits = owlvit.class_predictor(params, cfg, feats, qemb, qmask)
    return boxes, torch.sigmoid(logits), logits


def query_block(srv, reqs, digests):
    """The server's padded query block for a batch of conditioned requests,
    from its caches: [bucket, Q, proj] fp32 and [bucket, Q] int32 on the card."""
    bucket = next(b for b in srv.buckets if b >= len(reqs))
    qemb = np.zeros((bucket, OV_MAX_QUERIES, srv._proj), np.float32)
    qmask = np.zeros((bucket, OV_MAX_QUERIES), np.int32)
    for i, (kind, j) in enumerate(reqs):
        e = (np.stack([srv._text_cache[q] for q in OV_QUERIES[j]]) if kind == "zs"
             else srv._qimg_cache[digests[j]][None])
        qemb[i, :len(e)] = e
        qmask[i, :len(e)] = 1
    return torch.from_numpy(qemb).cuda(), torch.from_numpy(qmask).cuda()


def window_img_per_s(serve, batch):
    """img/s of a lane's path per batch (its serve_batch call and the fetch
    of the packed detections): host wall over one window of at least
    OV_WINDOW_S seconds and OV_WINDOW_BATCHES batches."""
    n, t0 = 0, time.perf_counter()
    while n < OV_WINDOW_BATCHES or time.perf_counter() - t0 < OV_WINDOW_S:
        serve().cpu()
        n += 1
    return batch * n / (time.perf_counter() - t0)


def spread(xs):
    """Median, least, most and count of a list of samples."""
    return {"median": float(np.median(xs)), "min": float(min(xs)), "max": float(max(xs)),
            "n": len(xs)}


def launch_us(n=2000, windows=5):
    """us per small launch queued by this host (n in-place adds on a
    16-element tensor, then a synchronize) over `windows` windows: the rate
    that bounds host-launched loops such as NMS's, read beside the lanes."""
    x = torch.zeros(16, device="cuda")
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e6 / n)
    return spread(out)


def phase_open_vocab():
    """Zero-shot and one-shot serving, bulk_detect and the CLI's inference
    commands, B/16 bf16. Returns the launches of the paths driven."""
    cfg = get_config("b16", dtype="bfloat16")
    L = cfg.vision.num_layers
    params = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=240).to("cuda")
    S = cfg.vision.image_size
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (len(OV_REQUESTS) + OV_BANK_REQUESTS, S, S, 3), dtype=np.uint8)
    # two exemplars, the second not model-sized (the server resizes it)
    exemplars = [rng.integers(0, 256, (S, S, 3), dtype=np.uint8),
                 rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)]
    digests = [hashlib.sha1(_size_to_model(e, S).tobytes()).hexdigest() for e in exemplars]
    tok = HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)
    total = dict.fromkeys(KERNELS, 0)

    # --- the online server: warm-up, then the queued requests of both lanes
    reset_counts()
    t0 = time.perf_counter()
    srv = DetectorServer(params, cfg, buckets=OV_BUCKETS, max_queries=OV_MAX_QUERIES,
                         one_shot=True, tokenizer=tok, device="cuda", autostart=False)
    warmup_s = time.perf_counter() - t0
    n_cond = len(OV_REQUESTS)
    futs = []
    for i, (kind, j) in enumerate(OV_REQUESTS):
        futs.append(srv.submit(images[i], queries=list(OV_QUERIES[j])) if kind == "zs"
                    else srv.submit(images[i], query_image=exemplars[j]))
    bank_futs = [srv.submit(im) for im in images[n_cond:]]
    t0 = time.perf_counter()
    srv.start()
    results = [f.result() for f in futs]
    bank_results = [f.result() for f in bank_futs]
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    stats = srv.stats()
    total = {k: total[k] + launches[k] for k in KERNELS}

    # (a) the batches the queue implies; (e) the caches; (f) the launches
    warm_batches = 2 * len(OV_BUCKETS)
    check(stats["bucket_counts"] == {1: 2, 8: 3} and stats["zs_batches"] == 3
          and stats["batches"] == 5, f"batches {stats}")
    distinct = sorted(set(OV_QUERIES[0]) | set(OV_QUERIES[1]))
    check(sorted(srv._text_cache) == distinct, f"text cache {sorted(srv._text_cache)}")
    check(sorted(srv._qimg_cache) == sorted(digests), "exemplar cache")
    forwards = warm_batches + 1 + stats["batches"] + len(exemplars)
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * forwards},
          f"{launches} launches for {forwards} forwards (warm-up {warm_batches} batches "
          f"and 1 exemplar, {stats['batches']} batches, {len(exemplars)} exemplars)")
    for res in results + bank_results:
        check(np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()
              and ((res["scores"] >= 0) & (res["scores"] <= 1)).all(), "bad result")
    for (kind, j), res in zip(OV_REQUESTS, results):
        want = set(OV_QUERIES[j]) if kind == "zs" else {"query-object"}
        check(set(res["labels"]) <= want and len(res["labels"]) == len(res["scores"]),
              f"labels {res['labels'][:4]}")

    # (b) each conditioned batch bit-equal to a direct call on the server's
    # own query block; (c) against forward_zero_shot / forward_one_shot;
    # (d) the kernel path against plain attention
    err_ref = {"zero_shot_scores": 0.0, "zero_shot_boxes": 0.0,
               "one_shot_scores": 0.0, "one_shot_boxes": 0.0}
    err_plain = {"scores": 0.0, "boxes": 0.0, "logits_max_rel": 0.0}
    enc = [tok(list(q)) for q in OV_QUERIES]
    qpx = [normalize_image(torch.tensor(_size_to_model(e, S)[None]).cuda())
           for e in exemplars]
    for lo in range(0, n_cond, OV_BUCKETS[-1]):
        reqs = OV_REQUESTS[lo:lo + OV_BUCKETS[-1]]
        n = len(reqs)
        qemb, qmask = query_block(srv, reqs, digests)
        bucket = qemb.shape[0]
        flat = torch.from_numpy(_flatten_bucket(list(images[lo:lo + n]), bucket, S)).cuda()
        packed = srv.serve_batch_conditioned(flat, qemb, qmask).cpu().numpy()
        packed = packed.reshape(bucket, srv._top_k, 7)
        for i, (kind, j) in enumerate(reqs):
            direct = srv._unpack_row(packed[i], (S, S), OV_QUERIES[j] if kind == "zs" else None,
                                     one_shot=kind == "os")
            for key in ("boxes", "scores", "classes", "labels"):
                check(np.array_equal(direct[key], results[lo + i][key]),
                      f"conditioned request {lo + i} {key} differs from the direct call")
        boxes, scores, logits = conditioned_prenms(params, srv.cfg, flat, qemb, qmask)
        for i, (kind, j) in enumerate(reqs):
            px = normalize_image(flat[i:i + 1].reshape(1, S, S, 3))
            with torch.inference_mode():
                if kind == "zs":
                    rb, rl = owlvit.forward_zero_shot(
                        params, srv.cfg, px, torch.from_numpy(enc[j]["input_ids"]).cuda(),
                        torch.from_numpy(enc[j]["attention_mask"]).cuda())
                else:
                    rb, rl = owlvit.forward_one_shot(params, srv.cfg, px, qpx[j])
            nq = rl.shape[-1]
            err_ref[f"{'zero' if kind == 'zs' else 'one'}_shot_scores"] = max(
                err_ref[f"{'zero' if kind == 'zs' else 'one'}_shot_scores"],
                max_abs(scores[i, :, :nq], torch.sigmoid(rl[0])))
            err_ref[f"{'zero' if kind == 'zs' else 'one'}_shot_boxes"] = max(
                err_ref[f"{'zero' if kind == 'zs' else 'one'}_shot_boxes"],
                max_abs(boxes[i], rb[0]))
        pb, ps, pl = conditioned_prenms(params, srv.cfg.replace(attention_impl="xla"), flat,
                                        qemb, qmask)
        real = qmask[:n, None, :].expand(-1, pl.shape[1], -1) > 0
        err_plain["scores"] = max(err_plain["scores"], max_abs(scores[:n], ps[:n]))
        err_plain["boxes"] = max(err_plain["boxes"], max_abs(boxes[:n], pb[:n]))
        err_plain["logits_max_rel"] = max(err_plain["logits_max_rel"],
                                          max_rel(logits[:n][real], pl[:n][real]))
    check(all(e <= TOL_SLICE for e in err_ref.values()),
          f"served vs forward_zero_shot / forward_one_shot: {err_ref}")
    check(err_plain["scores"] <= TOL_SLICE and err_plain["boxes"] <= TOL_SLICE
          and err_plain["logits_max_rel"] <= TOL_SLICE,
          f"conditioned lane, kernel vs plain attention: {err_plain}")

    # each lane's path per bucket, timed in turns: OV_ROUNDS windows each,
    # the order reversed every other round; then the host's launch rate and
    # the cold encodes
    lane = {}
    for bucket in OV_BUCKETS:
        flat = torch.from_numpy(_flatten_bucket(list(images[:bucket]), bucket, S)).cuda()
        blocks = {"zero_shot": query_block(srv, [("zs", 1)] * bucket, digests),
                  "one_shot": query_block(srv, [("os", 0)] * bucket, digests)}
        serves = {"bank": lambda: srv.serve_batch(flat),
                  **{name: (lambda q=q: srv.serve_batch_conditioned(flat, *q))
                     for name, q in blocks.items()}}
        for serve in serves.values():
            serve().cpu()
        for r in range(OV_ROUNDS):
            for name in (list(serves) if r % 2 == 0 else list(serves)[::-1]):
                lane.setdefault(f"{name}_b{bucket}", []).append(
                    window_img_per_s(serves[name], bucket))
    lane = {k: spread(v) for k, v in lane.items()}
    host_launch_us = launch_us()
    text_ms, embed_ms = [], []
    for i in range(OV_COLD_TEXT):
        t0 = time.perf_counter()
        srv._encode_text(f"a cold query number {i}")
        text_ms.append((time.perf_counter() - t0) * 1e3)
    for i in range(OV_COLD_EXEMPLAR):
        fresh = rng.integers(0, 256, (S, S, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        srv._embed_qimage(fresh)
        embed_ms.append((time.perf_counter() - t0) * 1e3)
    srv.close()

    # (g) bulk_detect against the online server at bucket 32, bank and zero-shot
    bulk_images = list(rng.integers(0, 256, (OV_BULK_IMAGES, S, S, 3), dtype=np.uint8))
    queries = list(OV_QUERIES[1])
    reset_counts()
    srv = DetectorServer(params, cfg, buckets=(OV_BULK_BUCKET,), max_queries=OV_MAX_QUERIES,
                         tokenizer=tok, device="cuda", warmup=False, autostart=False)
    futs = ([srv.submit(im) for im in bulk_images]
            + [srv.submit(im, queries=queries) for im in bulk_images])
    srv.start()
    online = [f.result() for f in futs]
    bulk, bulk_s = [], {}
    # the first job allocates the job's pinned buffers; the bank job runs
    # again last, warm
    for name, q in (("bank_first", None), ("zero_shot", queries), ("bank", None)):
        bulk += srv.bulk_detect(bulk_images, queries=q)
        bulk_s[name] = srv.stats()["bulk"]["last_job_secs"]
    launches = read_counts()
    bstats = srv.stats()
    # offline img/s over longer jobs (the 64 images repeated), bank and
    # zero-shot in turns; after the count, so the launch check below holds
    timing_images = bulk_images * OV_BULK_TIMING_REPEAT
    bulk_rate = {}
    for _ in range(OV_BULK_ROUNDS):
        for name, q in (("bank", None), ("zero_shot", queries)):
            srv.bulk_detect(timing_images, queries=q)
            bulk_rate.setdefault(name, []).append(
                len(timing_images) / srv.stats()["bulk"]["last_job_secs"])
    srv.close()
    total = {k: total[k] + launches[k] for k in KERNELS}
    per_pass = OV_BULK_IMAGES // OV_BULK_BUCKET
    n_batches = 2 * per_pass + 3 * per_pass  # online: bank + zero-shot; three bulk jobs
    check(bstats["batches"] == 2 * per_pass and bstats["bulk"]["batches"] == 3 * per_pass
          and bstats["bulk"]["images"] == 3 * OV_BULK_IMAGES, f"bulk stats {bstats}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * n_batches},
          f"bulk: {launches} launches for {n_batches} batches")
    online += online[:OV_BULK_IMAGES]  # the bank job's rows again
    for i, (a, b) in enumerate(zip(online, bulk, strict=True)):
        for key in ("boxes", "scores", "classes"):
            check(np.array_equal(a[key], b[key]), f"bulk row {i} {key} differs from online")
        check(a.get("labels") == b.get("labels"), f"bulk row {i} labels")

    # (h) the CLI's infer (three modes) and bulk-infer on the card
    cli_walls, cli_launches = {}, {}
    with tempfile.TemporaryDirectory() as d:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["make-synthetic", "--root", f"{d}/synth", "--n-train", "6",
                      "--n-test", "2", "--n-classes", "3"])
        with open(f"{d}/config.yaml", "w") as f:
            f.write(f"data:\n  synthetic_root: {d}/synth\n  num_train_images: 6\n"
                    "  num_test_images: 2\n  synthetic_classes: 3\ntraining:\n"
                    "  confidence_threshold: 0.0\nmodel:\n  name: b16\n  dtype: bfloat16\n")
        img_dir = f"{d}/synth/images"
        files = sorted(os.listdir(img_dir))
        base = ["--config", f"{d}/config.yaml", "--workdir", d, "--device", "cuda"]
        runs = {"infer_bank": ["infer", *base, "--image", f"{img_dir}/{files[0]}"],
                "infer_queries": ["infer", *base, "--image", f"{img_dir}/{files[0]}",
                                  "--queries", *OV_QUERIES[0]],
                "infer_query_image": ["infer", *base, "--image", f"{img_dir}/{files[0]}",
                                      "--query-image", f"{img_dir}/{files[1]}"],
                "bulk_infer": ["bulk-infer", *base, "--input-dir", img_dir,
                               "--out", f"{d}/bulk.json"]}
        want = {"infer_bank": 1, "infer_queries": 1, "infer_query_image": 2, "bulk_infer": 1}
        for name, argv in runs.items():
            reset_counts()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli.main([*argv, "--top", str(OV_CLI_TOP)] if name != "bulk_infer" else argv)
            torch.cuda.synchronize()
            cli_walls[name] = time.perf_counter() - t0
            cli_launches[name] = read_counts()
            total = {k: total[k] + cli_launches[name][k] for k in KERNELS}
            check(cli_launches[name] == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * want[name]},
                  f"cli {name}: {cli_launches[name]} launches")
            lines = [ln for ln in out.getvalue().splitlines() if "[" in ln]
            if name != "bulk_infer":
                check(len(lines) == OV_CLI_TOP, f"cli {name} printed {out.getvalue()!r}")
        with open(f"{d}/bulk.json") as f:
            records = json.load(f)
        check(sorted(records) == files and all(
            len(r["boxes"]) == len(r["labels"]) > 0 and np.isfinite(r["scores"]).all()
            for r in records.values()), f"bulk-infer wrote {list(records)}")
    del params
    torch.cuda.empty_cache()
    emit("open_vocab", model="b16", dtype="bfloat16", requests={
        "conditioned": n_cond, "bank": OV_BANK_REQUESTS}, warmup_s=warmup_s,
        serve_s=serve_s, stats=stats, lane_img_per_s=lane, host_launch_us=host_launch_us,
        cold_text_encode_ms=spread(text_ms), cold_exemplar_embed_ms=spread(embed_ms),
        vs_forward_zero_one_shot_max_abs=err_ref, kernel_vs_plain=err_plain,
        bulk_check_job_s=bulk_s, bulk_img_per_s={
            k: spread(v) for k, v in bulk_rate.items()},
        cli_walls_s=cli_walls, cli_launches=cli_launches,
        launches=total)
    return total


# ------------------------------------------------------------- mesh serving

MS_BUCKETS = (2, 8)  # the two-shard server's buckets: multiples of 2
MS_BULK_IMAGES = 64


def dispatch_img_per_s(srv, images, bucket):
    """img/s of the server's whole dispatch of one batch (staging, the
    shards' copies and forwards, one read per shard): one window."""
    batch = [_Request(im, im.shape[1::-1]) for im in images[:bucket]]
    return window_img_per_s(lambda: torch.from_numpy(srv._dispatch(batch)), bucket)


def phase_mesh_serve():
    """DetectorServer(mesh=) on the card, B/16 bf16, random weights (seed
    0), 240 bank queries; the slice phase's 9 images. (a) A mesh of one,
    buckets (1, 8): bit-equal to the single-device server row for row.
    (b) Two shards on cuda:0, buckets (2, 8), both lanes: each row
    bit-equal to a direct call on its own shard's rows (the server's own
    query block for the conditioned lane), each shard's pre-NMS output
    within TOL_SLICE of the unsharded bucket's, bulk_detect over 64 images
    bit-equal to the online rows, pk_fwd launched L times per shard per
    batch. (c) The dispatch's img/s per bucket: no mesh against a mesh of
    one in turns, and two shards on one card beside them (no scaling
    figure: one H100, so NCCL and multi-card serving stay unmeasured).
    Returns the launches of the paths driven."""
    cfg = get_config("b16", dtype="bfloat16")
    L = cfg.vision.num_layers
    params = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=240).to("cuda")
    S = cfg.vision.image_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (9, S, S, 3), dtype=np.uint8)
    tok = HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)
    exemplars = [rng.integers(0, 256, (S, S, 3), dtype=np.uint8),
                 rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)]
    digests = [hashlib.sha1(_size_to_model(e, S).tobytes()).hexdigest() for e in exemplars]
    total = dict.fromkeys(KERNELS, 0)

    def served(srv):
        futs = [srv.submit(im) for im in images]
        srv.start()
        return [f.result() for f in futs]

    def same(a, b):
        return all(np.array_equal(a[k], b[k]) for k in ("boxes", "scores", "classes")) and \
            a.get("labels") == b.get("labels")

    # (a) a mesh of one against the single-device server
    reset_counts()
    one = DetectorServer(params, cfg, buckets=OV_BUCKETS, device="cuda", autostart=False)
    single_rows = served(one)
    mesh1 = DetectorServer(params, cfg, buckets=OV_BUCKETS, mesh=("cuda:0",), autostart=False)
    mesh1_rows = served(mesh1)
    launches = read_counts()
    total = {k: total[k] + launches[k] for k in KERNELS}
    check(all(same(a, b) for a, b in zip(mesh1_rows, single_rows, strict=True)),
          "the mesh of one differs from the single-device server")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * 2 * (2 + 2)},
          f"mesh of one: {launches}")

    # (b) two shards on cuda:0, both lanes, then bulk_detect
    reset_counts()
    t0 = time.perf_counter()
    two = DetectorServer(params, cfg, buckets=MS_BUCKETS, mesh=("cuda:0", "cuda:0"),
                         tokenizer=tok, max_queries=OV_MAX_QUERIES, one_shot=True,
                         autostart=False)
    warmup_s = time.perf_counter() - t0
    bank_rows = [two.submit(im) for im in images]
    cond_reqs = OV_REQUESTS[:len(images)]
    cond_futs = [two.submit(im, queries=list(OV_QUERIES[j])) if kind == "zs"
                 else two.submit(im, query_image=exemplars[j])
                 for im, (kind, j) in zip(images, cond_reqs)]
    two.start()
    bank_rows = [f.result() for f in bank_rows]
    cond_rows = [f.result() for f in cond_futs]
    launches = read_counts()
    stats = two.stats()
    n_shards = len(two.mesh)
    warm = len(MS_BUCKETS) * n_shards * 2 + 1  # both lanes on every shard, one exemplar
    check(stats["bucket_counts"] == {2: 2, 8: 2} and stats["zs_batches"] == 2,
          f"two shards: batches {stats}")
    forwards = warm + n_shards * stats["batches"] + len(exemplars)
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * forwards},
          f"two shards: {launches} launches for {forwards} forwards")
    total = {k: total[k] + launches[k] for k in KERNELS}

    err_single = {"sims": 0.0, "boxes": 0.0, "scores": 0.0, "logits_max_rel": 0.0}
    for lo in (0, 8):
        reqs = cond_reqs[lo:lo + 8]
        n = len(reqs)
        bucket = next(b for b in MS_BUCKETS if b >= n)
        flat = torch.from_numpy(_flatten_bucket(list(images[lo:lo + n]), bucket, S)).cuda()
        qemb, qmask = query_block(two, reqs, digests)
        check(qemb.shape[0] == bucket, f"query block {qemb.shape}")
        with torch.inference_mode():
            px = normalize_image(flat.reshape(bucket, S, S, 3))
            boxes, sims = owlvit.forward_train(params, two.cfg, px)
        cboxes, cscores, clogits = conditioned_prenms(params, two.cfg, flat, qemb, qmask)
        for _, part in two._shards(bucket):
            first, rows = part.start, part.stop - part.start
            bank = two.serve_batch(flat[part]).cpu().numpy().reshape(rows, two._top_k, 7)
            cond = two.serve_batch_conditioned(flat[part], qemb[part], qmask[part])
            cond = cond.cpu().numpy().reshape(rows, two._top_k, 7)
            for i in range(rows):
                r = first + i
                if lo + r >= len(images):
                    continue
                kind, j = reqs[r]
                check(same(two._unpack_row(bank[i], (S, S)), bank_rows[lo + r]),
                      f"bank row {lo + r} differs from its shard's direct call")
                check(same(two._unpack_row(cond[i], (S, S), OV_QUERIES[j] if kind == "zs"
                                           else None, one_shot=kind == "os"),
                           cond_rows[lo + r]),
                      f"conditioned row {lo + r} differs from its shard's direct call")
            with torch.inference_mode():
                sb, ss = owlvit.forward_train(params, two.cfg, px[part])
            pb, ps, pl = conditioned_prenms(params, two.cfg, flat[part], qemb[part], qmask[part])
            real = qmask[part][:, None, :].expand(-1, pl.shape[1], -1) > 0
            err_single["sims"] = max(err_single["sims"], max_abs(ss, sims[part]))
            err_single["boxes"] = max(err_single["boxes"], max_abs(sb, boxes[part]),
                                      max_abs(pb, cboxes[part]))
            err_single["scores"] = max(err_single["scores"], max_abs(ps, cscores[part]))
            if real.any():  # a shard of pad rows has no query
                err_single["logits_max_rel"] = max(err_single["logits_max_rel"],
                                                   max_rel(pl[real], clogits[part][real]))
    check(all(e <= TOL_SLICE for e in err_single.values()),
          f"two shards against the unsharded bucket: {err_single}")
    # the served rows against the single-device server's (post-NMS): the
    # count bit-equal, and the largest difference where the kept classes agree
    post_nms = {"rows_bit_equal": sum(same(a, b) for a, b in zip(bank_rows, single_rows)),
                "rows": len(images), "scores_max_abs": 0.0}
    for a, b in zip(bank_rows, single_rows):
        if np.array_equal(a["classes"], b["classes"]):
            post_nms["scores_max_abs"] = max(post_nms["scores_max_abs"], float(
                np.abs(a["scores"] - b["scores"]).max(initial=0.0)))

    bulk_images = list(rng.integers(0, 256, (MS_BULK_IMAGES, S, S, 3), dtype=np.uint8))
    queries = list(OV_QUERIES[1])
    reset_counts()
    two.close()
    two = DetectorServer(params, cfg, buckets=MS_BUCKETS, mesh=("cuda:0", "cuda:0"),
                         tokenizer=tok, max_queries=OV_MAX_QUERIES, warmup=False,
                         autostart=False)
    futs = ([two.submit(im) for im in bulk_images]
            + [two.submit(im, queries=queries) for im in bulk_images])
    two.start()
    online = [f.result() for f in futs]
    bulk = two.bulk_detect(bulk_images) + two.bulk_detect(bulk_images, queries=queries)
    launches = read_counts()
    bstats = two.stats()
    total = {k: total[k] + launches[k] for k in KERNELS}
    per_job = MS_BULK_IMAGES // MS_BUCKETS[-1]
    check(bstats["batches"] == 2 * per_job and bstats["bulk"]["batches"] == 2 * per_job,
          f"bulk stats {bstats}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * n_shards * 4 * per_job},
          f"bulk on two shards: {launches}")
    for i, (a, b) in enumerate(zip(online, bulk, strict=True)):
        check(same(a, b), f"bulk row {i} differs from the mesh server's online row")
    two.close()

    # (c) the dispatch's img/s per bucket, in turns: no mesh, a mesh of one,
    # and (at bucket 8) two shards on one card
    two = DetectorServer(params, cfg, buckets=MS_BUCKETS, mesh=("cuda:0", "cuda:0"),
                         autostart=False)
    paths = {"no_mesh": one, "mesh_of_one": mesh1, "two_shards_one_card": two}
    rates = {}
    for bucket in OV_BUCKETS:
        names = [n for n, s in paths.items() if bucket in s.buckets]
        for name in names:
            dispatch_img_per_s(paths[name], images, bucket)  # warm
        for r in range(OV_ROUNDS):
            for name in (names if r % 2 == 0 else names[::-1]):
                rates.setdefault(f"{name}_b{bucket}", []).append(
                    dispatch_img_per_s(paths[name], images, bucket))
    for srv in paths.values():
        srv.close()
    rates = {k: spread(v) for k, v in rates.items()}
    emit("mesh_serve", model="b16", dtype="bfloat16", warmup_s_two_shards=warmup_s,
         stats_two_shards=stats, unsharded_vs_two_shards_max_abs=err_single,
         post_nms_vs_single_device=post_nms, dispatch_img_per_s=rates,
         note="two shards share one card: no scaling figure; NCCL and multi-card "
              "serving are not measured (one H100)", launches=total)
    del params, one, mesh1, two
    torch.cuda.empty_cache()
    return total


def train_batch(rng, B, G, S, n_classes):
    """uint8 images (flat, as the loader sends them) and 4-10 random boxes
    per image, padded to G."""
    labels = np.zeros((B, G), np.int32)
    boxes = np.zeros((B, G, 4), np.float32)
    mask = np.zeros((B, G), bool)
    for b in range(B):
        n = int(rng.integers(4, 11))
        c, wh = rng.uniform(0.1, 0.9, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))
        boxes[b, :n] = np.clip(np.concatenate([c - wh / 2, c + wh / 2], 1), 0, 1)
        labels[b, :n] = rng.integers(0, n_classes, n)
        mask[b, :n] = True
    return {"image": rng.integers(0, 256, (B, S * S * 3), dtype=np.uint8),
            "labels": labels, "boxes": boxes, "gt_mask": mask}


@contextlib.contextmanager
def recorded_matching():
    """Keep the matcher's inputs and outputs of every train step while the
    block runs: {"boxes": [the predicted boxes], "assign": [(cost,
    row_mask, assigned, target_classes, n_classes)]}, the step's own
    tensors (no copy: nothing writes them after the call, so the step's
    device work is unchanged). The loss reaches both through the matcher
    module's attributes, which this wraps."""
    record = {"boxes": [], "assign": []}
    cost_matrix, assign = matcher.cost_matrix, matcher.assign

    def cost_recorded(pred_sims, pred_boxes, *args, **kwargs):
        record["boxes"].append(pred_boxes.detach())
        return cost_matrix(pred_sims, pred_boxes, *args, **kwargs)

    def assign_recorded(cost, gt_labels, gt_mask, n_classes):
        assigned, target = assign(cost, gt_labels, gt_mask, n_classes)
        record["assign"].append((cost.detach(), gt_mask.bool(), assigned, target, n_classes))
        return assigned, target

    matcher.cost_matrix, matcher.assign = cost_recorded, assign_recorded
    try:
        yield record
    finally:
        matcher.cost_matrix, matcher.assign = cost_matrix, assign


class PhaseTimer:
    """CUDA events (and host clock) at the train step's phase marks; the
    first mark after "input" is "prefix", set by a pre-hook on the first
    trained layer."""

    def __init__(self):
        self.marks = []
        self("start")

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def durations(self):
        torch.cuda.synchronize()
        return {b: {"device_ms": ea.elapsed_time(eb), "host_ms": (hb - ha) * 1e3}
                for (_, ea, ha), (b, eb, hb) in zip(self.marks, self.marks[1:])}


def phase_train(steps=4, batch=32, max_gt=64, n_classes=80):
    name = "b16"
    mcfg = get_config(name)
    L = mcfg.vision.num_layers
    config = Config(DataConfig(max_gt=max_gt),
                    TrainingConfig(learning_rate=3e-6, weight_decay=0.1,
                                   batch_size=batch, checkpoint_dir=None),
                    ModelConfig(name=name, dtype="bfloat16", trainable_last_k=1))
    model = owlvit.init(mcfg, torch.Generator().manual_seed(0),
                        num_queries=3 * n_classes, device="cuda")
    rng = np.random.default_rng(0)
    S = mcfg.vision.image_size
    batches = [train_batch(rng, batch, max_gt, S, n_classes) for _ in range(steps)]
    class_weights = np.linspace(0.5, 1.5, n_classes, dtype=np.float32)
    trainer = Trainer(config, model, n_classes, steps_per_epoch=steps,
                      class_weights=class_weights, device="cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    timer = [None]
    hook = model.vision.layers[L - 1].register_forward_pre_hook(
        lambda mod, args: timer[0] and timer[0]("prefix"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, terms, phases = [], [], []
    with recorded_matching() as matching:
        for i, b in enumerate(batches):
            timer[0] = PhaseTimer() if i else None
            t0 = time.perf_counter()
            terms.append(trainer.train_step(b, mark=timer[0]).tolist())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if timer[0]:
                phases.append(timer[0].durations())
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hook.remove()

    check(np.isfinite(terms).all(), f"non-finite loss terms {terms}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * steps, **pair(steps),
                       **matched(steps)},
          f"{launches} launches in {steps} steps")
    trainable = {id(p) for p in trainer.params}
    for n, p in model.named_parameters():
        same = torch.equal(p, before[n])
        check(not same if id(p) in trainable else same,
              f"{'trainable' if id(p) in trainable else 'frozen'} {n}: "
              f"{'unchanged' if same else 'changed'}")
    # the default backward is reproducible: the same step from the same
    # state twice gives the same terms and bit-equal gradients; then the
    # state after the 4 steps again, for the trained layer's check
    start = copy.deepcopy(trainer.state())
    repeat = []
    for _ in range(2):
        trainer.load_state(copy.deepcopy(start))
        repeat.append((trainer.train_step(dict(batches[0])), grads_of(trainer)))
    repeat_bit_equal = (bool(np.array_equal(repeat[0][0], repeat[1][0])) and all(
        torch.equal(a, b) for a, b in zip(repeat[0][1], repeat[1][1])))
    check(repeat_bit_equal, "the default step's backward differs between two runs")
    trainer.load_state(start)
    del start, repeat
    emit("train", model=name, dtype="bfloat16", batch=batch, steps=steps,
         max_gt=max_gt, gt_per_image=float(np.mean([b["gt_mask"].sum(1) for b in batches])),
         terms=terms, launches=launches, step_wall_ms=walls,
         img_per_s=batch * (steps - 1) / (sum(walls[1:]) / 1e3),
         phases_ms=phases, max_memory_allocated_gb=peak_gb,
         trainable_params=len(trainer.params), bwd_mode=fa.pk_bwd_mode(),
         repeat_grad_bit_equal=repeat_bit_equal)

    # the trained layer: kernel path vs plain path, forward and backward
    n = min(8, batch)
    with torch.no_grad():
        img = torch.from_numpy(batches[0]["image"][:n]).cuda().reshape(n, S, S, 3)
        acts = vit.forward_prefix(model.vision, mcfg.vision, normalize_image(img),
                                  dtype=torch.bfloat16, trainable_last_k=1)
    layer = model.vision.layers[L - 1]
    cot = torch.randn(acts.shape, generator=torch.Generator(device="cuda").manual_seed(11),
                      device="cuda").to(torch.bfloat16)
    out = {}
    # "kernel": the default backward (the pair); "kernel_fused": the same
    # layer under OWLVIT_PACKED_BWD=fused, its yardstick
    for path, impl, dtype, mode in (("kernel", "auto", torch.bfloat16, None),
                                    ("kernel_fused", "auto", torch.bfloat16, "fused"),
                                    ("plain", "xla", torch.bfloat16, None),
                                    ("f32", "xla", torch.float32, None)):
        x = acts.to(dtype, copy=True).requires_grad_(True)
        layer.zero_grad(set_to_none=True)
        with switches(OWLVIT_PACKED_BWD=mode):
            y = layer(x, impl=impl)
            y.backward(cot.to(dtype))
        out[path] = dict(zip(TOL_LAYER, [y.detach(), x.grad] + [
            getattr(layer.attn, n).weight.grad for n in ("q", "k", "v", "out")]))
        del x, y
    err = {name: max_rel(out["kernel"][name], out["plain"][name]) for name in TOL_LAYER}
    check(all(np.isfinite(e) and e <= TOL_LAYER[n] for n, e in err.items()),
          f"trained layer, kernel vs plain path: {err}")
    vs_f32 = {path: {name: max_rel(out[path][name], out["f32"][name]) for name in TOL_LAYER}
              for path in ("kernel", "kernel_fused", "plain")}
    # the default backward (the pair) against fp32 on the two grads that
    # ds's rounding moves most
    check(all(vs_f32["kernel"][n] <= TOL_LAYER[n] for n in ("dq_w", "dk_w")),
          f"trained layer, kernel path vs fp32: {vs_f32['kernel']}")
    emit("train_layer", shape=list(acts.shape), bwd_mode=fa.pk_bwd_mode(),
         kernel_vs_plain_max_rel=err, vs_f32_max_rel=vs_f32)
    del model, trainer, before, acts, out
    torch.cuda.empty_cache()
    return launches, matching


# ---------------------------------------------------------------- matcher

# The matcher kernels' check shapes [B, G, P]: bench.py's recipe (G = 16) and
# the smoke's train phases (G = 64) at B/16's P = 2304, B/32's 576, L/14's 3600
MATCH_SHAPES = ((32, 16, 2304), (32, 64, 2304), (32, 64, 576), (4, 64, 3600))


def tie_costs(rng, B, G, P):
    """Tie-heavy integer costs in [0, 4) (sums exact in fp32, so only the
    solver's own order decides among equal paths): every column twice;
    masked rows: image 0 none, image 1 all, image 2 its first half, the rest
    at random; image 3 every row the same row with no row masked (every
    augmenting path runs over equal costs)."""
    cost = rng.integers(0, 4, (B, G, P)).astype(np.float32)
    half = P // 2
    cost[..., half:2 * half] = cost[..., :half]
    mask = rng.random((B, G)) < 0.5
    mask[0], mask[1], mask[2, :G // 2] = True, False, False
    cost[3], mask[3] = cost[3, 0], True
    return cost, mask


def host_ms(fn, calls=3):
    """Median host wall of fn() in ms (fn ends in a host read)."""
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def propagation_cases(rng, B, P, n_classes):
    """Boxes [B, P, 4] and classes [B, P] where the walk's order decides:
    small random boxes (few overlaps) with 8 random foreground patches; a
    chain of 12 boxes each shifted by 6% of its width from the one before
    (IoU 0.887 with a neighbour, 0.786 with the next but one) at increasing
    patch indices, its first link foreground (the label walks down the
    chain); a reversed chain whose foreground link has the highest index
    (the label reaches one link); and 7 pairs built to sit at the 0.85
    boundary: box b inside box a at s times its width, s = 0.85 and its
    fp32 neighbours up to 3 ulps away, so that IoU = s up to rounding."""
    c = rng.uniform(0.1, 0.9, (B, P, 2))
    wh = rng.uniform(0.005, 0.03, (B, P, 2))
    bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    tc = np.full((B, P), n_classes, np.int64)
    s85 = np.float32(0.85)
    ulps = [s85]
    for _ in range(3):
        ulps = [np.nextafter(ulps[0], np.float32(0)), *ulps, np.nextafter(ulps[-1], np.float32(1))]
    for b in range(B):
        idx = rng.permutation(P)
        for chain, fg in ((np.sort(idx[:12]), 0), (np.sort(idx[12:24])[::-1], 0)):
            w, h = rng.uniform(0.1, 0.2, 2)
            x0, y0 = rng.uniform(0.0, 0.4, 2)
            for k, j in enumerate(chain):
                bx[b, j] = [x0 + 0.06 * w * k, y0, x0 + 0.06 * w * k + w, y0 + h]
            tc[b, chain[fg]] = rng.integers(0, n_classes)
        for (i, j), sv in zip(idx[24:38].reshape(7, 2), ulps):
            w, h = rng.uniform(0.05, 0.3, 2)
            x0, y0 = rng.uniform(0.0, 0.6, 2)
            bx[b, i] = [x0, y0, x0 + w, y0 + h]
            bx[b, j] = [x0, y0, np.float32(x0) + sv * np.float32(w), y0 + h]
            tc[b, min(i, j)] = rng.integers(0, n_classes)
        tc[b, idx[38:46]] = rng.integers(0, n_classes, 8)
    return bx, tc


def phase_kernel_matcher(matching):
    """jv_assign and propagate_labels against their plain versions (the
    host solver and the host walk), exact equality: on the matrices and
    boxes of phase train's own steps (`matching`, read back here only),
    then jv_assign on tie_costs at MATCH_SHAPES and propagate_labels on
    propagation_cases at [32, 2304] and [4, 3600]. Times at the train
    step's shapes ([32, 64, 2304] and [32, 2304]): CUDA events through the
    wrapper, the profiler's device time, the plain version with its device
    read, the bound by bytes. The steps' assignments are their own; their
    propagation is launched again on their inputs. Each kernel's
    max_abs_err is the largest |kernel - host| of its outputs (columns,
    classes) over every comparison here. Returns the two kernels' rows."""
    rng = np.random.default_rng(14)
    err = {"jv_assign": 0, "propagate_labels": 0}

    def compare(name, got, want):
        """-> the mismatches of two integer arrays; err[name] takes their
        largest absolute difference."""
        d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
        err[name] = max(err[name], int(d.max()) if d.size else 0)
        return int((d != 0).sum())

    n_classes = 80
    train_steps = []
    thr = 0.85  # the trainer's (push_pull_loss's) IoU propagation threshold
    for (cost, mask, got, classes, nc), boxes in zip(matching["assign"], matching["boxes"]):
        want = matcher.hungarian(cost.cpu().numpy(), mask.cpu().numpy())
        got_p = losses.propagate_labels(boxes, classes, nc, thr).cpu().numpy()
        want_p = losses.propagate_labels(boxes.cpu(), classes.cpu(), nc, thr).numpy()
        step = {"shape": list(cost.shape), "valid_rows": int(mask.sum().item()),
                "assign_mismatches": compare("jv_assign", got.cpu().numpy(), want),
                "propagate_mismatches": compare("propagate_labels", got_p, want_p),
                "relabelled": int((want_p != classes.cpu().numpy()).sum())}
        check(step["assign_mismatches"] == 0 and step["propagate_mismatches"] == 0,
              f"the train step's matcher kernels against the host: {step}")
        train_steps.append(step)
    check(len(train_steps) == 4, f"{len(train_steps)} recorded train steps")
    ties = []
    for shape in MATCH_SHAPES:
        cost, mask = tie_costs(rng, *shape)
        c, m = torch.from_numpy(cost).cuda(), torch.from_numpy(mask).cuda()
        got = matcher.jv_assign(c, m).cpu().numpy()
        want = matcher.hungarian(cost, mask)
        case = {"shape": list(shape), "valid_rows": int(mask.sum()),
                "mismatches": compare("jv_assign", got, want),
                "ms": cuda_ms(lambda: matcher.jv_assign(c, m), 3)}
        check(case["mismatches"] == 0 and (want[~mask] == -1).all(),
              f"jv_assign on tie-heavy costs: {case}")
        ties.append(case)
    chains = []
    for B, P in ((32, 2304), (4, 3600)):
        bx, tc = propagation_cases(rng, B, P, n_classes)
        want = losses.propagate_labels(torch.from_numpy(bx), torch.from_numpy(tc),
                                       n_classes, 0.85).numpy()
        got = losses.propagate_labels(torch.from_numpy(bx).cuda(), torch.from_numpy(tc).cuda(),
                                      n_classes, 0.85).cpu().numpy()
        case = {"shape": [B, P], "mismatches": compare("propagate_labels", got, want),
                "relabelled": int((want != tc).sum())}
        check(case["mismatches"] == 0 and case["relabelled"] >= 12 * B,
              f"propagate_labels on chains and boundary pairs: {case}")
        chains.append(case)

    # times at the train step's shapes, on its own inputs
    cost, mask, _, classes, nc = matching["assign"][-1]
    boxes = matching["boxes"][-1]
    B, G, P = cost.shape
    timed = {"jv_assign": compare("jv_assign", matcher.jv_assign(cost, mask).cpu().numpy(),
                                  matcher.hungarian(cost.cpu().numpy(), mask.cpu().numpy())),
             "propagate_labels": compare(
                 "propagate_labels", losses.propagate_labels(boxes, classes, nc, thr).cpu().numpy(),
                 losses.propagate_labels(boxes.cpu(), classes.cpu(), nc, thr).numpy())}
    check(timed == {"jv_assign": 0, "propagate_labels": 0},
          f"the matcher kernels on the timed inputs, mismatches: {timed}")
    jv = {"shape": [B, G, P], "max_abs_err": float(err["jv_assign"]),
          "ms": cuda_ms(lambda: matcher.jv_assign(cost, mask), 20),
          "device_ms": device_ms(lambda: matcher.jv_assign(cost, mask)),
          "plain_ms": host_ms(lambda: matcher.hungarian(cost.cpu().numpy(),
                                                        mask.cpu().numpy())),
          "library_ms": None, "sequential": True}
    jv["bound_ms"], jv["bound_by"] = bound(0, B * G * P * 4 + B * G + B * G * 4)
    prop = {"shape": [B, P], "max_abs_err": float(err["propagate_labels"]),
            "ms": cuda_ms(lambda: losses.propagate_labels(boxes, classes, nc, thr), 20),
            "device_ms": device_ms(lambda: losses.propagate_labels(boxes, classes, nc, thr)),
            "plain_ms": host_ms(lambda: losses.propagate_labels(boxes.cpu(), classes.cpu(),
                                                                nc, thr)),
            "library_ms": None, "sequential": True}
    prop["bound_ms"], prop["bound_by"] = bound(0, B * P * 16 + 2 * B * P * 8)
    emit("kernel_matcher", train_steps=train_steps, ties=ties, propagation=chains,
         jv_assign=jv, propagate_labels=prop, nvidia_smi=nvidia_smi())
    return {"jv_assign": jv, "propagate_labels": prop}


LN_EPS = 1e-5


def ln_inputs(N, D, dtype, seed):
    """x with a row offset (so that the mean is not ~0), h, dy, dr; fp32
    scale and bias around 1 and 0, as trained LayerNorms are."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(N, D, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    h, dy, dr = (torch.randn(N, D, generator=g, device="cuda").to(dtype) for _ in range(3))
    scale = 1 + 0.2 * torch.randn(D, generator=g, device="cuda")
    bias = 0.1 * torch.randn(D, generator=g, device="cuda")
    return x, h, scale, bias, dy, dr


def ln_errors(x, h, scale, bias, dy, dr, key):
    """add_ln forward and backward, kernel vs plain on the same inputs;
    raises outside the tolerances or if the backward's sums change from one
    launch to the next."""
    r_k, y_k = fused_ln.add_ln_fwd(x, h, scale, bias, LN_EPS)
    r_p, y_p = fused_ln.add_ln_fwd_plain(x, h, scale, bias, LN_EPS)
    g_k, ds_k, db_k = fused_ln.add_ln_bwd(r_k, dy, dr, scale, LN_EPS)
    again = fused_ln.add_ln_bwd(r_k, dy, dr, scale, LN_EPS)
    g_p, ds_p, db_p = fused_ln.add_ln_bwd_plain(r_k, dy, dr, scale, LN_EPS)
    torch.cuda.synchronize()
    for name, t in (("y", y_k), ("g", g_k), ("dscale", ds_k), ("dbias", db_k)):
        check(torch.isfinite(t).all().item(), f"add_ln {key}: non-finite kernel {name}")
    check(torch.equal(r_k, r_p), f"add_ln {key}: r differs from x + h")
    check(all(torch.equal(a, b) for a, b in zip((g_k, ds_k, db_k), again)),
          f"add_ln {key}: the backward is not deterministic")
    mean, rstd = fused_ln._stats(r_k.float(), LN_EPS)
    xhat = (r_k.float() - mean) * rstd
    mag_s = (dy.float() * xhat).abs().sum(0)
    mag_b = dy.float().abs().sum(0)
    err = {"y_max_abs": max_abs(y_k, y_p), "y_max_rel": max_rel(y_k, y_p),
           "g_max_abs": max_abs(g_k, g_p), "g_max_rel": max_rel(g_k, g_p),
           "dscale_max_abs": max_abs(ds_k, ds_p), "dbias_max_abs": max_abs(db_k, db_p),
           "dscale_rel_to_sum": ((ds_k - ds_p).abs() / mag_s).max().item(),
           "dbias_rel_to_sum": ((db_k - db_p).abs() / mag_b).max().item()}
    check(err["y_max_rel"] <= TOL_LN[key] and err["g_max_rel"] <= TOL_LN[key]
          and err["dscale_rel_to_sum"] <= TOL_LN_SUM
          and err["dbias_rel_to_sum"] <= TOL_LN_SUM, f"add_ln {key}: {err}")
    return err, r_k


def phase_kernel_ln():
    """add_ln forward and backward vs plain at the trained shape
    [32*2305, 768], [8*2305, 768], L/14's [4*3601, 1024] and one B/16 image
    (2305 rows, not a multiple of the kernel's 8-row block; 4*3601 is not
    either), bf16 and fp32; at the trained shape in bf16 the times of the
    kernels, their plain versions and the yardstick x + h then
    F.layer_norm: forward, backward alone (on a retained graph, the
    kernels line's library time) and forward + backward."""
    S16 = get_config("b16").vision.num_patches + 1
    S14 = get_config("l14").vision.num_patches + 1
    trained = None
    for name, N, D in (("trained", 32 * S16, 768), ("b16_b8", 8 * S16, 768),
                       ("l14_b4", 4 * S14, 1024), ("b16_one_image", S16, 768)):
        row = {"shape": [N, D]}
        for dtype in (torch.bfloat16, torch.float32):
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            x, h, scale, bias, dy, dr = ln_inputs(N, D, dtype, seed=N + D)
            err, r = ln_errors(x, h, scale, bias, dy, dr, key)
            if name == "trained" and key == "bf16":
                elt = x.element_size()
                w16, b16 = scale.to(dtype), bias.to(dtype)
                leaves = [t.detach().clone().requires_grad_(True) for t in (x, h, w16, b16)]

                def lib_fwd():
                    rl = leaves[0] + leaves[1]
                    return rl, F.layer_norm(rl, (D,), leaves[2], leaves[3], LN_EPS)

                def lib_fwd_bwd():
                    torch.autograd.grad(lib_fwd(), leaves, (dr, dy))

                graph = lib_fwd()  # the backward alone, on a retained graph

                fwd_b = bound(8 * N * D, 4 * N * D * elt + 2 * D * 4, PEAK_F32_FLOPS)
                bwd_b = bound(14 * N * D, 4 * N * D * elt + 3 * D * 4, PEAK_F32_FLOPS)
                trained = {
                    "fwd": {"max_abs_err": err["y_max_abs"],
                            "ms": cuda_ms(lambda: fused_ln.add_ln_fwd(x, h, scale, bias, LN_EPS), 20),
                            "plain_ms": cuda_ms(lambda: fused_ln.add_ln_fwd_plain(
                                x, h, scale, bias, LN_EPS), 5),
                            "library_ms": cuda_ms(lambda: F.layer_norm(x + h, (D,), w16, b16, LN_EPS), 20),
                            "bound_ms": fwd_b[0], "bound_by": fwd_b[1]},
                    "bwd": {"max_abs_err": err["g_max_abs"],
                            "ms": cuda_ms(lambda: fused_ln.add_ln_bwd(r, dy, dr, scale, LN_EPS), 20),
                            "plain_ms": cuda_ms(lambda: fused_ln.add_ln_bwd_plain(
                                r, dy, dr, scale, LN_EPS), 5),
                            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                                graph, leaves, (dr, dy), retain_graph=True), 20),
                            "library_fwd_bwd_ms": cuda_ms(lib_fwd_bwd, 10),
                            "bound_ms": bwd_b[0], "bound_by": bwd_b[1]},
                }
                err.update({f"{d}_{k}": v for d in ("fwd", "bwd") for k, v in trained[d].items()
                            if k != "max_abs_err"})
                del leaves, graph
            elif key == "bf16":  # the backward's time at the other shapes
                bwd_b = bound(14 * N * D, 4 * N * D * x.element_size() + 3 * D * 4,
                              PEAK_F32_FLOPS)
                err.update(bwd_ms=cuda_ms(lambda: fused_ln.add_ln_bwd(r, dy, dr, scale, LN_EPS), 20),
                           bwd_device_ms=device_ms(
                               lambda: fused_ln.add_ln_bwd(r, dy, dr, scale, LN_EPS)),
                           bwd_bound_ms=bwd_b[0], bwd_bound_by=bwd_b[1])
            row[key] = err
            del x, h, scale, bias, dy, dr, r
            torch.cuda.empty_cache()
        emit("kernel_ln", case=name, **row)
    # every other width the kernels take (one backward template each), 999
    # rows (not a multiple of 8): the same checks
    widths = {}
    for dtype, key, Ds in ((torch.bfloat16, "bf16", (256, 512)),
                           (torch.float32, "f32", (128, 256, 384, 512, 640, 896))):
        for D in Ds:
            err, _ = ln_errors(*ln_inputs(999, D, dtype, seed=D), key)
            widths[f"{key}_{D}"] = {k: err[k] for k in ("y_max_rel", "g_max_rel")}
    emit("kernel_ln", case="widths", shape=[999, "D"], **widths)
    return trained


def transposed_vs_plain(q3, k3, v3, do3, scale, key, slice_=48):
    """pk_fwd and the split pair at num_heads=1 on [B*H, S, 64] (the
    transposed kernels) against the plain versions, on slices of `slice_`
    sequences; -> (errors, o, lse, plain ms of the forward, of pk_dq, of
    pk_dkv)."""
    args = dict(scale=scale, num_heads=1)
    o3, lse = fa.pk_fwd(q3, k3, v3, **args)
    dq3, delta = fa.pk_dq(q3, k3, v3, o3, lse, do3, **args)
    grads = (dq3, *fa.pk_dkv(q3, k3, v3, lse, do3, delta, **args))
    torch.cuda.synchronize()
    stats = dict.fromkeys(("o", "lse", "dq", "dk", "dv"), 0.0)
    peak = dict.fromkeys(stats, 0.0)
    plain_fwd_ms = plain_dq_ms = plain_dkv_ms = 0.0
    for i in range(0, q3.shape[0], slice_):
        part = [t[i:i + slice_] for t in (q3, k3, v3)]
        o_p, l_p = fa.pk_fwd_plain(*part, **args)
        o_i, l_i, do_i = o3[i:i + slice_], lse[i:i + slice_], do3[i:i + slice_]
        want = fa.pk_bwd_plain(*part, o_i, l_i, do_i, **args)
        for name, got, ref in (("o", o3, o_p), ("lse", lse, l_p), *zip(
                ("dq", "dk", "dv"), grads, want)):
            stats[name] = max(stats[name], max_abs(got[i:i + slice_], ref))
            peak[name] = max(peak[name], ref.float().abs().max().item())
        del o_p, l_p, want
        plain_fwd_ms += cuda_ms(lambda: fa.pk_fwd_plain(*part, **args), 1)
        plain_dq_ms += cuda_ms(lambda: fa.pk_dq_plain(*part, o_i, l_i, do_i, **args), 1)
        plain_dkv_ms += cuda_ms(lambda: fa.pk_dkv_plain(
            *part, l_i, do_i, delta[i:i + slice_], **args), 1)
    err = {f"{n}_max_abs": stats[n] for n in stats}
    err.update({f"{n}_max_rel": stats[n] / peak[n] for n in ("o", "dq", "dk", "dv")})
    for t in (o3, *grads):
        check(torch.isfinite(t).all().item(), f"transposed {key}: non-finite kernel output")
    if key == "bf16":
        ok = (err["o_max_rel"] <= TOL_BF16_O_REL and err["lse_max_abs"] <= TOL_BF16_LSE
              and max(err[f"{n}_max_rel"] for n in ("dq", "dk", "dv")) <= TOL_BWD_BF16_REL)
    else:
        ok = (err["o_max_abs"] <= TOL_F32 and err["lse_max_abs"] <= TOL_F32
              and max(err[f"{n}_max_rel"] for n in ("dq", "dk", "dv")) <= TOL_BWD_F32_REL)
    check(ok, f"transposed {key}: {err}")
    return err, o3, lse, delta, plain_fwd_ms, plain_dq_ms, plain_dkv_ms


def phase_kernel_transposed():
    """flash_attention (the transposed Function) forward and backward at
    [32, 2305, 12, 64] bf16 and [4, 2305, 12, 64] fp32: one drive through
    the entry point (the only launches of the transposed forward: no model
    reaches it), counted from 0; then the kernels on the transposed layout
    (the forward and the split pair at one head) against their plain
    versions; at the bf16 shape the times beside the bounds, the pair in
    turns with the fused kernel at one head, the library's backward alone
    and scaled_dot_product_attention's forward and forward + backward."""
    vc = get_config("b16").vision
    S, H, hd = vc.num_patches + 1, vc.num_heads, vc.head_dim
    scale = hd**-0.5
    launches, out = dict.fromkeys(KERNELS, 0), {}
    for batch, dtype in ((32, torch.bfloat16), (4, torch.float32)):
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        g = torch.Generator(device="cuda").manual_seed(300 + batch)
        q, k, v, do = (torch.randn(batch, S, H, hd, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_counts()
        o = fa.flash_attention(*leaves, scale=scale)
        o.backward(do)
        torch.cuda.synchronize()
        drive = read_counts()
        check(drive == {**dict.fromkeys(KERNELS, 0), "transposed_fwd": 1, "transposed_dq": 1,
                        "transposed_dkv": 1},
              f"transposed {key}: {drive} launches in one forward + backward")
        launches = {n: launches[n] + drive[n] for n in KERNELS}
        q3, k3, v3, do3 = (fa._to3(t) for t in (q, k, v, do))
        err, o3, lse, delta, plain_fwd_ms, plain_dq_ms, plain_dkv_ms = transposed_vs_plain(
            q3, k3, v3, do3, scale, key)
        check(torch.equal(fa._from3(o3, batch, H), o.detach()),
              f"transposed {key}: the Function's output is not the kernel's")
        grads = fa.pk_bwd_split(q3, k3, v3, o3, lse, do3, scale=scale, num_heads=1)
        for name, leaf, want in zip(("dq", "dk", "dv"), leaves, grads):
            check(torch.equal(fa._to3(leaf.grad), want),
                  f"transposed {key}: the Function's {name} is not the pair's")
        row = {"shape": [batch, S, H, hd], "layout": list(q3.shape), **err}
        if key == "bf16":
            BH = batch * H
            fb = fwd_bound(BH, S, hd, 1)
            dqb, dkvb = dq_bound(BH, S, hd, 1), dkv_bound(BH, S, hd, 1)
            args = dict(scale=scale, num_heads=1)
            with torch.no_grad():
                fn_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, scale=scale), 10)
            turns = []
            for bwd in (fa.pk_bwd, fa.pk_bwd_split, fa.pk_bwd_split, fa.pk_bwd):
                turns.append(cuda_ms(lambda: bwd(q3, k3, v3, o3, lse, do3, **args), 10))
            lib_bwd, lib_op = sdpa_bwd_ms(q3, k3, v3, 1, scale, do3)
            pair_op = f"{lib_op} (dq, dk and dv: the pair's)"
            out = {
                "fwd": {"max_abs_err": err["o_max_abs"],
                        "ms": cuda_ms(lambda: fa.pk_fwd(q3, k3, v3, **args), 20),
                        "plain_ms": plain_fwd_ms, "library_ms": sdpa_ms(q3, k3, v3, 1, scale),
                        "bound_ms": fb[0], "bound_by": fb[1], "function_ms": fn_ms},
                # the halves of the pair beside the pair's library time (no
                # library call computes only dq, or only dk and dv)
                "dq": {"max_abs_err": err["dq_max_abs"],
                       "ms": cuda_ms(lambda: fa.pk_dq(q3, k3, v3, o3, lse, do3, **args), 10),
                       "plain_ms": plain_dq_ms, "library_ms": lib_bwd, "library_op": pair_op,
                       "bound_ms": dqb[0], "bound_by": dqb[1]},
                "dkv": {"max_abs_err": max(err["dk_max_abs"], err["dv_max_abs"]),
                        "ms": cuda_ms(lambda: fa.pk_dkv(q3, k3, v3, lse, do3, delta, **args), 10),
                        "plain_ms": plain_dkv_ms, "library_ms": lib_bwd, "library_op": pair_op,
                        "bound_ms": dkvb[0], "bound_by": dkvb[1]},
                "bwd": {"pair_ms": (turns[1] + turns[2]) / 2,
                        "fused_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns,
                        "pair_bound_ms": dqb[0] + dkvb[0], "library_ms": lib_bwd,
                        "library_op": lib_op,
                        "library_fwd_bwd_ms": sdpa_ms(q3, k3, v3, 1, scale, do=do3)},
            }
            row.update({f"{d}_{k}": v for d in out for k, v in out[d].items()
                        if k != "max_abs_err"})
        emit("kernel_transposed", dtype=key, launches=drive, **row)
        del q, k, v, do, leaves, o, q3, k3, v3, do3, o3, lse, delta
        torch.cuda.empty_cache()
    return out, launches


N_IMAGES = 2500  # config.yaml's train set: the device pool is sized for it


def cached_data(rng, n, max_gt, S, n_classes):
    """n images with their GT (flat uint8, as the loader sends them) and
    their rows in the train set, distinct and spread over the pool."""
    data = train_batch(rng, n, max_gt, S, n_classes)
    data["indices"] = rng.choice(N_IMAGES, n, replace=False)
    return data


def epoch_batches(data, batch, order, with_image):
    for start in range(0, len(order), batch):
        sel = order[start:start + batch]
        b = {k: data[k][sel] for k in ("labels", "boxes", "gt_mask", "indices")}
        if with_image:
            b["image"] = data["image"][sel]
        yield b


def cached_run(data, orders, batch, max_gt, n_classes, store_dtype=None):
    """Trainer.train_step with cache_backbone over the epochs in `orders`
    (epoch 1 with images, later epochs without): B/16 bf16, random weights
    (seed 0), the pool sized for N_IMAGES rows. Checks the terms, the frozen
    and trainable parameters; returns the trainer and the run's record."""
    mcfg = get_config("b16")
    config = Config(DataConfig(max_gt=max_gt),
                    TrainingConfig(learning_rate=3e-6, weight_decay=0.1, batch_size=batch,
                                   checkpoint_dir=None, cache_backbone=True,
                                   cache_store_dtype=store_dtype),
                    ModelConfig(name="b16", dtype="bfloat16", trainable_last_k=1))
    model = owlvit.init(mcfg, torch.Generator().manual_seed(0),
                        num_queries=3 * n_classes, device="cuda")
    trainer = Trainer(config, model, n_classes, steps_per_epoch=len(orders[0]) // batch,
                      class_weights=np.linspace(0.5, 1.5, n_classes, dtype=np.float32),
                      device="cuda", n_images=N_IMAGES)
    check(trainer.act_store == "device",
          f"auto store for {N_IMAGES} B/16 rows: {trainer.act_store}")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, terms, phases = [], [], []
    for epoch, order in enumerate(orders):
        for b in epoch_batches(data, batch, order, with_image=epoch == 0):
            timer = PhaseTimer()
            t0 = time.perf_counter()
            terms.append(trainer.train_step(b, mark=timer).tolist())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            phases.append(timer.durations())
    launches = read_counts()
    record = {"terms": terms, "step_wall_ms": walls, "phases_ms": phases,
              "launches": launches,
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(np.isfinite(terms).all(), f"non-finite loss terms {terms}")
    trainable = {id(p) for p in trainer.params}
    for n, p in model.named_parameters():
        same = torch.equal(p, before[n])
        check(not same if id(p) in trainable else same,
              f"cached: {'trainable' if id(p) in trainable else 'frozen'} {n}: "
              f"{'unchanged' if same else 'changed'}")
    return trainer, record


def fresh_prefix(trainer, data, sel):
    """embed_prefix of the images at `sel`, recomputed from the pixels."""
    S = trainer.model_cfg.vision.image_size
    img = torch.from_numpy(data["image"][sel]).cuda().reshape(len(sel), S, S, 3)
    return owlvit.embed_prefix(trainer.model, trainer.model_cfg, normalize_image(img))


def l2_rel(got, want, keep):
    """||got - want|| / ||want|| over the tensors at `keep`, in fp32."""
    diff = sum(((got[i].float() - want[i].float()) ** 2).sum() for i in keep)
    return (diff / sum((want[i].float() ** 2).sum() for i in keep)).sqrt().item()


def hybrid_step(trainer, batch):
    """One tail step on stored rows, packed, then the same step from the
    same state under OWLVIT_PACKED_FLASH=0 (hybrid: the transposed
    backward); the trainer is left after the hybrid step. Holds the terms,
    the gradients and the update to the packed step's."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    params = trainer.params
    start = [p.detach().clone() for p in params]
    opt_state, step = copy.deepcopy(trainer.opt.state_dict()), trainer.step
    terms_p = trainer.train_step(dict(batch))
    grad_p = [p.grad.clone() for p in params]
    upd_p = [p.detach() - s for p, s in zip(params, start)]
    with torch.no_grad():
        for p, s in zip(params, start):
            p.copy_(s)
    trainer.opt.load_state_dict(opt_state)
    trainer.step = step
    with switches(OWLVIT_PACKED_FLASH="0"):
        reset_counts()
        terms_h = trainer.train_step(dict(batch))
        torch.cuda.synchronize()
        launches = read_counts()
    grad_h = [p.grad for p in params]
    upd_h = [p.detach() - s for p, s in zip(params, start)]
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": 1, "transposed_dq": 1,
                       "transposed_dkv": 1, **matched(1)},
          f"hybrid step: {launches} launches")
    every = range(len(params))
    key_bias = [i for i in every if names[id(params[i])].endswith("attn.k.bias")]
    check(len(key_bias) == 1, f"the trained tail has {len(key_bias)} key biases")
    keep = [i for i in every if i not in key_bias]
    record = {"terms_packed": terms_p.tolist(), "terms_hybrid": terms_h.tolist(),
              "terms_equal": bool(np.array_equal(terms_h, terms_p)),
              "grad_l2_rel": l2_rel(grad_h, grad_p, every),
              "update_l2_rel": l2_rel(upd_h, upd_p, keep),
              "update_max_abs_diff": max((upd_h[i] - upd_p[i]).abs().max().item() for i in keep),
              "update_max_abs": max(upd_p[i].abs().max().item() for i in keep),
              "key_bias_grad_max_abs": grad_p[key_bias[0]].abs().max().item(),
              "grad_max_abs": max(g.abs().max().item() for g in grad_p),
              "launches": launches}
    check(record["terms_equal"] and record["grad_l2_rel"] <= TOL_HYBRID_GRAD
          and record["update_l2_rel"] <= TOL_HYBRID_UPDATE,
          f"hybrid step vs packed step: {record}")
    return record


def phase_train_cached(n_rows=64, batch=32, max_gt=64, n_classes=80):
    """The cached train step, B/16 bf16 batch 32, 64 images of a 2500-row
    pool: epoch 1 (2 steps) fills the pool, epoch 2 (2 steps) gathers.
    Three runs: default (bf16 pool), then one tail step under
    OWLVIT_PACKED_FLASH=0 against the packed step on the same rows, then
    OWLVIT_FUSED_LN=1 with the int8 pool. Returns the launches summed over
    the runs."""
    L = get_config("b16").vision.num_layers
    S = get_config("b16").vision.image_size
    rng = np.random.default_rng(5)
    data = cached_data(rng, n_rows, max_gt, S, n_classes)
    orders = [np.arange(n_rows), rng.permutation(n_rows)]
    fills, steps = n_rows // batch, 2 * n_rows // batch
    total = dict.fromkeys(KERNELS, 0)

    with switches(OWLVIT_FUSED_LN=None, OWLVIT_PACKED_FLASH=None):
        trainer, rec = cached_run(data, orders, batch, max_gt, n_classes)
    check(rec["launches"] == {**dict.fromkeys(KERNELS, 0),
                              "pk_fwd": (L - 1) * fills + steps, **pair(steps),
                              **matched(steps)},
          f"cached default: {rec['launches']} launches")
    sel = orders[0][:batch]
    with torch.no_grad():
        fresh = fresh_prefix(trainer, data, sel)
        stored = trainer.pool_gather(torch.from_numpy(data["indices"][sel]).cuda())
    check(torch.equal(stored, fresh), "the pool's rows differ from a fresh embed_prefix")
    pool_gb = trainer.pool.numel() * trainer.pool.element_size() / 1e9
    emit("train_cached", run="default", model="b16", dtype="bfloat16", store="bfloat16",
         pool_rows=N_IMAGES, pool_gb=pool_gb, batch=batch, images=n_rows,
         epoch2_img_per_s=batch * (steps - fills) / (sum(rec["step_wall_ms"][fills:]) / 1e3),
         gathered_bit_equal=True, **rec)
    total = {n: total[n] + rec["launches"][n] for n in KERNELS}
    unfused_terms = rec["terms"]

    hyb = hybrid_step(trainer, next(epoch_batches(data, batch, orders[1], with_image=False)))
    emit("train_cached_hybrid_step", **hyb)
    total = {n: total[n] + hyb["launches"][n] for n in KERNELS}
    del trainer, fresh, stored
    torch.cuda.empty_cache()

    with switches(OWLVIT_FUSED_LN="1", OWLVIT_PACKED_FLASH=None):
        trainer, rec = cached_run(data, orders, batch, max_gt, n_classes, store_dtype="int8")
        # the fused add+LN branch's attention takes the split pair
        check(rec["launches"] == {**dict.fromkeys(KERNELS, 0),
                                  "pk_fwd": (L - 1) * fills + steps, "pk_dq": steps,
                                  "pk_dkv": steps,
                                  "add_ln_fwd": 2 * (L - 1) * fills + 2 * steps,
                                  "add_ln_bwd": 2 * steps, **matched(steps)},
              f"cached fused: {rec['launches']} launches")
        with torch.no_grad():
            fresh = fresh_prefix(trainer, data, sel).float()
            rows = torch.from_numpy(data["indices"][sel]).cuda()
            deq = dequantize_rows(trainer.pool["q"].index_select(0, rows),
                                  trainer.pool["s"].index_select(0, rows), torch.float32)
        # half a step, plus the fp32 rounding of x / s and q * s
        step_bound = fresh.abs().amax(-1, keepdim=True) / 254 * (1 + 1e-4)
        int8_err = ((deq - fresh).abs() / step_bound).max().item()
        check(int8_err <= 1.0, f"int8 pool rows beyond rowmax/254: {int8_err}")
    rel = (np.abs(np.subtract(rec["terms"][:fills], unfused_terms[:fills]))
           / np.abs(unfused_terms[:fills]))
    check(rel.max() <= TOL_FUSED_TERMS, f"fused vs unfused epoch-1 terms: {rel.tolist()}")
    pool_gb = sum(t.numel() * t.element_size() for t in trainer.pool.values()) / 1e9
    emit("train_cached", run="fused_ln_int8", model="b16", dtype="bfloat16", store="int8",
         pool_rows=N_IMAGES, pool_gb=pool_gb, batch=batch, images=n_rows,
         epoch2_img_per_s=batch * (steps - fills) / (sum(rec["step_wall_ms"][fills:]) / 1e3),
         epoch1_terms_max_rel_vs_unfused=rel.max().item(),
         int8_err_over_rowmax_254=int8_err, **rec)
    total = {n: total[n] + rec["launches"][n] for n in KERNELS}
    del trainer, fresh, deq
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------- bench_cached

BENCH_BATCH, BENCH_STEPS, BENCH_CLASSES = 32, 20, 80


def uncached_steps(name, batch, steps, n_classes):
    """The full train step (prefix, tail, loss, backward, AdamW) on
    bench_cached's batch and recipe, timed per step with StepTimer ->
    (summary, last loss)."""
    cfg = get_config(name, dtype="bfloat16", trainable_last_k=1)
    model = owlvit.init(cfg, torch.Generator().manual_seed(0),
                        num_queries=3 * n_classes, device="cuda")
    opt = torch.optim.AdamW(partition_params(model, 1), lr=3e-6, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1)
    data = bench_cached.build_batch(cfg, batch, n_classes, 0, device="cuda")
    timer = StepTimer()
    for i in range(steps + 1):  # the first step warms up
        timer.start()
        boxes, sims = owlvit.forward_train(model, cfg, normalize_image(data["image"]))
        loss = losses.total_loss(losses.push_pull_loss(
            sims, boxes, data["labels"], data["boxes"], data["gt_mask"], n_classes))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        timer.stop(loss)
        if i == 0:
            timer.durations.clear()
    return timer.summary(), float(loss.detach())


def phase_bench_cached(name="b16", batch=BENCH_BATCH, steps=BENCH_STEPS,
                       n_classes=BENCH_CLASSES):
    """utils/bench_cached.measure_cached_steady_state at B/16 bf16, batch
    32, 20 steps a phase (resident, gather, split), then the uncached full
    step on the same recipe timed with StepTimer: img/s, the loss, MFU from
    utils/flops.py against the card's peak, launches and peak memory.
    Returns the launches."""
    cfg = get_config(name, dtype="bfloat16", trainable_last_k=1)
    L = cfg.vision.num_layers
    peak = flops.chip_peak_flops(torch.cuda.get_device_name(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = bench_cached.measure_cached_steady_state(name, batch, steps, n_classes=n_classes,
                                                   device="cuda")
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    cached_gb = torch.cuda.max_memory_allocated() / 1e9
    tail_steps = 3 * (steps + 1)  # resident, gather, split: a warm-up step each
    check(np.isfinite(res["loss"]), f"bench_cached loss {res['loss']}")
    check(all(res[k] and res[k] > 0 for k in ("tail_imgs_per_sec", "gather_imgs_per_sec",
                                               "split_gather_imgs_per_sec")), f"rates {res}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": (L - 1) + tail_steps,
                       **pair(tail_steps), **matched(tail_steps)},
          f"bench_cached: {launches} launches for the prefix and {tail_steps} tail steps")
    total = dict(launches)
    gc.collect()
    torch.cuda.empty_cache()

    # the gathered step with the default backward (the pair) and under
    # OWLVIT_PACKED_BWD=fused, in turns: pair (above), fused, fused, pair
    gather = {"pair": [res["gather_imgs_per_sec"]], "fused": []}
    for mode in ("fused", "fused", "pair"):
        with switches(OWLVIT_PACKED_BWD="fused" if mode == "fused" else None):
            reset_counts()
            r = bench_cached.measure_cached_steady_state(
                name, batch, steps, n_classes=n_classes, split_gather=False, device="cuda")
            launches = read_counts()
        ab_steps = 2 * (steps + 1)  # resident and gather, a warm-up step each
        bwd = {"pk_bwd": ab_steps} if mode == "fused" else pair(ab_steps)
        check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": (L - 1) + ab_steps, **bwd,
                           **matched(ab_steps)}, f"bench_cached {mode}: {launches} launches")
        total = {k: total[k] + launches[k] for k in KERNELS}
        gather[mode].append(r["gather_imgs_per_sec"])
        gc.collect()
        torch.cuda.empty_cache()
    gather_ab = {mode: {"imgs_per_sec": ips, "step_ms": [batch / x * 1e3 for x in ips],
                        "mean_imgs_per_sec": sum(ips) / len(ips)}
                 for mode, ips in gather.items()}

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    summary, loss = uncached_steps(name, batch, steps, n_classes)
    launches = read_counts()
    uncached_gb = torch.cuda.max_memory_allocated() / 1e9
    check(np.isfinite(loss), f"uncached loss {loss}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * (steps + 1),
                       **pair(steps + 1), **matched(steps + 1)},
          f"uncached: {launches} launches in {steps + 1} steps")
    total = {k: total[k] + launches[k] for k in KERNELS}
    uncached_ips = batch / summary["p50_s"]
    f_cached = flops.train_flops_per_image(cfg, 3 * n_classes, cached=True)
    f_uncached = flops.train_flops_per_image(cfg, 3 * n_classes)
    emit("bench_cached", model=name, dtype="bfloat16", batch=batch, steps=steps,
         **res, wall_s=wall_s, uncached_imgs_per_sec=uncached_ips, uncached_loss=loss,
         uncached_step_s=summary, chip_peak_bf16_flops=peak,
         gflop_per_image={"cached": f_cached / 1e9, "uncached": f_uncached / 1e9},
         mfu_cached={k: flops.mfu(res[f"{k}_imgs_per_sec"], f_cached, peak)
                     for k in ("tail", "gather", "split_gather")},
         mfu_uncached=flops.mfu(uncached_ips, f_uncached, peak),
         max_memory_allocated_gb={"cached": cached_gb, "uncached": uncached_gb},
         gather_pair_vs_fused=gather_ab, launches=total)
    gc.collect()
    torch.cuda.empty_cache()
    return total


RUN_COLORS = ((220, 40, 40), (40, 190, 60), (50, 80, 230), (230, 210, 40))
RUN_LABELMAP = {0: "red box", 1: "green box", 2: "blue box", 3: "yellow box"}


class SmokeSet(DetectionDataset):
    """n images at S x S held in memory: a plain background and 1-4 filled
    rectangles, each colour a class, made with numpy from the seed. The
    interface of DetectionDataset (whose GT padding, class weights and
    sample layout it inherits); no file is read or decoded."""

    def __init__(self, n, S, max_gt, seed):  # not super().__init__: it reads files
        rng = np.random.default_rng(seed)
        self.image_size, self.max_gt, self.images_dir = S, max_gt, ""
        self.images = np.empty((n, S, S, 3), np.uint8)
        self.items = []
        for i in range(n):
            self.images[i] = rng.integers(0, 256, 3, dtype=np.uint8)
            anns = []
            for _ in range(int(rng.integers(1, 5))):
                w, h = (int(v) for v in rng.integers(S // 10, S // 3, 2))
                x0, y0 = int(rng.integers(0, S - w)), int(rng.integers(0, S - h))
                label = int(rng.integers(0, len(RUN_COLORS)))
                self.images[i, y0:y0 + h, x0:x0 + w] = RUN_COLORS[label]
                anns.append({"bbox": [x0, y0, w, h], "label": label})
            self.items.append((f"smoke_{i}", anns))

    def load_batch(self, idxs, with_images: bool = True) -> list:
        S = self.image_size
        return [self._make_sample(int(i), self.images[int(i)] if with_images else None, S, S)
                for i in idxs]


def run_config(workdir, n_epochs, batch, max_gt):
    return Config(DataConfig(max_gt=max_gt),
                  TrainingConfig(n_epochs=n_epochs, learning_rate=3e-6, weight_decay=0.1,
                                 batch_size=batch, eval_every_epochs=1,
                                 checkpoint_dir=os.path.join(workdir, "ckpt"),
                                 log_file="metrics.jsonl", cache_backbone=True,
                                 cache_backbone_store="device", seed=0),
                  ModelConfig(name="b16", dtype="bfloat16", trainable_last_k=1))


def jsonl_rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def check_rows(rows, n, n_classes):
    check(len(rows) == n, f"{len(rows)} JSONL rows, expected {n}")
    for row in rows:
        terms = [row[f"train_{k}"] for k in ("loss_ce", "loss_bg", "loss_bbox", "loss_giou")]
        check(np.isfinite(terms).all(), f"non-finite train terms {row}")
        check(-1.0 <= row["val_map"] <= 1.0, f"val_map {row['val_map']}")


def host_facts():
    """Whether the machine has Pillow and the libpng and libjpeg headers
    (information for the decode path; nothing branches on it)."""
    dirs = ("/usr/include", "/usr/local/include")
    return {"pillow": importlib.util.find_spec("PIL") is not None,
            **{h: any(os.path.exists(os.path.join(d, h)) for d in dirs)
               for h in ("png.h", "jpeglib.h")}}


def timed_eval(trainer, record):
    """Wrap trainer.evaluate (the run calls it through the instance) to time
    each eval and keep its first batch's pixels and packed detections."""
    evaluate, eval_batch = trainer.evaluate, trainer.eval_batch

    def first_batch(image):
        packed = eval_batch(image)
        if "first_batch" not in record:
            record["first_batch"] = (image.cpu(), packed)
        return packed

    def timed(*args, **kwargs):
        record.pop("first_batch", None)  # keep the last eval's
        t0 = time.perf_counter()
        out = evaluate(*args, **kwargs)
        record.setdefault("eval_s", []).append(time.perf_counter() - t0)
        return out

    trainer.eval_batch, trainer.evaluate = first_batch, timed


def drive_run(trainer):
    """trainer.run() with the launch counts from 0; -> (metrics, launches, s)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    metrics = trainer.run()
    torch.cuda.synchronize()
    return metrics, read_counts(), time.perf_counter() - t0


def phase_run(workdir, n_train=96, n_test=32, batch=32, max_gt=16):
    """The fine-tune run through Trainer.with_data in `workdir`: 2 epochs, a
    resume to 3, a resume that only evaluates; its checkpoints stay there
    for phase export. Returns the launches of the three runs."""
    S = get_config("b16").vision.image_size
    L = get_config("b16").vision.num_layers
    n_classes = len(RUN_LABELMAP)
    train_ds, test_ds = SmokeSet(n_train, S, max_gt, seed=0), SmokeSet(n_test, S, max_gt, seed=1)
    steps, evals = n_train // batch, -(-n_test // batch)
    total = dict.fromkeys(KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer.with_data(run_config(workdir, 2, batch, max_gt), train_ds, test_ds,
                                RUN_LABELMAP, workdir, device="cuda")
    bank = trainer.model.queries.detach()
    norms = torch.linalg.vector_norm(bank.float(), dim=-1)
    check(bank.is_cuda and bank.shape[0] == 3 * n_classes
          and ((norms - 1).abs() <= 1e-3).all().item(),
          f"query bank {bank.device} {tuple(bank.shape)} norms {norms.tolist()}")
    record = {}
    timed_eval(trainer, record)
    metrics, launches, run1_s = drive_run(trainer)
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * (steps + 2 * evals) + steps,
                       **pair(2 * steps), **matched(2 * steps)},
          f"run 1: {launches} launches ({steps} filled and {steps} gathered steps, "
          f"{2 * evals} eval batches)")
    total = {k: total[k] + launches[k] for k in KERNELS}
    rows = jsonl_rows(workdir)
    check_rows(rows, 2, n_classes)
    check(len(metrics["map_per_class"]) == n_classes, f"map_per_class {metrics['map_per_class']}")
    with open(os.path.join(workdir, "class_maps.json")) as f:
        class_maps = json.load(f)
    check(sorted(class_maps) == sorted(RUN_LABELMAP.values())
          and all(len(v) == 2 for v in class_maps.values()), f"class_maps.json {class_maps}")
    image, packed = record["first_batch"]
    check(np.array_equal(image.numpy().reshape(test_ds.images[:batch].shape),
                         test_ds.images[:batch]), "the eval batch's pixels")
    with torch.no_grad():
        px = normalize_image(torch.from_numpy(test_ds.images[:batch]).cuda())
        boxes, sims = owlvit.forward_train(trainer.model, trainer.eval_cfg, px)
        t_cfg = trainer.cfg.training
        direct = nms_ops.pack_detections(nms_ops.postprocess(
            boxes, sims, confidence_threshold=t_cfg.confidence_threshold,
            iou_threshold=t_cfg.iou_threshold, top_k=t_cfg.top_k)).cpu().numpy()
    check(np.array_equal(direct, packed),
          "evaluate's packed detections differ from a direct forward + NMS")
    saved = [p.detach().cpu() for p in trainer.params]
    run1 = {"s": run1_s, "epochs": [{k: r[k] for k in ("epoch", "step", "epoch_train_secs",
                                                      "epoch_imgs_per_sec")} for r in rows],
            "eval_s": record["eval_s"], "eval_s_per_image": [s / n_test for s in record["eval_s"]],
            "val_map": metrics["map"], "launches": launches,
            "query_bank_s": trainer.query_bank_secs,
            "detections_first_batch": int((packed[..., 6] > 0.5).sum())}
    del trainer, bank, boxes, sims, px
    gc.collect()

    trainer = Trainer.with_data(run_config(workdir, 3, batch, max_gt), train_ds, test_ds,
                                RUN_LABELMAP, workdir, device="cuda")
    check(trainer.step == 2 * steps, f"resumed at step {trainer.step}")
    check(all(torch.equal(p.detach().cpu(), s) for p, s in zip(trainer.params, saved)),
          "the resumed trainable parameters differ from the saved ones")
    record = {}
    timed_eval(trainer, record)
    _, launches, run2_s = drive_run(trainer)
    check(trainer.step == 3 * steps, f"run 2 ended at step {trainer.step}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * (steps + evals),
                       **pair(steps), **matched(steps)}, f"run 2: {launches} launches")
    total = {k: total[k] + launches[k] for k in KERNELS}
    rows = jsonl_rows(workdir)
    check_rows(rows, 3, n_classes)
    run2 = {"s": run2_s, "epochs": [{k: rows[-1][k] for k in (
        "epoch", "step", "epoch_train_secs", "epoch_imgs_per_sec")}],
        "eval_s_per_image": [s / n_test for s in record["eval_s"]], "launches": launches}
    del trainer
    gc.collect()

    trainer = Trainer.with_data(run_config(workdir, 3, batch, max_gt), train_ds, test_ds,
                                RUN_LABELMAP, workdir, device="cuda")
    metrics, launches, run3_s = drive_run(trainer)
    check(trainer.step == 3 * steps and len(jsonl_rows(workdir)) == 3 and "map" in metrics,
          f"run 3 trained: step {trainer.step}")
    check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L * evals},
          f"run 3: {launches} launches")
    total = {k: total[k] + launches[k] for k in KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    emit("run", model="b16", dtype="bfloat16", batch=batch, images=[n_train, n_test],
         run1=run1, run2=run2, run3={"s": run3_s, "launches": launches},
         max_memory_allocated_gb=peak_gb, host=host_facts())
    return total


# ------------------------------------------------------------------- stage

STAGE_TRAIN, STAGE_TEST, STAGE_EPOCHS = 256, 32, 3


def stage_config(n_epochs, batch, max_gt, stage, cached):
    """The stage phase's run: eval after every epoch, no checkpoints."""
    return Config(DataConfig(max_gt=max_gt),
                  TrainingConfig(n_epochs=n_epochs, learning_rate=3e-6, weight_decay=0.1,
                                 batch_size=batch, eval_every_epochs=1,
                                 checkpoint_dir=None, log_file="metrics.jsonl",
                                 cache_backbone=cached, cache_backbone_store="device",
                                 stage_pixels=stage, seed=0),
                  ModelConfig(name="b16", dtype="bfloat16", trainable_last_k=1))


def stage_run(train_ds, test_ds, stage, n_epochs, batch, max_gt, cached):
    """One run through Trainer.with_data in a temporary directory, the
    steps of its device epochs (if any) under sync debug mode "error": any
    host read or synchronising copy in them raises (the epoch's one copy
    in and one read out lie outside). -> (trainer, metrics, launches,
    seconds, JSONL rows, the epochs run as the device epoch)."""
    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer.with_data(stage_config(n_epochs, batch, max_gt, stage, cached),
                                    train_ds, test_ds, RUN_LABELMAP, workdir, device="cuda")
        device_epochs = []
        run_epoch, device_steps = trainer._run_epoch_device, trainer._device_steps

        def spy(epoch):
            device_epochs.append(epoch)
            return run_epoch(epoch)

        def steps_sync_error(*args):
            old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return device_steps(*args)
            finally:
                torch.cuda.set_sync_debug_mode(old)

        trainer._run_epoch_device, trainer._device_steps = spy, steps_sync_error
        metrics, launches, secs = drive_run(trainer)
        rows = jsonl_rows(workdir)
    return trainer, metrics, launches, secs, rows, device_epochs


def phase_stage(n_train=STAGE_TRAIN, n_test=STAGE_TEST, batch=32, max_gt=16,
                n_epochs=STAGE_EPOCHS):
    """training.stage_pixels: on, B/16 bf16, batch 32, the backward's split
    pair (OWLVIT_PACKED_BWD=both: the same bits from launch to launch): the
    cached device store over n_train in-memory images for n_epochs (epoch 1
    fills the store from the staged pixels, epochs 2-3 are device epochs
    under sync debug mode "error"), in turns with the streamed run of the
    same config (staged, streamed, streamed, staged: the first run of the
    phase pays the first launches at its shapes), then one uncached epoch
    (a device epoch) and its streamed run: the JSONL terms, val_map and the
    trained parameters of each staged run bit-equal to the streamed run's,
    launches as the paths imply. Epoch walls and img/s of all six runs, and
    the "match" phase's device ms on one more gathered step of the second
    staged trainer. Returns the launches of the six runs."""
    mcfg = get_config("b16")
    S, L = mcfg.vision.image_size, mcfg.vision.num_layers
    train_ds = SmokeSet(n_train, S, max_gt, seed=2)
    test_ds = SmokeSet(n_test, S, max_gt, seed=3)
    steps, evals = n_train // batch, -(-n_test // batch)
    total = dict.fromkeys(KERNELS, 0)
    out, params = {}, {}
    with switches(OWLVIT_PACKED_BWD="both"):
        for name, stage, epochs, cached in (("staged", "on", n_epochs, True),
                                            ("streamed", "off", n_epochs, True),
                                            ("streamed_2", "off", n_epochs, True),
                                            ("staged_2", "on", n_epochs, True),
                                            ("staged_uncached", "on", 1, False),
                                            ("streamed_uncached", "off", 1, False)):
            trainer, metrics, launches, secs, rows, dev_epochs = stage_run(
                train_ds, test_ds, stage, epochs, batch, max_gt, cached)
            pk_fwd = (L * steps + (epochs - 1) * steps if cached else L * epochs * steps)
            want = {**dict.fromkeys(KERNELS, 0), "pk_fwd": pk_fwd + L * evals * epochs,
                    "pk_dq": epochs * steps, "pk_dkv": epochs * steps,
                    **matched(epochs * steps)}
            check(launches == want, f"stage {name}: {launches} launches, expected {want}")
            want_epochs = ([] if stage == "off" else list(range(1, epochs)) if cached
                           else list(range(epochs)))
            check(dev_epochs == want_epochs, f"stage {name}: device epochs {dev_epochs}")
            check_rows(rows, epochs, len(RUN_LABELMAP))
            out[name] = {"s": secs, "launches": launches, "device_epochs": dev_epochs,
                         "val_map": metrics["map"],
                         "epochs": [{k: r[k] for k in ("epoch", "step", "epoch_train_secs",
                                                       "epoch_imgs_per_sec")} for r in rows],
                         "rows": rows}
            params[name] = [p.detach().to("cpu", copy=True) for p in trainer.params]
            if name == "staged_2":
                check(set(trainer.pix_train) == {"labels", "boxes", "gt_mask"},
                      f"the staged pools after the fill: {sorted(trainer.pix_train)}")
                # the phases of one more gathered step, off the counted run
                idxs = np.arange(batch)
                batch_ = trainer._staged_batch(torch.from_numpy(idxs).cuda(), False)
                batch_["indices"] = idxs
                timer = PhaseTimer()
                trainer.train_step(batch_, mark=timer)
                out[name]["step_phases_ms"] = timer.durations()
            total = {k: total[k] + launches[k] for k in KERNELS}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    for staged, streamed in (("staged", "streamed"), ("staged_2", "streamed"),
                             ("streamed_2", "streamed"),
                             ("staged_uncached", "streamed_uncached")):
        a, b = out[staged]["rows"], out[streamed]["rows"]
        same = all(x[k] == y[k] for x, y in zip(a, b) for k in x
                   if k.startswith(("train_", "val_")))
        check(same and out[staged]["val_map"] == out[streamed]["val_map"],
              f"{staged} vs {streamed}: JSONL rows {a} vs {b}")
        check(all(torch.equal(x, y) for x, y in zip(params[staged], params[streamed])),
              f"{staged} vs {streamed}: the trained parameters differ")
    for rec in out.values():
        rec.pop("rows")
    emit("stage", model="b16", dtype="bfloat16", batch=batch, images=[n_train, n_test],
         max_gt=max_gt, bwd_mode="both", terms_bit_equal=True, params_bit_equal=True,
         match_device_ms=out["staged_2"]["step_phases_ms"]["match"]["device_ms"],
         runs=out, nvidia_smi=nvidia_smi())
    return total


# ------------------------------------------------------------------ export

EXPORT_BATCH = 8
# The loaded artifacts against the eager forward_train on the same pixels,
# max-rel of boxes and sims: the same kernels and the same ops, so any
# difference is an op the traced graph computes another way (read bit-equal
# or not); 1e-5. The CLI's eval through the artifact against its direct
# eval: the metrics within 1e-8 (the JAX package's test of the same).
TOL_EXPORT, TOL_EXPORT_METRICS = 1e-5, 1e-8


def export_cli_config(path, run_dir, batch):
    """A config the CLI reads for phase run's checkpoints: B/16 bf16,
    trainable_last_k 1, 4 classes (the bank of phase run), a synthetic PNG
    set of 16 test images written by the trainer, eval batch `batch`."""
    with open(path, "w") as f:
        f.write(f"""data:
  synthetic_root: {os.path.join(os.path.dirname(path), "synth")}
  num_train_images: {batch}
  num_test_images: {2 * batch}
  max_gt: 16
  synthetic_classes: {len(RUN_LABELMAP)}
training:
  batch_size: {batch}
  checkpoint_dir: {os.path.join(run_dir, "ckpt")}
  confidence_threshold: 0.0
  seed: 0
model:
  name: b16
  dtype: bfloat16
  trainable_last_k: 1
""")


def cli_metrics(argv):
    """cli.main(argv) with its output captured and echoed -> (the metrics
    JSON it prints last, its text)."""
    _, text = captured(lambda: cli.main(argv))
    return json.loads(text[text.index("{\n"):]), text


def forbidden(*args, **kwargs):
    raise RuntimeError("an exported program ran plain attention")


def phase_export(run_dir, batch=EXPORT_BATCH):
    """The serving export on the card: B/16 bf16, random weights (seed 0),
    240 queries, batch 8. export_detector and export_detector_weightless,
    saved to a temporary directory and loaded (the weights of the weightless
    one from the JAX-layout npz); each loaded program on 8 random uint8
    images against the eager forward_train (TOL_EXPORT, and whether
    bit-equal), with exactly 12 pk_fwd launches a call and no plain
    attention; times per batch against eager. Then the CLI's export
    --weightless and eval --from-export --export-params on phase run's
    checkpoints, against the CLI's direct eval. Returns the launches."""
    from owlvit_tpu_torch.models import convert
    from owlvit_tpu_torch.train import export

    cfg = get_config("b16", dtype="bfloat16")
    L, S = cfg.vision.num_layers, cfg.vision.image_size
    model = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=240, device="cuda")
    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (batch, S, S, 3), dtype=np.uint8)).cuda()
    total, row = dict.fromkeys(KERNELS, 0), {"batch": batch, "nvidia_smi": nvidia_smi()}
    eager = export.make_infer_fn(model, cfg)
    ref = eager(images)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"full": os.path.join(tmp, "full.pt2"), "weightless": os.path.join(tmp, "wl.pt2")}
        for name, fn in (("full", export.export_detector),
                         ("weightless", export.export_detector_weightless)):
            t0 = time.perf_counter()
            blob = fn(model, cfg, batch_size=batch)
            row[f"{name}_export_s"] = time.perf_counter() - t0
            export.save_exported(paths[name], blob)
            row[f"{name}_bytes"] = len(blob)
            del blob
        npz = os.path.join(tmp, "wl.pt2.npz")
        convert.save_params(npz, convert.to_jax_tree(model))
        check(row["weightless_bytes"] < row["full_bytes"] / 2,
              f"the weightless artifact is not under half the full one: {row}")
        loaded = {}
        t0 = time.perf_counter()
        loaded["full"] = export.load_exported(paths["full"])
        row["full_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded["weightless"] = export.load_exported_weightless(
            paths["weightless"], convert.load_params(npz), device="cuda")
        row["weightless_load_s"] = time.perf_counter() - t0
        for name, fn in loaded.items():
            fn(images)  # the first call of a loaded program
            torch.cuda.synchronize()
            plain, fa.pk_fwd_plain = fa.pk_fwd_plain, forbidden
            try:
                reset_counts()
                boxes, sims = fn(images)
                torch.cuda.synchronize()
                launches = read_counts()
            finally:
                fa.pk_fwd_plain = plain
            check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L},
                  f"exported {name}: {launches} launches in one call")
            total = {k: total[k] + launches[k] for k in KERNELS}
            err = {"boxes_max_rel": max_rel(boxes, ref[0]), "sims_max_rel": max_rel(sims, ref[1])}
            check(boxes.shape == ref[0].shape and sims.shape == ref[1].shape
                  and max(err.values()) <= TOL_EXPORT,
                  f"exported {name} vs eager forward_train: {err}")
            row[name] = {**err, "launches": launches,
                         "bit_equal": torch.equal(boxes, ref[0]) and torch.equal(sims, ref[1]),
                         "ms_per_batch": cuda_ms(lambda: fn(images), 5)}
        row["eager_ms_per_batch"] = cuda_ms(lambda: eager(images), 5)
        del loaded, ref
        gc.collect()
        torch.cuda.empty_cache()

        # the CLI on phase run's checkpoints
        config = os.path.join(tmp, "config.yaml")
        export_cli_config(config, run_dir, batch)
        art = os.path.join(tmp, "cli.pt2")
        base = ["--config", config, "--workdir", tmp]
        t0 = time.perf_counter()
        _, text = captured(lambda: cli.main(["export", *base, "--out", art,
                                             "--batch-size", str(batch), "--weightless"]))
        row["cli_export_s"] = time.perf_counter() - t0
        check(f"wrote {art}.npz" in text and "resumed from step" in text,
              f"cli export: {text[-500:]}")
        runs, dets = {}, {}
        for name, extra in (("from_export", ["--from-export", art, "--export-params",
                                             f"{art}.npz"]), ("direct", [])):
            dets[name] = os.path.join(tmp, f"{name}.json")
            reset_counts()
            t0 = time.perf_counter()
            runs[name], text = cli_metrics(["eval", *base, *extra,
                                            "--save-detections", dets[name]])
            row[f"cli_eval_{name}_s"] = time.perf_counter() - t0
            launches = read_counts()
            check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": 2 * L},
                  f"cli eval {name}: {launches} launches for 2 eval batches")
            total = {k: total[k] + launches[k] for k in KERNELS}
        check(set(runs["from_export"]) == set(runs["direct"]), f"metric keys {runs}")
        diff = max(float(np.max(np.abs(np.subtract(runs["from_export"][k], runs["direct"][k]))))
                   for k in runs["direct"])
        check(diff <= TOL_EXPORT_METRICS, f"eval through the artifact vs direct: {runs}")
        # the kept detections themselves (a random detector's mAP is ~0)
        kept = {}
        for name, path in dets.items():
            with open(path) as f:
                kept[name] = json.load(f)
        check(len(kept["direct"]) > 0 and kept["from_export"] == kept["direct"],
              f"eval through the artifact kept other detections: "
              f"{len(kept['from_export'])} against {len(kept['direct'])}")
        row["cli_metrics_max_abs_diff"], row["cli_map"] = diff, runs["direct"]["map"]
        row["cli_detections_equal"], row["cli_detections"] = True, len(kept["direct"])
    del model, eager
    gc.collect()
    torch.cuda.empty_cache()
    emit("export", model="b16", dtype="bfloat16", **row)
    return total


# ------------------------------------------------------------ train_options

# The cached hflip step against the uncached one from the same state and the
# same flips: the stored mirrored row is bit-equal to the prefix the uncached
# step computes, so the tail sees the same inputs; the terms are held to
# 1e-3 relative (the tail's bf16 arithmetic on a copied tensor; a flipped
# Hungarian assignment would exceed it).
TOL_HFLIP_TERMS = 1e-3
# remat: the recomputed forward is bit-equal (pk_fwd is deterministic), and a
# stack of 12 trained layers takes the split pair, whose dq is the same from
# launch to launch: the no-remat step repeated from the same state gives
# bit-equal gradients. remat against no remat is held to 1e-3 in L2 norm (a
# fixed limit; they may differ where the recomputed graph reorders a sum).
TOL_REMAT = 1e-3


class RecipePool(Trainer):
    """Trainer whose device pool is sized for config.yaml's N_IMAGES train
    images (two rows each under augment_hflip) whatever the data set's
    length: the smoke trains on the first rows of the recipe's pool."""

    def __init__(self, *args, n_images=None, **kwargs):
        super().__init__(*args, n_images=N_IMAGES if n_images else None, **kwargs)


def options_config(n_epochs, batch, max_gt, **training):
    return Config(DataConfig(max_gt=max_gt),
                  TrainingConfig(**{"n_epochs": n_epochs, "learning_rate": 3e-6,
                                    "weight_decay": 0.1, "batch_size": batch,
                                    "eval_every_epochs": 1, "log_file": "metrics.jsonl",
                                    "seed": 0, **training}),
                  ModelConfig(name="b16", dtype="bfloat16", trainable_last_k=1))


def snapshot(tensors):
    return [t.detach().clone() for t in tensors]


class StepRecorder:
    """Wraps trainer.train_step (grad_accum 2, the EMA on): per micro-step
    the launches and whether the batch filled pool rows; the trainable
    parameters bit-unchanged after an odd micro-step and every one moved
    after an even one; the EMA bit-equal to e * d + p * (1 - d) recomputed
    here from the parameters after each update. Keeps the first filled
    batch's rows and pixels, and a copy of the state and the EMA at each
    checkpoint (trainer.state)."""

    def __init__(self, trainer, ema):
        self.trainer, self.ema, self.d = trainer, snapshot(ema), trainer.cfg.training.ema_decay
        self.steps, self.first_fill, self.saved = [], None, {}
        self.params = snapshot(trainer.params)
        step, state = trainer.train_step, trainer.state

        def recorded_step(batch, mark=None, **kw):
            idxs = np.asarray(batch["indices"])
            fill = not trainer.filled[2 * idxs].all()
            if fill and self.first_fill is None:
                self.first_fill = (idxs.copy(), batch["image"].clone())
            before = read_counts()
            terms = step(batch, mark, **kw)
            torch.cuda.synchronize()
            launches = {k: v - before[k] for k, v in read_counts().items()}
            params = snapshot(trainer.params)
            moved = sum(not torch.equal(a, b) for a, b in zip(params, self.params))
            if trainer.step % 2 == 0:  # an update: the EMA follows
                with torch.no_grad():
                    for e, p in zip(self.ema, params):
                        e.mul_(self.d).add_(p.float() * (1.0 - self.d))
            self.params = params
            self.steps.append({"step": trainer.step, "fill": fill, "launches": launches,
                               "moved": moved, "terms": terms.tolist(),
                               "ema_equal": all(torch.equal(a, b)
                                                for a, b in zip(self.ema, trainer.ema))})
            return terms

        def recorded_state():
            out = state()
            self.saved[trainer.step] = {"state": copy.deepcopy(out),
                                        "ema": snapshot(trainer.ema)}
            return out

        trainer.train_step, trainer.state = recorded_step, recorded_state

    def check(self, what, n_params, L):
        for s in self.steps:
            want = {**dict.fromkeys(KERNELS, 0), "pk_fwd": 2 * (L - 1) + 1 if s["fill"] else 1,
                    **pair(1), **matched(1)}
            check(s["launches"] == want, f"{what} step {s['step']}: {s['launches']} launches, "
                  f"fill={s['fill']}")
            check(s["moved"] == (n_params if s["step"] % 2 == 0 else 0),
                  f"{what} step {s['step']}: {s['moved']} of {n_params} trainable "
                  "parameters moved")
            check(s["ema_equal"], f"{what} step {s['step']}: the EMA differs from its recursion")
            check(np.isfinite(s["terms"]).all(), f"{what} step {s['step']}: terms {s['terms']}")


def captured(build):
    """Run build() with its standard output captured, echo it, and return
    (result, text): the banner is checked."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = build()
    print(out.getvalue(), end="", flush=True)
    return result, out.getvalue()


def hflip_recipe_run(train_ds, test_ds, batch, max_gt, L):
    """(a): the recipe through Trainer.with_data with the cached two-row
    pool, grad_accum 2, the EMA on eval and keep_best; 2 epochs, then a run
    resumed from the epoch-1 checkpoint, in the middle of an accumulation."""
    n_classes = len(RUN_LABELMAP)
    steps = len(train_ds) // batch
    evals = -(-len(test_ds) // batch)
    opts = dict(cache_backbone=True, cache_backbone_store="auto", augment_hflip=True,
                grad_accum=2, ema_decay=0.999, ema_eval=True, keep_best=True)
    record = {}
    with tempfile.TemporaryDirectory() as workdir:
        run1 = os.path.join(workdir, "run1")
        cfg = options_config(2, batch, max_gt, checkpoint_dir=os.path.join(run1, "ckpt"),
                             **opts)
        torch.cuda.reset_peak_memory_stats()
        trainer, banner = captured(lambda: RecipePool.with_data(
            cfg, train_ds, test_ds, RUN_LABELMAP, run1, device="cuda"))
        pool_gb, budget_gb = trainer.pool_bytes / 1e9, trainer.pool_budget / 1e9
        check(trainer.act_store == "device" and trainer.pool_rows == 2 * N_IMAGES
              and "store=device" in banner and f"{budget_gb:.2f} GB auto budget" in banner,
              f"auto store for {N_IMAGES} x 2 B/16 rows ({pool_gb:.2f} GB, budget "
              f"{budget_gb:.2f} GB): {trainer.act_store}; banner {banner!r}")
        rec = StepRecorder(trainer, trainer.ema)
        evals_seen = {}
        timed_eval(trainer, evals_seen)
        metrics, launches, run1_s = drive_run(trainer)
        n_params = len(trainer.params)
        rec.check("recipe run 1", n_params, L)
        check([s["fill"] for s in rec.steps] == [True] * steps + [False] * steps,
              f"run 1 fills {[s['fill'] for s in rec.steps]}")
        check(launches == {**dict.fromkeys(KERNELS, 0),
                           "pk_fwd": (2 * (L - 1) + 1) * steps + steps + 2 * L * evals,
                           **pair(2 * steps), **matched(2 * steps)},
              f"recipe run 1: {launches} launches")
        # the stored rows of the first filled batch against a fresh prefix of
        # its pixels as they are (rows 2i) and mirrored (rows 2i + 1)
        idxs, image = rec.first_fill
        S = trainer.model_cfg.vision.image_size
        image = image.reshape(len(idxs), S, S, 3)
        with torch.no_grad():
            for flipped in (0, 1):
                px = normalize_image(image.flip(2) if flipped else image)
                fresh = owlvit.embed_prefix(trainer.model, trainer.model_cfg, px)
                stored = trainer.pool_gather(torch.from_numpy(2 * idxs + flipped).cuda())
                check(torch.equal(stored, fresh),
                      f"pool rows 2i+{flipped} differ from a fresh embed_prefix")
        # evaluate ran on the EMA and left the trained parameters as they were
        check(all(torch.equal(a, b) for a, b in zip(trainer.params, rec.params)),
              "evaluate changed the trained parameters")
        eval_image, packed = evals_seen["first_batch"]
        check(np.array_equal(eval_image.numpy().reshape(test_ds.images[:batch].shape),
                             test_ds.images[:batch]), "the eval batch's pixels")
        with torch.no_grad():
            for p, e in zip(trainer.params, trainer.ema):
                p.copy_(e)
            px = normalize_image(torch.from_numpy(test_ds.images[:batch]).cuda())
            boxes, sims = owlvit.forward_train(trainer.model, trainer.eval_cfg, px)
            t_cfg = trainer.cfg.training
            direct = nms_ops.pack_detections(nms_ops.postprocess(
                boxes, sims, confidence_threshold=t_cfg.confidence_threshold,
                iou_threshold=t_cfg.iou_threshold, top_k=t_cfg.top_k)).cpu().numpy()
            for p, v in zip(trainer.params, rec.params):
                p.copy_(v)
        check(np.array_equal(direct, packed),
              "evaluate's packed detections differ from a direct forward on the EMA")
        rows = jsonl_rows(run1)
        check_rows(rows, 2, n_classes)
        cut = rec.saved.get(steps)
        check(cut is not None and cut["state"]["mini_step"] == 1,
              f"the epoch-1 checkpoint (step {steps}) is not in the middle of an accumulation")
        record["run1"] = {
            "s": run1_s, "launches": launches, "steps": rec.steps, "val_map": metrics["map"],
            "epochs": [{k: r[k] for k in ("epoch", "step", "epoch_train_secs",
                                          "epoch_imgs_per_sec")} for r in rows],
            "eval_s": evals_seen["eval_s"], "checkpoints": sorted(rec.saved),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        del trainer, rec.trainer, boxes, sims, px, fresh, stored
        gc.collect()
        torch.cuda.empty_cache()

        # resume from the epoch-1 checkpoint alone: one more epoch
        run2 = os.path.join(workdir, "run2")
        os.makedirs(os.path.join(run2, "ckpt"))
        for d in (f"step_{steps:08d}", f"tree_{steps:08d}"):
            shutil.copytree(os.path.join(run1, "ckpt", d), os.path.join(run2, "ckpt", d))
        cfg2 = options_config(2, batch, max_gt, checkpoint_dir=os.path.join(run2, "ckpt"),
                              **opts)
        torch.cuda.reset_peak_memory_stats()
        trainer, _ = captured(lambda: RecipePool.with_data(
            cfg2, train_ds, test_ds, RUN_LABELMAP, run2, device="cuda"))
        saved = cut["state"]
        check((trainer.step, trainer.updates, trainer.mini_step)
              == (saved["step"], saved["updates"], saved["mini_step"]) == (steps, 1, 1),
              f"resumed at {(trainer.step, trainer.updates, trainer.mini_step)}")
        check(all(torch.equal(a, b) for a, b in zip(trainer.grad_acc, saved["grad_acc"]))
              and any(a.abs().max().item() > 0 for a in trainer.grad_acc),
              "the resumed accumulator differs from the saved one")
        check(all(torch.equal(a, b) for a, b in zip(trainer.ema, cut["ema"])),
              "the resumed EMA differs from the saved one")
        rec2 = StepRecorder(trainer, cut["ema"])
        _, launches2, run2_s = drive_run(trainer)
        rec2.check("recipe run 2", n_params, L)
        check(trainer.step == 2 * steps and [s["fill"] for s in rec2.steps] == [True] * steps,
              f"run 2 ended at step {trainer.step}, fills {[s['fill'] for s in rec2.steps]}")
        check(launches2 == {**dict.fromkeys(KERNELS, 0),
                            "pk_fwd": (2 * (L - 1) + 1) * steps + L * evals, **pair(steps),
                            **matched(steps)},
              f"recipe run 2: {launches2} launches")
        rows2 = jsonl_rows(run2)
        check_rows(rows2, 1, n_classes)
        record["run2"] = {
            "s": run2_s, "launches": launches2, "steps": rec2.steps,
            "epochs": [{k: r[k] for k in ("epoch", "step", "epoch_train_secs",
                                          "epoch_imgs_per_sec")} for r in rows2],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        del trainer, rec2.trainer
        gc.collect()
    torch.cuda.empty_cache()
    total = {k: launches[k] + launches2[k] for k in KERNELS}
    return record, {"pool_gb": pool_gb, "budget_gb": budget_gb,
                    "banner": banner.strip().splitlines()[-1]}, total


def b16_trainer(batch, max_gt, n_classes, *, model_kw=None, n_images=None, mesh=None,
                **training):
    """A B/16 bf16 Trainer from seed 0 with the recipe's optimizer (on
    `mesh`, whose shape the training overrides give)."""
    m = {"trainable_last_k": 1, "dtype": "bfloat16", **(model_kw or {})}
    config = Config(DataConfig(max_gt=max_gt),
                    TrainingConfig(**{"learning_rate": 3e-6, "weight_decay": 0.1,
                                      "batch_size": batch, "checkpoint_dir": None,
                                      "seed": 0, **training}),
                    ModelConfig(name="b16", **m))
    mcfg = get_config("b16")
    model = owlvit.init(mcfg, torch.Generator().manual_seed(0), num_queries=3 * n_classes,
                        device="cuda")
    return Trainer(config, model, n_classes, steps_per_epoch=2,
                   class_weights=np.linspace(0.5, 1.5, n_classes, dtype=np.float32),
                   device="cuda", n_images=n_images, mesh=mesh)


def counted_step(trainer, batch):
    """One train_step from launch counts 0 -> (terms, launches, wall ms,
    peak GB above the memory held before it)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    terms = trainer.train_step(dict(batch))
    torch.cuda.synchronize()
    return (terms, read_counts(), (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 1e9, (torch.cuda.max_memory_allocated() - held) / 1e9)


def hflip_cached_vs_uncached(batch, max_gt, n_classes, L, S):
    """(b): one cached and one uncached hflip step from the same state with
    the same Philox flips."""
    rng = np.random.default_rng(7)
    n_images = 2 * batch
    data = train_batch(rng, batch, max_gt, S, n_classes)
    data["indices"] = rng.choice(n_images, batch, replace=False)
    cached = b16_trainer(batch, max_gt, n_classes, cache_backbone=True, augment_hflip=True,
                         n_images=n_images)
    plain = b16_trainer(batch, max_gt, n_classes, augment_hflip=True)
    flips = plain._sample_flips(batch)
    check(np.array_equal(flips, cached._sample_flips(batch)) and flips.any() and not flips.all(),
          f"flips {flips.astype(int).tolist()}")
    prefix = {}
    hook = plain.model.vision.layers[L - 1].register_forward_pre_hook(
        lambda mod, args: prefix.setdefault("acts", args[0].detach().clone()))
    terms_u, launches_u, _, _, _ = counted_step(plain, data)
    hook.remove()
    terms_c, launches_c, _, _, _ = counted_step(cached, data)
    check(launches_u == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L, **pair(1), **matched(1)}
          and launches_c == {**dict.fromkeys(KERNELS, 0), "pk_fwd": 2 * (L - 1) + 1,
                             **pair(1), **matched(1)},
          f"hflip steps: uncached {launches_u}, cached {launches_c}")
    rows = torch.from_numpy(2 * data["indices"] + flips).cuda()
    with torch.no_grad():
        stored = cached.pool_gather(rows)
    check(torch.equal(stored, prefix["acts"]),
          "the stored rows of the flips differ from the uncached step's prefix")
    rel = np.abs(terms_c - terms_u) / np.abs(terms_u)
    check(np.isfinite(terms_c).all() and rel.max() <= TOL_HFLIP_TERMS,
          f"cached vs uncached hflip terms: {terms_c.tolist()} vs {terms_u.tolist()}")
    out = {"flips": int(flips.sum()), "terms_cached": terms_c.tolist(),
           "terms_uncached": terms_u.tolist(), "terms_max_rel": rel.max().item(),
           "terms_equal": bool(np.array_equal(terms_c, terms_u)), "rows_bit_equal": True,
           "launches_cached": launches_c, "launches_uncached": launches_u}
    total = {k: launches_u[k] + launches_c[k] for k in KERNELS}
    del cached, plain, stored, prefix
    gc.collect()
    torch.cuda.empty_cache()
    return out, total


def grads_of(trainer):
    return [p.grad.detach().clone() for p in trainer.params]


def remat_steps(batch, max_gt, n_classes, L, S):
    """(c): trainable_last_k 12, uncached: 2 steps with remat off and 2 on,
    each pair from the same state (the off trainer's), the off step repeated
    (bit-equal gradients: the split pair's dq); then one remat step under
    OWLVIT_FUSED_LN=1."""
    rng = np.random.default_rng(9)
    batches = [train_batch(rng, batch, max_gt, S, n_classes) for _ in range(2)]
    off = b16_trainer(batch, max_gt, n_classes, model_kw={"trainable_last_k": L})
    on = b16_trainer(batch, max_gt, n_classes, model_kw={"trainable_last_k": L, "remat": True})
    check(on.model_cfg.remat and not off.model_cfg.remat, "remat settings")
    steps, total = [], dict.fromkeys(KERNELS, 0)
    for b in batches:
        start = copy.deepcopy(off.state())
        t_off, l_off, w_off, peak_off, act_off = counted_step(off, b)
        g_off = grads_of(off)
        after = copy.deepcopy(off.state())
        off.load_state(copy.deepcopy(start))
        t_rep, l_rep, _, _, _ = counted_step(off, b)
        g_rep = grads_of(off)
        off.load_state(after)
        on.load_state(copy.deepcopy(start))
        t_on, l_on, w_on, peak_on, act_on = counted_step(on, b)
        g_on = grads_of(on)
        every = range(len(g_off))
        rec = {"terms_off": t_off.tolist(), "terms_on": t_on.tolist(),
               "terms_equal": bool(np.array_equal(t_on, t_off)),
               "repeat_terms_equal": bool(np.array_equal(t_rep, t_off)),
               "grad_l2_rel": l2_rel(g_on, g_off, every),
               "grad_bit_equal": all(torch.equal(a, b) for a, b in zip(g_on, g_off)),
               "repeat_grad_l2_rel": l2_rel(g_rep, g_off, every),
               "repeat_grad_bit_equal": all(torch.equal(a, b) for a, b in zip(g_rep, g_off)),
               "launches_off": l_off, "launches_on": l_on, "wall_ms_off": w_off,
               "wall_ms_on": w_on, "peak_gb_off": peak_off, "peak_gb_on": peak_on,
               "step_peak_gb_off": act_off, "step_peak_gb_on": act_on}
        check(l_off == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L, "pk_dq": L, "pk_dkv": L,
                        **matched(1)}
              and l_on == {**dict.fromkeys(KERNELS, 0), "pk_fwd": 2 * L, "pk_dq": L,
                           "pk_dkv": L, **matched(1)},
              f"remat launches: off {l_off}, on {l_on}")
        check(rec["terms_equal"] and rec["repeat_terms_equal"]
              and rec["repeat_grad_bit_equal"] and rec["grad_l2_rel"] <= TOL_REMAT
              and peak_on < peak_off, f"remat vs no remat: {rec}")
        steps.append(rec)
        total = {k: total[k] + l_off[k] + l_rep[k] + l_on[k] for k in KERNELS}
        del g_off, g_rep, g_on, start, after
    del off
    gc.collect()
    torch.cuda.empty_cache()
    with switches(OWLVIT_FUSED_LN="1"):
        t_f, l_f, w_f, peak_f, _ = counted_step(on, batches[0])
    check(np.isfinite(t_f).all()
          and l_f == {**dict.fromkeys(KERNELS, 0), "pk_fwd": 2 * L, "pk_dq": L, "pk_dkv": L,
                      "add_ln_fwd": 2 * 2 * L, "add_ln_bwd": 2 * L, **matched(1)},
          f"remat under OWLVIT_FUSED_LN=1: {l_f} launches, terms {t_f.tolist()}")
    fused = {"terms": t_f.tolist(), "launches": l_f, "wall_ms": w_f, "peak_gb": peak_f}
    total = {k: total[k] + l_f[k] for k in KERNELS}
    del on
    gc.collect()
    torch.cuda.empty_cache()
    return {"steps": steps, "fused_ln": fused}, total


def augment_steps(batch, max_gt, n_classes, L, S):
    """(d): 2 uncached steps with augment (colour 0.4, scale 0.7-1.3), then
    the same 2 again, each from the state its first run started from."""
    rng = np.random.default_rng(11)
    batches = [train_batch(rng, batch, max_gt, S, n_classes) for _ in range(2)]
    trainer = b16_trainer(batch, max_gt, n_classes, augment=True, aug_color=0.4,
                          aug_scale_min=0.7, aug_scale_max=1.3)
    states, first, total = [], [], dict.fromkeys(KERNELS, 0)
    for b in batches:
        states.append(copy.deepcopy(trainer.state()))
        terms, launches, wall, _, _ = counted_step(trainer, b)
        first.append((terms, wall))
        total = {k: total[k] + launches[k] for k in KERNELS}
        check(launches == {**dict.fromkeys(KERNELS, 0), "pk_fwd": L, **pair(1), **matched(1)},
              f"augment step: {launches} launches")
    again = []
    for state, b in zip(states, batches):
        trainer.load_state(state)
        terms, launches, _, _, _ = counted_step(trainer, b)
        again.append(terms)
        total = {k: total[k] + launches[k] for k in KERNELS}
    check(all(np.isfinite(t).all() and np.array_equal(t, a) for (t, _), a in zip(first, again)),
          f"augment replay: {[t.tolist() for t, _ in first]} vs {[a.tolist() for a in again]}")
    del trainer, states
    gc.collect()
    torch.cuda.empty_cache()
    return {"terms": [t.tolist() for t, _ in first], "wall_ms": [w for _, w in first],
            "replay_bit_equal": True}, total


def kernel_ms(kernels, top):
    """[(name, ms per step)] of the `top` longest kernels by name, summed
    over the trace's 2 steps, and their total."""
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3 / 2
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:120], ms] for n, ms in ranked], sum(by_name.values())


def profiled_run(train_ds, test_ds, batch, max_gt, top=12):
    """(e): a cached run with profile_dir (steps 1-2 of epoch 0, filled
    steps); the trace's device kernels summed by name per step, all and
    those of the backward: kernels whose launch (the runtime call with the
    same correlation id) came from the thread where autograd evaluated
    its functions (the engine's device thread)."""
    with tempfile.TemporaryDirectory() as workdir:
        cfg = options_config(1, batch, max_gt, cache_backbone=True,
                             cache_backbone_store="device", profile_dir="prof",
                             profile_steps=2, log_file=None)
        trainer = Trainer.with_data(cfg, train_ds, test_ds, RUN_LABELMAP, workdir, device="cuda")
        _, launches, run_s = drive_run(trainer)
        traces = sorted(os.listdir(os.path.join(workdir, "prof")))
        check(traces == ["steps_00000001-00000002.trace.json"], f"profile_dir holds {traces}")
        path = os.path.join(workdir, "prof", traces[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        size_mb = os.path.getsize(path) / 1e6
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    check(any("pk_fwd" in n for n in names) and any("pk_dq" in n for n in names)
          and any("pk_dkv" in n for n in names),
          f"the trace names no pk_fwd, pk_dq or pk_dkv kernel: {sorted(names)[:20]}")
    launcher = {e["args"]["correlation"]: e["tid"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    autograd = {e["tid"] for e in events if e.get("cat") == "cpu_op"
                and e["name"].startswith("autograd::engine::evaluate_function")}
    backward = [e for e in kernels if launcher.get(e["args"].get("correlation")) in autograd]
    ranked, busy = kernel_ms(kernels, top)
    ranked_bwd, busy_bwd = kernel_ms(backward, top)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"trace_mb": size_mb, "run_s": run_s, "kernels_per_step": len(kernels) / 2,
            "device_busy_ms_per_step": busy, "top_ms_per_step": ranked,
            "backward_kernels_per_step": len(backward) / 2,
            "backward_busy_ms_per_step": busy_bwd, "backward_top_ms_per_step": ranked_bwd,
            "unattributed_kernels": sum(e["args"].get("correlation") not in launcher
                                        for e in kernels),
            "launches": launches}, launches


def phase_train_options(n_train=96, n_test=32, batch=32, max_gt=16):
    """The training options at B/16 bf16, batch 32, random weights (seed 0):
    (a) the hflip recipe run, (b) cached against uncached hflip, (c) remat,
    (d) augment, (e) profile_dir. Returns the launches of every drive."""
    mcfg = get_config("b16")
    L, S = mcfg.vision.num_layers, mcfg.vision.image_size
    n_classes = len(RUN_LABELMAP)
    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' pools
    train_ds, test_ds = SmokeSet(n_train, S, max_gt, seed=0), SmokeSet(n_test, S, max_gt, seed=1)
    t0 = time.perf_counter()
    recipe, pool, total = hflip_recipe_run(train_ds, test_ds, batch, max_gt, L)
    emit("train_options", part="a_hflip_recipe", model="b16", dtype="bfloat16", batch=batch,
         images=[n_train, n_test], grad_accum=2, ema_decay=0.999, pool_rows=2 * N_IMAGES,
         **pool, **recipe, s=time.perf_counter() - t0)
    parts = (("b_hflip_cached_vs_uncached", hflip_cached_vs_uncached, (batch, 64, 80, L, S)),
             ("c_remat", remat_steps, (batch, 64, 80, L, S)),
             ("d_augment", augment_steps, (batch, 64, 80, L, S)),
             ("e_profile_dir", profiled_run, (train_ds, test_ds, batch, max_gt)))
    for name, fn, args in parts:
        t0 = time.perf_counter()
        out, launches = fn(*args)
        emit("train_options", part=name, **out, s=time.perf_counter() - t0)
        total = {k: total[k] + launches[k] for k in KERNELS}
    return total


# Phase 15, the mesh. Two ranks share the one card over gloo (NCCL refuses
# two ranks on a device; gloo copies CUDA tensors through the host), so no
# wall here says anything of scaling. Backward mode "both" (the split pair):
# the single-device run repeats bit-equal, so a difference is the mesh's.
MESH_BATCH, MESH_STEPS, MESH_IMAGES, MESH_MAX_GT, MESH_CLASSES = 32, 3, 64, 64, 80
# Each mesh run is held against the single-device run of the same global
# batches in this call by (1) the per-step loss terms, max rel, (2) the
# averaged gradient of step 1 (from the same parameters): L2 of the
# difference over L2 of the single-device gradient, and (3) the trainable
# parameters after 3 steps: L2 of the difference over L2 of the
# single-device update; (2) and (3) over every trainable tensor but the
# attention's key bias (its gradient is 0 in exact arithmetic).
# At random weights the predicted boxes of neighbouring patches overlap
# near the propagation's IoU 0.85, so a perturbation of the forward in its
# last bits flips foreground patches: the terms move little, the gradient
# of the heads and the queries a lot, and AdamW's first steps (nearly
# sign(gradient) x lr) move every near-zero element either way. (3)'s
# yardstick, measured in this call: how far the single-device bf16 run lies
# from the same run in fp32 (the floor).
# - dp=2, bf16: a rank's rows give the same forward bits as one device's
#   batch (the matching does not move); each rank's weight gradients are
#   rounded to bf16 before the two ranks' sum: (1) 2e-2 (the later steps'
#   matching, as TOL_FUSED_TERMS), (2) 1e-2 (5x bf16's 2^-9), (3) the floor.
# - tp=2, bf16: every row-parallel output (out, fc2) is two bf16 partial
#   products summed in bf16, one rounding more than one device's product
#   (Megatron and the JAX package's GSPMD reduce in the activation dtype):
#   the forward's last bits move, so (1) 5e-2 and (3) 1.5 floors; (2) is
#   printed, not held (the matching above).
# - tp=2, fp32, step 1: nothing rounds to bf16, so the arithmetic of the
#   split is held: (1) and (2) 1e-4 (two partial products and the reduce
#   summed in another order).
TOL_MESH = {"dp": {"terms": 2e-2, "grad": 1e-2, "floors": 1.0},
            "tp": {"terms": 5e-2, "grad": None, "floors": 1.5},
            "f32": {"terms": 1e-4, "grad": 1e-4, "floors": None}}
# (name, mesh, the batches, dtype, steps)
MESH_RUNS = (("dp2", (2, 1), "uncached", "bfloat16", MESH_STEPS),
             ("dp2_cached", (2, 1), "cached", "bfloat16", MESH_STEPS),
             ("tp2", (1, 2), "uncached", "bfloat16", MESH_STEPS),
             ("tp2_f32", (1, 2), "uncached", "float32", 1))


def mesh_data(rng):
    """MESH_IMAGES images (flat uint8) with ~7 boxes each, their rows the
    train set's 0..63, and the global batches of each run: uncached, 3
    random batches of 32; cached,
    the shard-aligned batches of 64 rows (rank r's 16 rows within its 32)
    as fill, fill, gather."""
    S = get_config("b16").vision.image_size
    data = train_batch(rng, MESH_IMAGES, MESH_MAX_GT, S, MESH_CLASSES)
    data["indices"] = np.arange(MESH_IMAGES)
    aligned = list(shard_aligned_batches(MESH_IMAGES, MESH_BATCH, 2, seed=0))
    uncached = [rng.choice(MESH_IMAGES, MESH_BATCH, replace=False) for _ in range(MESH_STEPS)]
    return data, {"cached": [aligned[0], aligned[1], aligned[0]], "uncached": uncached}


def mesh_run(data, orders, order, mesh=None, shape=(1, 1), dtype="bfloat16"):
    """MESH_STEPS steps of a B/16 trainer (seed 0) in dtype, each train_step
    given the global batch of orders[order] -> terms, full trainable
    tensors on the host (at the start, after step 1's gradients, at the
    end) and their names, launches, step walls in ms."""
    cached = order == "cached"
    training = {"mesh_data": shape[0], "mesh_model": shape[1]}
    if cached:
        training.update(cache_backbone=True, cache_backbone_store="device")
    trainer = b16_trainer(MESH_BATCH, MESH_MAX_GT, MESH_CLASSES, mesh=mesh,
                          n_images=MESH_IMAGES if cached else None,
                          model_kw={"dtype": dtype}, **training)
    names = {id(p): n for n, p in trainer.model.named_parameters()}

    def host(tensors):
        return [t.cpu().clone() for t in trainer._full([t.detach() for t in tensors])]

    start = host(trainer.params)
    torch.cuda.synchronize()
    reset_counts()
    terms, walls, grads = [], [], None
    for i, sel in enumerate(orders[order]):
        b = {k: data[k][sel] for k in ("labels", "boxes", "gt_mask", "indices")}
        if not cached or i < 2:  # the gathered step reads no pixels
            b["image"] = data["image"][sel]
        t0 = time.perf_counter()
        terms.append(trainer.train_step(b).tolist())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:  # the averaged gradient of step 1, from the same parameters
            grads = host([p.grad for p in trainer.params])
    launches = read_counts()
    out = {"terms": terms, "params": host(trainer.params), "start": start, "grads": grads,
           "launches": launches, "names": [names[id(p)] for p in trainer.params],
           "step_wall_ms": walls,
           "pool_rows": None if trainer.pool is None else trainer.pool.shape[0]}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank, world, rdzv, out_dir):
    """One of the two ranks of phase 15 (spawned): every MESH_RUNS run on
    its mesh over a gloo group on cuda:0; its results to out_dir."""
    os.environ["OWLVIT_PACKED_BWD"] = "both"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    try:
        data, orders = mesh_data(np.random.default_rng(15))
        out = {}
        for name, shape, order, dtype, steps in MESH_RUNS:
            mesh = create_mesh(*shape, device_type="cuda", backend="gloo",
                               device=torch.device("cuda", 0))
            out[name] = mesh_run(data, {order: orders[order][:steps]}, order, mesh, shape,
                                 dtype=dtype)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_diff(got, want, key_bias=".attn.k.bias"):
    """got against want (over got's steps): the per-step terms' largest
    relative difference, the step-1 gradients' and the end parameters' L2
    difference (the latter over want's update), all trainable tensors but
    the key bias; and the 4 tensors whose step-1 gradient differs most,
    relative to each one's own L2."""
    keep = [i for i, n in enumerate(want["names"]) if not n.endswith(key_bias)]

    def l2(tensors):
        return sum(float(t.double().square().sum()) for t in tensors) ** 0.5

    steps = len(got["terms"])
    t_got, t_want = np.asarray(got["terms"]), np.asarray(want["terms"][:steps])
    worst = max(keep, key=lambda i: (got["params"][i] - want["params"][i]).abs().max().item())
    per_tensor = sorted(((l2([got["grads"][i] - want["grads"][i]]) / max(l2([want["grads"][i]]),
                                                                          1e-30),
                          want["names"][i], l2([want["grads"][i]])) for i in keep), reverse=True)
    return {
        "grad_step1_worst_tensors": [{"name": n, "l2_rel": r, "grad_l2": g}
                                     for r, n, g in per_tensor[:4]],
        "terms_max_rel": float(np.max(np.abs(t_got - t_want) / np.maximum(np.abs(t_want), 1e-12))),
        "grad_step1_l2_rel": l2([got["grads"][i] - want["grads"][i] for i in keep])
        / l2([want["grads"][i] for i in keep]),
        "update_l2_rel": l2([got["params"][i] - want["params"][i] for i in keep])
        / l2([want["params"][i] - want["start"][i] for i in keep]),
        "param_max_abs": (got["params"][worst] - want["params"][worst]).abs().max().item(),
        "param_max_abs_name": want["names"][worst]}


def phase_mesh():
    """Phase 15: (a) a mesh of one rank on NCCL, one step bit-equal to the
    plain single-device step; (b) two ranks on cuda:0 over gloo, dp=2
    uncached and cached and dp=1 x tp=2, each held against the
    single-device run of the same global batches (TOL_MESH)."""
    data, orders = mesh_data(np.random.default_rng(15))
    launches = dict.fromkeys(KERNELS, 0)
    with switches(OWLVIT_PACKED_BWD="both"):
        ref = {o: mesh_run(data, orders, o) for o in ("uncached", "cached")}
        ref["f32"] = mesh_run(data, orders, "uncached", dtype="float32")
        for r in ref.values():
            check(np.isfinite(r["terms"]).all(), f"single-device mesh reference {r['terms']}")
            launches = {k: launches[k] + r["launches"][k] for k in KERNELS}
        floor = mesh_diff(ref["uncached"], ref["f32"])
        emit("mesh", part="floor", what="one device, bf16 against fp32", **floor)
        # (a): the step through the data all_reduce, the loss's count
        # all_reduce and the TP Functions on groups of one, on NCCL
        mesh = create_mesh(1, 1, device_type="cuda", backend="nccl")
        try:
            check(dist.get_backend() == "nccl", dist.get_backend())
            one = mesh_run(data, {"one": orders["uncached"][:1]}, "one", mesh)
        finally:
            dist.destroy_process_group()
        plain = mesh_run(data, {"one": orders["uncached"][:1]}, "one")
        bit_equal = (one["terms"] == plain["terms"] and all(
            torch.equal(a, b) for a, b in zip(one["params"] + one["grads"],
                                              plain["params"] + plain["grads"])))
        emit("mesh", part="nccl_world_of_one", bit_equal=bit_equal, terms=one["terms"],
             launches=one["launches"], step_wall_ms=one["step_wall_ms"])
        check(bit_equal, f"the NCCL mesh of one rank differs from one device: "
                         f"{one['terms']} {plain['terms']}")
        check(one["launches"] == plain["launches"], f"{one['launches']} {plain['launches']}")
        launches = {k: launches[k] + one["launches"][k] + plain["launches"][k] for k in KERNELS}
        del one, plain
        torch.cuda.empty_cache()
    # (b): the two ranks, spawned; a rank that raises fails the spawn
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.multiprocessing.start_processes(
            mesh_rank, args=(2, os.path.join(tmp, "rdzv"), tmp), nprocs=2,
            start_method="spawn", join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    emit("mesh", part="spawn", seconds=spawn_s, backend="gloo, two ranks on cuda:0")
    L = get_config("b16").vision.num_layers
    failed = []
    for name, shape, order, dtype, steps in MESH_RUNS:
        cached = order == "cached"
        want = ref["f32" if dtype == "float32" else order]
        tol = TOL_MESH["f32" if dtype == "float32" else "tp" if shape[1] > 1 else "dp"]
        tol_terms, tol_grad = tol["terms"], tol["grad"]
        tol_update = tol["floors"] and tol["floors"] * floor["update_l2_rel"]
        per_rank = []
        for rank, res in enumerate(ranks):
            got = res[name]
            diff = mesh_diff(got, want)
            # each rank launches the layers it runs: its rows, or its heads
            fills = 2 if cached else steps
            ok = (np.isfinite(got["terms"]).all() and diff["terms_max_rel"] <= tol_terms
                  and (tol_grad is None or diff["grad_step1_l2_rel"] <= tol_grad)
                  and (tol_update is None or diff["update_l2_rel"] <= tol_update)
                  and got["launches"]["pk_fwd"] == fills * L + (steps - fills)
                  and got["launches"]["pk_dq"] == got["launches"]["pk_dkv"] == steps
                  and all(got["launches"][k] == n for k, n in matched(steps).items()))
            if not ok:
                failed.append(f"{name} rank {rank}")
            launches = {k: launches[k] + got["launches"][k] for k in KERNELS}
            if dtype == "bfloat16" and not cached:  # the distance to exact
                diff["vs_f32"] = {k: v for k, v in mesh_diff(got, ref["f32"]).items()
                                  if k in ("grad_step1_l2_rel", "update_l2_rel",
                                           "grad_step1_worst_tensors")}
            per_rank.append({"rank": rank, **diff, "terms": got["terms"],
                             "launches": {k: got["launches"][k]
                                          for k in ("pk_fwd", "pk_bwd", "pk_dq", "pk_dkv",
                                                    *matched(0))},
                             "step_wall_ms_two_ranks_share_one_card": got["step_wall_ms"],
                             "pool_rows": got["pool_rows"]})
        if not all(torch.equal(a, b) for a, b in zip(ranks[0][name]["params"],
                                                     ranks[1][name]["params"])):
            failed.append(f"{name}: the ranks' parameters differ")
        emit("mesh", part=name, mesh=list(shape), global_batch=MESH_BATCH, dtype=dtype,
             cached=cached, tol_terms_rel=tol_terms, tol_grad_step1_l2_rel=tol_grad,
             tol_update_l2_rel=tol_update,
             single_device_terms=want["terms"],
             single_device_step_wall_ms=want["step_wall_ms"], ranks=per_rank)
    check(not failed, f"mesh runs outside their tolerance: {failed}")
    return launches


def main():
    for name in SWITCHES:  # the default paths run with the switches off
        os.environ.pop(name, None)
    phase_device()
    phase_build()
    phase_kernel()
    phase_kernel_bwd()
    ln = phase_kernel_ln()
    transposed, transposed_launches = phase_kernel_transposed()
    cfg, serve_launches = phase_slice()
    open_vocab_launches = phase_open_vocab()
    mesh_serve_launches = phase_mesh_serve()
    b16 = cfg.vision
    served = [fwd_row(b16, bucket, C) for bucket in (8, 1)]
    served.append(fwd_row(b16, 32, None))  # the train step's shape and softmax
    for row in served:
        emit("main_path_kernel", **row)
    bwd = trained_shape_bwd(cfg)
    # the two attention kernels' times side by side, the shared header's
    # effect on the backward included
    emit("attention_times", pk_fwd_ms={f"[{r['shape'][0]}, {r['shape'][1]}, {r['shape'][2]}] "
                                       f"{r['softmax']}": r["ms"] for r in served},
         pk_fwd_transposed_ms=transposed["fwd"]["ms"], pk_bwd_ms=bwd["ms"],
         pk_bwd_pair_ms=bwd["pair"]["ms"], pk_dq_ms=bwd["dq"]["ms"],
         pk_dkv_ms=bwd["dkv"]["ms"], pk_bwd_transposed_ms=transposed["bwd"]["fused_ms"],
         pk_bwd_pair_transposed_ms=transposed["bwd"]["pair_ms"],
         sdpa_fwd_ms={str(r["shape"][0]): r["library_ms"] for r in served},
         library_bwd_ms=bwd["library_ms"], library_bwd_op=bwd["library_op"],
         library_bwd_transposed_ms=transposed["bwd"]["library_ms"],
         sdpa_fwd_bwd_ms=bwd["library_fwd_bwd_ms"],
         sdpa_fwd_bwd_transposed_ms=transposed["bwd"]["library_fwd_bwd_ms"])
    train_launches, matching = phase_train()
    match_rows = phase_kernel_matcher(matching)
    del matching
    cached_launches = phase_train_cached()
    bench_launches = phase_bench_cached()
    with tempfile.TemporaryDirectory() as run_dir:
        run_launches = phase_run(run_dir)
        export_launches = phase_export(run_dir)
    stage_launches = phase_stage()
    options_launches = phase_train_options()
    mesh_launches = phase_mesh()
    launches = {k: sum(run[k] for run in (serve_launches, open_vocab_launches,
                                          mesh_serve_launches, train_launches, cached_launches,
                                          bench_launches, run_launches, export_launches,
                                          stage_launches, options_launches, mesh_launches))
                for k in KERNELS}
    # the drives of the transposed Function
    for k in ("transposed_fwd", "transposed_dq", "transposed_dkv"):
        launches[k] += transposed_launches[k]
    check(all(launches[k] > 0 for k in KERNELS), f"a kernel was never launched: {launches}")
    fwd = served[0]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = {
        "pk_fwd": {"max_abs_err": max(r["o_max_abs"] for r in served), **{
            k: fwd[k] for k in keys}},
        "pk_bwd": {"max_abs_err": max(bwd[f"{n}_max_abs"] for n in ("dq", "dk", "dv")), **{
            k: bwd[k] for k in keys}},
        "pk_dq": {k: bwd["dq"][k] for k in ("max_abs_err", *keys)},
        "pk_dkv": {k: bwd["dkv"][k] for k in ("max_abs_err", *keys)},
        "add_ln_fwd": {k: ln["fwd"][k] for k in ("max_abs_err", *keys)},
        "add_ln_bwd": {k: ln["bwd"][k] for k in ("max_abs_err", *keys)},
        "transposed_fwd": {k: transposed["fwd"][k] for k in ("max_abs_err", *keys)},
        "transposed_dq": {k: transposed["dq"][k] for k in ("max_abs_err", *keys)},
        "transposed_dkv": {k: transposed["dkv"][k] for k in ("max_abs_err", *keys)},
        **{name: {k: match_rows[name][k] for k in ("max_abs_err", *keys)}
           for name in ("jv_assign", "propagate_labels")},
    }
    # the backward rows' library call by name
    for name, src in (("pk_bwd", bwd), ("pk_dq", bwd["dq"]), ("pk_dkv", bwd["dkv"]),
                      ("transposed_dq", transposed["dq"]), ("transposed_dkv", transposed["dkv"])):
        rows[name]["library_op"] = src["library_op"]
    print(nvidia_smi(), flush=True)  # again beside the results, after the long phases
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **rows[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
