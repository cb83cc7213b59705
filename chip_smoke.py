#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (the U-Net's and the
ViT-U-Net's) once on one NVIDIA GPU.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases (one line each; any failure raises, so the exit code is not 0):
  0. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the kernels built from ops/csrc/ (build seconds);
  1. the InstanceNorm + LeakyReLU kernel against its plain version at the
     post-stride shapes of the planned U-Net, at the serving path's largest
     batch, f32 and bf16, each launch in the form its launch plan gives
     and a second run equal bit for bit; per forward at that batch (64)
     and at the train batch (2), the bf16 kernel's device time
     (torch.profiler, lifelong_nnunet_tpu_torch/tools/in_probe.py in a
     process of its own) beside its bytes bound, the plain version's and
     F.instance_norm's (a yardstick, not the same function) device time;
  2. the fused conv + InstanceNorm + LeakyReLU against its plain version at
     every stride-1 (Cin, Cout, spatial) of the planned U-Net: bf16 input on
     the tensor-core kernel (per shape its time, TFLOP/s, share of its
     bound and cuDNN's F.conv3d beside it, at each batch as phase 1), f32
     input on the FMA kernel (timed at the largest batch, cuDNN in f32
     beside it), each launch counted on the kernel its dtype selects;
  3. the full-width U-Net, kernel route against plain route, same weights,
     one window batch (f32 and bf16);
  4. the serving path: a hippocampus-scale synthetic task is planned and
     preprocessed, a seeded full-width model is saved as a port checkpoint,
     and ``nnUNet_torch_inference --device cuda`` segments its 4 cases (one
     window each) and one larger case (8 windows, overlap-added); the launch
     counters must equal what the route predicts, the larger case's f32
     probabilities must agree with the plain route's, and the plain route
     is timed beside the kernel route;
  5. the backward kernels (InstanceNorm + LeakyReLU backward, the fused
     conv's data gradient) against their plain versions at every stride-1
     and post-stride shape of the train step, at the train batch (2), in
     f32 (the data gradient on the FMA kernel) and bf16 (on the
     tensor-core kernel, per shape its TFLOP/s and share of its bound);
     the InstanceNorm backward in every (x, dx) dtype pair, in the forms
     and with the second runs of phase 1, its device time per train step
     as phase 1's; the data gradient's medians per train step (kernel,
     plain, and cuDNN's data gradient as the library time);
  6. the training path: ``nnUNet_torch_train_base_v2 --device cuda`` trains
     the full-width U-Net for 2 epochs of 60 steps with augmentation; the
     launch counters of all four kernels must equal what the route predicts
     per step, the loss must be finite and fall, and
     ``nnUNet_torch_inference --device cuda`` serves the checkpoint it wrote
     (Dice recorded); one train step from the same weights and batch, the
     kernel and plain routes in f32 held to the plain route in f64 (loss
     and every gradient) within a limit that a bf16 control must exceed;
     warm seconds per train step, the routes in turns, peak device memory,
     and the kernel route's device time by kernel (torch.profiler);
  7. the flash-attention kernels (forward, and the backward's three
     kernels) against their plain versions at the ViT train step's
     (1, 12, 490, 64), serving's (8, 12, 490, 64), CT scale's
     (1, 12, 512, 64) and hd 80's (1, 16, 512, 80), f32 (on the FMA
     kernels) and bf16 (on the tensor-core kernels), a second run equal
     bit for bit; per shape in bf16, and at the train shape in f32, the
     device time of one launch (torch.profiler), its TFLOP/s and share of
     its bound, the kernel and SDPA (the library time, never used by the
     port) timed in turns (kernel, SDPA, SDPA, kernel), the plain version
     beside them;
  8. the ViT-U-Net path: ``nnUNet_torch_train_vit 3d_fullres <task> 0
     --device cuda`` trains V1 with ViT-base at full width (batch 1, the
     plan's halved) as phase 6 trains the U-Net; the launch counters of all
     six kernels as the route predicts (no bottleneck stage, 12 flash
     forwards and backwards per step), a finite loss, ``nnUNet_torch_inference
     nnViTUNetTrainer --use_vit --device cuda`` serving the checkpoint (12
     flash launches per forward, Dice recorded), the f32 step check of
     phase 6 on the ViT-U-Net (its 12 flash forwards and backwards on the
     FMA kernels, the bf16 control's on the tensor-core kernels), warm
     s/step of both routes in turns, peak memory and the kernel route's
     device time by kernel;
  9. the CT-scale route's copy kernels (block pack and unpack, the 2x
     interleave and de-interleave) against their plain versions, bit for
     bit, at every shape the CT train step (batch 2) and CT serving (window
     batch 8: a batch of 64) give them, bf16 and f32, every pack launch in
     the tma form (TMA box copies), with the kernel, plain and library
     CUDA-event medians per train step (the library: the F.pad +
     Tensor.unfold chain, its inverse permute, and F.conv_transpose3d
     forward and backward beside the octant route); the pack's device time
     per CT train step and per CT serving forward (torch.profiler, calls of
     1 ms or more by CUDA events; lifelong_nnunet_tpu_torch/tools/
     pack_probe.py in a process of its own, its shapes held to the routes')
     beside its bytes bound, the library chain, the plain version and
     PyTorch's elementwise kernel on x (x * 1) as the card's streaming
     ceiling; then the fused conv's tensor-core kernel against its plain
     version at every stride-1 shape
     of the CT U-Net (B=2 and B=64) and its data gradient (B=2), bf16, with
     phases 2 and 5's limits, per shape at B=64 its time, cuDNN's F.conv3d
     beside it and its device time by kernel (the conv, the split-K reduce,
     the finish); then the InstanceNorm kernels at every CT shape they run
     at (forward at B=2 and B=64, backward at B=2; f32 and bf16) as phase 1
     holds them, and their device time per forward or step as phase 1
     gives it;
  10. the CT path: a 160^3 synthetic task planned to nnU-Net's CT
     configuration (patch 128^3, batch 2, five pools, 32 -> 320 features) is
     trained by ``nnUNet_torch_train_base_v2 --device cuda`` with
     LNN_BLOCKED_CONV=1 and LNN_UPT_MODE=pallas (1 epoch of 20 steps and 2
     validation batches), the launch counters of all ten kernels as the
     routes predict per step and validation batch, a finite loss;
     ``nnUNet_torch_inference --device cuda`` serves one 156^3 case (8
     windows, one batch of 64) with launches as predicted, its f32
     probabilities against the ordinary kernel route's and its
     segmentation against the plain route's; the f32 step check of phase 6
     on the CT routes; warm s/step in turns (plain, kernel, CT routes and
     back), s/volume of both kernel routes, peak memory and the CT route's
     device time by kernel;
  11. a task sequence: phase 4's task A and a task B of the same shape
     (``Task098_SynthB``, seed 7, intensity shift 0.8), planned and
     preprocessed the same way, trained at full width by
     ``nnUNet_torch_train_sequential 3d_fullres -t A B`` and then
     ``nnUNet_torch_train_rehearsal`` (1 epoch of 30 steps and 2 validation
     batches per task, ``-save_interval 1 --use_progress_val --device
     cuda``): each task's loss finite, the launch counters of the four
     kernels as the route predicts per train step, per validation batch
     and per progress-validation forward (each val case's windows from
     ``window_grid`` in batches of 4; after A on A, after B on A and B),
     ``val_metrics.json`` after B holding both tasks with their own
     heads, the rehearsal pool of B holding B's train cases and
     max(1, round(0.25 n_A)) of A's; a second ``-c`` run of the
     sequential command trains nothing (every counter 0);
     ``nnUNet_torch_inference sequential -trained_on A B -use_head X``
     serves each head on each task's images (launches as predicted, the
     Dice of each head on each task recorded), one case's segmentation
     agreeing with the plain route's on >= 99% of voxels; seconds per
     task, warm s/step (synchronized per step), the progress validation's
     seconds and peak memory;
  12. the regularizing and freezing trainers: phase 11's tasks A and B and
     a third, ``Task099_SynthC`` (made like B: seed 11, intensity shift
     -0.6), planned and preprocessed the same way, each trained 1 epoch of
     30 steps and 2 validation batches per task (``-save_interval 1
     --use_progress_val --device cuda``) at full width by
     ``nnUNet_torch_train_ewc 3d_fullres -t A B C`` (the main path),
     ``_rw -t A B``, ``_frozen_body_seq -t A B``, and with ``--use_vit``
     (V1, ViT-base) ``_ewc_ln -t A B`` and ``_frozen_vit -t A B``: the
     launch counters of every run as the route predicts per train step,
     per fisher batch (a forward and a backward), per validation batch and
     per progress-validation forward; EWC's penalty 0 on A and finite and
     > 0 on every step of B and C, its bf16 anchors of A and B after B and
     of A, B and C after C in the checkpoints, the penalty and its
     gradient from B's final checkpoint on the card and on the CPU within
     1e-5 relative, a ``-c`` run after C training nothing, and a ``-c`` run
     after a kill between C's ``model_latest`` and its fisher pass
     restoring A's and B's anchors bit for bit and running that pass
     alone; each of EWC's three heads served on each task's images
     (launches as predicted, the 3 x 3 Dice matrix recorded); RW's running
     state updated on iterations 0, 10, 20, ... only, finite, its anchor
     f32 and its score sets bf16, its penalty > 0 on B;
     ``frozen_body_seq``'s body after B equal to A's bit for bit and its
     head moved; ``ewc_ln``'s anchors on the ViT's LayerNorms only;
     ``frozen_vit``'s ViT unchanged bit for bit through B while the U-Net
     moved.  Recorded: seconds per task, warm s/step per task (as phase
     11, beside phase 11's Sequential), fisher-pass seconds per task,
     ``model_final_checkpoint`` bytes per task, peak memory, and the
     kernel launch calls of an EWC step with two anchors beside the same
     step without the penalty (torch.profiler), both steps' CUDA-event
     medians in turns, and the penalty's time.
Phases 4, 6, 8, 11 and 12 run with both switches set: at hippocampus scale the
gates admit nothing, so their launch counts are those of the ordinary
routes.  The fused conv, its data gradient and flash attention (forward
and backward) count every launch and, apart, those on the tensor-core
kernels: on the ten main paths (bf16) every one must take them, in the f32
checks of phases 4, 6, 8 and 10 none.  The line
before the last is the kernels' JSON record (the U-Net's forward kernels
per forward at the serving path's largest batch, its backward kernels per
train step, the flash kernels per ViT-U-Net train step, the copy kernels
per CT train step, the pack by device time with its CUDA-event median as
``event_ms`` and its time per CT serving forward as ``serve_ms`` beside
``serve_bound_ms``; ``launches`` summed over the ten paths' runs, and per
path under ``launches_by_path``: ``serve``, ``train``, ``vit_train``,
``vit_serve``, ``ct_train``, ``ct_serve``, ``cl_train`` (both sequence
trainings), ``cl_serve`` (the four servings of phase 11), ``cl_reg_train``
(phase 12's five trainings and its resumed fisher pass) and
``cl_reg_serve`` (the nine servings of EWC's heads); the two kernels of the fused
conv, its data gradient and flash attention as ``conv3d_in_lrelu_tc`` /
``conv3d_dx_tc`` / ``flash_attention_tc`` / ``flash_attention_bwd_tc``
(the tensor-core kernels) and ``conv3d_in_lrelu_f32`` / ``conv3d_dx_f32``
/ ``flash_attention_f32`` / ``flash_attention_bwd_f32`` (the f32 FMA
kernels, which no bf16 path runs: 0 launches on the paths, the f32 checks'
launches under ``check_launches``); the InstanceNorm rows also by the form
of their launch plan (``launches_by_form``: warp, cluster, stream; on every
path each form's count must equal what the plan predicts for the path's
shapes) and with ``yardstick_ms``, F.instance_norm's time, which is not the
same function); the pack's row by form too (``launches_by_form``: tma,
scalar; on the CT paths every launch in the tma form, as its plan
predicts); the last line is ``{"ok": true,
"device": {...}}``.  Work files go to build/chip_smoke/ and are removed at the end.
The script imports only the port, never the JAX package, and fails if any
of lifelong_nnunet_tpu, jax, flax, optax, msgpack or sklearn was imported
by the end of the run.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(ROOT, "lifelong_nnunet_tpu_torch")):
    raise SystemExit("chip_smoke.py runs from the repository root: the package "
                     "lifelong_nnunet_tpu_torch is not beside it")
sys.path.insert(0, ROOT)
# the CT phases allocate and free tens of GB at a time
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from lifelong_nnunet_tpu_torch.data.augment import AugmentConfig  # noqa: E402
from lifelong_nnunet_tpu_torch.data.dataset import (  # noqa: E402
    PreprocessedDataset, final_splits)
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler  # noqa: E402
from lifelong_nnunet_tpu_torch.device import resolve_device  # noqa: E402
from lifelong_nnunet_tpu_torch.evaluation.metrics import subject_metrics  # noqa: E402
from lifelong_nnunet_tpu_torch.inference.predict import (  # noqa: E402
    case_files, predict_case, predict_from_folder, preprocess_for_inference)
from lifelong_nnunet_tpu_torch.inference.sliding_window import (  # noqa: E402
    predict_sliding_window, window_grid)
from lifelong_nnunet_tpu_torch.models.unet import (  # noqa: E402
    ConvNormAct, ds_scale_factors, unet_from_plans)
from lifelong_nnunet_tpu_torch.models.vit_unet import vit_unet_from_plans  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels import build  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels import block_pack  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels import interleave  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels.attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_fwd, plain_attention_bwd,
    plain_attention_fwd)
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import (  # noqa: E402
    conv3d_dx_cf, conv3d_in_lrelu_cf, plain_conv3d_dx, plain_conv3d_in_lrelu)
from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (  # noqa: E402
    FORMS, card_limits, instance_norm_leaky_bwd_cf, instance_norm_leaky_cf, launch_plan,
    plain_instance_norm_leaky, plain_instance_norm_leaky_bwd)
from lifelong_nnunet_tpu_torch.models.multihead import name_filter_mask  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.cl_losses import QuadraticPenalty  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss  # noqa: E402
from lifelong_nnunet_tpu_torch.planning.plans import Plans, plans_path  # noqa: E402
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess  # noqa: E402
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference  # noqa: E402
from lifelong_nnunet_tpu_torch.run.run_training import (  # noqa: E402
    METHOD_ARGS, output_folder, run_training, trainer_name)
from lifelong_nnunet_tpu_torch.run.run_training_vit import run_training_vit  # noqa: E402
from lifelong_nnunet_tpu_torch.tools import in_probe  # noqa: E402
from lifelong_nnunet_tpu_torch.tools import pack_probe  # noqa: E402
from lifelong_nnunet_tpu_torch.tools.flash_probe import device_ms  # noqa: E402
from lifelong_nnunet_tpu_torch.training.checkpoints import (  # noqa: E402
    base_manifest, load_registry, save_checkpoint)
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD  # noqa: E402
from lifelong_nnunet_tpu_torch.training.output_paths import (  # noqa: E402
    arch_dir, build_output_folder, metadata_folder)
from lifelong_nnunet_tpu_torch.training.restore import (  # noqa: E402
    restore_model, restore_trainer)
from lifelong_nnunet_tpu_torch.training.train_step import (  # noqa: E402
    StepConfig, make_train_step)
from lifelong_nnunet_tpu_torch.training.trainer import (  # noqa: E402
    MultiHeadTrainer, TrainerOptions)
from lifelong_nnunet_tpu_torch.training.trainers import get_trainer  # noqa: E402
from lifelong_nnunet_tpu_torch.training.trainers.ewc import EWCTrainer  # noqa: E402
from lifelong_nnunet_tpu_torch.training.trainers.rehearsal import RehearsalTrainer  # noqa: E402
from lifelong_nnunet_tpu_torch.training.trainers.rw import RWTrainer  # noqa: E402
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image  # noqa: E402
from lifelong_nnunet_tpu_torch.utilities.synthetic import make_synthetic_task  # noqa: E402

WINDOW_BATCH = 8                 # the CLI's default
STEP_REPS = 10                   # timed train steps per route and turn
PROFILE_STEPS = 5                # profiled kernel-route train steps
TTA = 8                          # mirror combos over 3 axes
SEED = 0
SMALL_SHAPE = (60, 84, 60)       # hippocampus scale: crops to one patch
LARGE_SHAPE = (84, 120, 84)      # crops to 80x116x80: a 2x2x2 window grid
TRAIN_BATCH = 2                  # the plan's batch
TRAIN_EPOCHS, TRAIN_ITERS, VAL_ITERS = 2, 60, 4
# one f32 train step's worst gradient |diff| from the f64 plain route, in
# units of 1e-5 + 1e-3 of each gradient's scale: the limit both f32 routes
# must meet and the bf16 control must exceed.  On an H100 80GB HBM3 (700 W)
# both f32 routes read 6.09 and the bf16 kernel route 78.2 (PERF.md)
F32_GRAD_LIMIT = 10.0
# flash attention (phase 7): the train step's shape (ViT-base on the
# hippocampus plan's first skip, 56x80x56 -> a 7x10x7 grid of patch 8), the
# serving path's (8 mirrors of one window), CT scale (128^3 -> 16^3 patches)
# and the huge preset's head dim; limits (atol, rtol) against the plain
# versions on the same inputs
FLASH_SHAPES = {"train": (1, 12, 490, 64), "serve": (8, 12, 490, 64),
                "CT": (1, 12, 512, 64), "hd80": (1, 16, 512, 80)}
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
NO_JAX = ("lifelong_nnunet_tpu", "jax", "jaxlib", "flax", "optax", "msgpack", "sklearn")
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): bf16 tensor
# cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12           # CUDA cores, the FMA kernels
PEAK_BYTES = 3.35e12
# the CT scale (phases 9-10): a synthetic volume that crops to 156^3, which
# nnU-Net plans at patch 128^3 and serves as a 2x2x2 window grid
CT_SHAPE = (160, 160, 160)
CT_PLAN = {"patch_size": [128, 128, 128], "batch_size": 2,
           "pool_op_kernel_sizes": [[2, 2, 2]] * 5}
CT_WINDOWS = 8
CT_SERVE_BATCH = WINDOW_BATCH * TTA
CT_TRAIN_ITERS, CT_VAL_ITERS, CT_STEP_REPS = 20, 2, 5
CT_ROUTES = {"blocked_conv": True, "upsample": "interleave"}
# the task sequence (phase 11): steps and validation batches per task, the
# progress validation's window batch (the trainer's)
SEQ_ITERS, SEQ_VAL_ITERS, SEQ_WINDOW_BATCH = 30, 2, 4
# the regularizing trainers (phase 12): its third task, made like task B,
# and the limit on the penalty's (and its gradient's) relative difference
# between the card and the CPU from one checkpoint
REG_TASK_C = dict(task_name="Task099_SynthC", shape=SMALL_SHAPE, num_cases=4, seed=11,
                  intensity_shift=-0.6)
PENALTY_RTOL = 1e-5
DIRECT_ROUTES = {"blocked_conv": False, "upsample": "direct"}
# f32 copies at the serving batch are checked where the kernel's input and
# output fit in this many bytes (the largest, 64 x 64 x 128^3, would not fit
# beside its plain version)
CT_F32_BYTES = 40e9


def _time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _compare(name, out, ref, atol, rtol):
    err = (out.float() - ref.float()).abs()
    bound = atol + rtol * ref.float().abs()
    if not bool(torch.isfinite(out.float()).all()) or bool((err > bound).any()):
        raise AssertionError(f"{name}: max |kernel - plain| {err.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol} * |plain|")
    return err.max().item()


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, "operations" or "bytes"): the least time the card could take for
    ``flops`` operations at ``peak`` and ``nbytes`` of memory traffic (each
    input read once, each output written once)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _library_dgrad(dy, x, w):
    """cuDNN's data gradient of the 3x3x3 SAME conv: the library call the
    data-gradient kernel is timed against (never used by the port)."""
    return torch.ops.aten.convolution_backward(
        dy, x, w, None, (1, 1, 1), (1, 1, 1), (1, 1, 1), False, (0, 0, 0), 1,
        (True, False, False))[0]


COUNTED = {"conv3d_in_lrelu": conv3d_in_lrelu_cf,
           "instance_norm_leaky": instance_norm_leaky_cf,
           "conv3d_dx": conv3d_dx_cf,
           "instance_norm_leaky_bwd": instance_norm_leaky_bwd_cf,
           "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd,
           "pack_blocks": block_pack.pack_blocks,
           "unpack_blocks": block_pack.unpack_blocks,
           "interleave_up2": interleave.interleave_up2,
           "deinterleave2": interleave.deinterleave2}


# the wrappers with two kernels, chosen by the input dtype (the fused conv,
# its data gradient, flash attention forward and backward): their launches
# on the tensor-core kernel (bf16 input, the wrapper's ``tc_launches``) and
# on the f32 FMA kernel (the rest), counted apart beside the total
SPLIT = {"conv3d_in_lrelu": ("conv3d_in_lrelu_tc", "conv3d_in_lrelu_f32"),
         "conv3d_dx": ("conv3d_dx_tc", "conv3d_dx_f32"),
         "flash_attention": ("flash_attention_tc", "flash_attention_f32"),
         "flash_attention_bwd": ("flash_attention_bwd_tc", "flash_attention_bwd_f32")}
CONV_SPLIT = ("conv3d_in_lrelu", "conv3d_dx")
FLASH_SPLIT = ("flash_attention", "flash_attention_bwd")


# the InstanceNorm wrappers, which count their launches by the form of their
# launch plan too, as "<name>.<form>"
IN_FORMED = ("instance_norm_leaky", "instance_norm_leaky_bwd")
FORM_KEYS = [f"{name}.{form}" for name in IN_FORMED for form in FORMS]
# the pack likewise, by the form of its launch plan (tma, scalar)
PACK_FORM_KEYS = [f"pack_blocks.{form}" for form in block_pack.FORMS]


def _reset_counts():
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    for name in SPLIT:
        COUNTED[name].tc_launches = 0
    for name in IN_FORMED:
        COUNTED[name].forms = dict.fromkeys(FORMS, 0)
    block_pack.pack_blocks.forms = dict.fromkeys(block_pack.FORMS, 0)


def _counts() -> dict:
    counts = {name: wrapper.launches for name, wrapper in COUNTED.items()}
    for name, (tc, f32) in SPLIT.items():
        counts[tc] = COUNTED[name].tc_launches
        counts[f32] = counts[name] - counts[tc]
    for name in IN_FORMED:
        counts.update({f"{name}.{form}": n for form, n in COUNTED[name].forms.items()})
    counts.update({f"pack_blocks.{form}": n
                   for form, n in block_pack.pack_blocks.forms.items()})
    return counts


def _expect(**counts) -> dict:
    """Every counter, 0 unless given; the tensor-core counts default to
    their wrapper's total and the FMA counts to 0, as on a bf16 path; the
    InstanceNorm's and the pack's counts by form to 0 (give them with
    :func:`_in_forms` and :func:`_pack_forms`)."""
    expect = {name: counts.get(name, 0) for name in COUNTED}
    for name, (tc, f32) in SPLIT.items():
        expect[tc] = counts.get(tc, expect[name])
        expect[f32] = counts.get(f32, expect[name] - expect[tc])
    expect.update({key: counts.get(key, 0) for key in FORM_KEYS + PACK_FORM_KEYS})
    return expect


def _in_forms(dev, fwd=(), bwd=()) -> dict:
    """{"<name>.<form>": launches} that the launch plan predicts on this
    card for bf16 launches of the InstanceNorm forward and backward at
    ``fwd`` / ``bwd``: ((B, C, N), launches) pairs."""
    out = dict.fromkeys(FORM_KEYS, 0)
    for name, work in zip(IN_FORMED, (fwd, bwd)):
        for (b, c, n), count in work:
            plan = launch_plan(b, c, n, torch.bfloat16, name.endswith("bwd"), True,
                               card_limits(dev))
            out[f"{name}.{plan.form}"] += count
    return out


def _pack_forms(dev, work) -> dict:
    """{"pack_blocks.<form>": launches} that the pack's launch plan
    predicts on this card for bf16 launches at ``work``: {(x shape, bs):
    launches}, x contiguous and 16-byte aligned (a fresh activation or
    gradient)."""
    out = dict.fromkeys(PACK_FORM_KEYS, 0)
    for (x_shape, bs), count in work.items():
        plan = block_pack.launch_plan(x_shape, bs, torch.bfloat16, 0, block_pack.card_sms(dev))
        out[f"pack_blocks.{plan.form}"] += count
    return out


def _rows(out_shapes) -> list:
    """(C, N) of each [C, *spatial] map."""
    return [(o[0], math.prod(o[1:])) for o in out_shapes]


def _at(rows, batches) -> list:
    """((B, C, N), launches) of ``rows`` run at each (B, times) of ``batches``."""
    work = {}
    for b, times in batches:
        for c, n in rows:
            work[(b, c, n)] = work.get((b, c, n), 0) + times
    return list(work.items())


def _fma_launches(before: dict, after: dict) -> dict:
    """The f32 FMA launches of the wrappers in SPLIT between two readings,
    by FMA counter; raises if any launch between them took a tensor-core
    kernel."""
    fma = {}
    for name, (tc, f32) in SPLIT.items():
        assert after[tc] == before[tc], (name, before, after)
        fma[f32] = after[f32] - before[f32]
    return fma


def _named_blocks(model, patch, device):
    """[(name, module, in_shape, out_shape)] of every ConvNormAct in forward
    order (shapes without the batch), recorded by hooks on one batch-1
    forward."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out, n=n: seen.append((n, m, tuple(inp[0].shape[1:]),
                                              tuple(out.shape[1:]))))
        for n, m in model.named_modules() if isinstance(m, ConvNormAct)]
    with torch.inference_mode():
        model(torch.zeros((1, model.enc0.block0.conv.in_channels) + tuple(patch),
                          device=device))
    for h in hooks:
        h.remove()
    return seen


# the InstanceNorm kernels against their plain versions: (atol, rtol) of
# the forward's output by its dtype and of the backward's dx by dx's dtype;
# dscale / dbias
IN_TOL = {"fwd": {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 1e-2)},
          "bwd": {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}}
IN_STAT_TOL = (1e-3, 1e-4)
# the InstanceNorm's device time, in a process of its own (see _in_probe)
IN_PROBE = os.path.join(ROOT, "lifelong_nnunet_tpu_torch", "tools", "in_probe.py")


def _in_check(direction, args, dev, chunk=None) -> float:
    """Two launches of the InstanceNorm kernel on ``args`` (in_probe.inputs,
    and for the backward optionally alpha and dx's dtype): each counted
    under the form the launch plan predicts for its shape on this card, the
    second equal to the first bit for bit, the first against the plain
    version within IN_TOL (the forward's per batch slice of ``chunk``
    items where given).  Returns the largest |kernel - plain| of the output
    or dx."""
    x = args[0]
    B, C, N = x.shape
    bwd = direction == "bwd"
    name = IN_FORMED[bwd]
    plan = launch_plan(B, C, N, x.dtype, bwd, True, card_limits(dev))
    key = f"{name}.{plan.form}"
    what = (f"IN {direction} {x.dtype} {tuple(x.shape)} ({plan.form}, cluster "
            f"{plan.cluster})").replace("torch.", "")
    before = _counts()
    if bwd:
        out = instance_norm_leaky_bwd_cf(*args)
        again = instance_norm_leaky_bwd_cf(*args)
        same = all(torch.equal(a, b) for a, b in zip(out, again))
    else:
        out = instance_norm_leaky_cf(*args)
        again = instance_norm_leaky_cf(*args)
        same = torch.equal(out, again)
    after = _counts()
    assert same, f"{what}: a second run differs"
    assert after[name] - before[name] == after[key] - before[key] == 2, (what, before, after)
    del again
    if bwd:
        ref = plain_instance_norm_leaky_bwd(*args)
        err = _compare(what + " dx", out[0], ref[0], *IN_TOL["bwd"][out[0].dtype])
        for o, r, stat in zip(out[1:], ref[1:], ("dscale", "dbias")):
            _compare(f"{what} {stat}", o, r, *IN_STAT_TOL)
        return err
    err = 0.0
    for b0, b1 in _chunks(B, chunk or B):
        err = max(err, _compare(f"{what} [{b0}:{b1}]", out[b0:b1],
                                plain_instance_norm_leaky(x[b0:b1], *args[1:3]),
                                *IN_TOL["fwd"][x.dtype]))
    return err


def _in_probe(*groups) -> dict:
    """{group: timings} of in_probe.py's groups, from a process of its own
    (a torch.profiler started late in a long process loses device events:
    phase 9's conv finish did, and phase 7's flash timing did once phases 1
    and 5 profiled in this process): device ms of the bf16 kernel per
    forward or step, the plain version's, F.instance_norm's (a yardstick,
    not the same function) and the bytes bound."""
    probe = subprocess.run([sys.executable, IN_PROBE, "--root", ROOT, "--groups", *groups],
                           capture_output=True, text=True)
    assert probe.returncode == 0, probe.stderr[-3000:]
    out = {}
    for line in probe.stdout.strip().splitlines():
        g = json.loads(line)
        assert g["card"] == _card(), g["card"]
        out[g["group"]] = g
    assert sorted(out) == sorted(groups), out.keys()
    return out


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _in_text(g, dev) -> str:
    """One in_probe group: its sums and, per shape, the form, time and
    share of the bound."""
    def form(r):
        return launch_plan(g["batch"], r["C"], r["N"], torch.bfloat16,
                           g["direction"] == "bwd", True, card_limits(dev)).form

    plain = "" if g["plain_ms"] is None else f", plain {g['plain_ms']:.4f} ms"
    return (f"kernel {g['ms']:.4f} ms ({g['share']:.3f} of the bytes bound "
            f"{g['bound_ms']:.4f} ms){plain}, F.instance_norm {g['yard_ms']:.4f} ms (not the "
            f"same function); by shape " + ", ".join(
                f"{r['C']}x{r['N']} x{r['count']} {form(r)} {r['ms']:.4f} ms "
                f"({r['bound_ms'] / r['ms']:.3f})" for r in g["shapes"]))


def _block_shapes(model, patch, device):
    """(fused, in_shape, out_shape) of every ConvNormAct in forward order."""
    return [(m.fused, i, o) for _, m, i, o in _named_blocks(model, patch, device)]


def _flash_bound(shape, backward: bool, dtype=torch.bfloat16):
    """(flops, (bound ms, by)) of one flash-attention launch on ``[B, H, N,
    hd]`` of ``dtype``: the forward's two products (4 B H N^2 hd flops) on
    q, k, v read and out written, plus the f32 lse written; the backward's
    five (10 B H N^2 hd: the logits again, dV, dP, dQ, dK) on q, k, v, out,
    dout and the lse read and dq, dk, dv written.  bf16 at the tensor
    cores' peak, f32 at the CUDA cores' (the FMA kernels)."""
    b, h, n, hd = shape
    elems, size = b * h * n * hd, dtype.itemsize
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    if backward:
        flops = 10 * b * h * n * n * hd
        return flops, _bound(flops, 8 * size * elems + 4 * b * h * n, peak)
    flops = 4 * b * h * n * n * hd
    return flops, _bound(flops, 4 * size * elems + 4 * b * h * n, peak)


def _sdpa_grads(q, k, v, g):
    """A closure timing SDPA's backward alone (its forward run once here):
    the library call the backward kernel is timed against."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), g, retain_graph=True)


def _flash_timing(shape, dtype, kernel, library, plain, backward):
    """{"ms", "plain_ms", "library_ms", "turns", "call_ms", "flops",
    "bound"} of one launch: the kernel and the library call in turns
    (kernel, library, library, kernel) by device time, the plain version
    once, and the kernel's CUDA-event time per call beside them."""
    turns = [device_ms(fn) for fn in (kernel, library, library, kernel)]
    flops, bound = _flash_bound(shape, backward, dtype)
    return {"ms": (turns[0] + turns[3]) / 2, "library_ms": (turns[1] + turns[2]) / 2,
            "plain_ms": device_ms(plain, 5), "turns": turns,
            "call_ms": _time_ms(kernel, 10), "flops": flops, "bound": bound}


def _flash_text(t) -> str:
    return (f"kernel {t['ms']:.4f} ms ({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['bound'][0] / t['ms']:.3f} of the bound {t['bound'][0]:.4f} ms, "
            f"{t['bound'][1]}), SDPA {t['library_ms']:.4f} ms (turns "
            f"{[round(x, 4) for x in t['turns']]}), plain {t['plain_ms']:.4f} ms; "
            f"CUDA-event time of one kernel call {t['call_ms']:.4f} ms")


def _flash_phase(randn) -> dict:
    """Phase 7: the flash-attention kernels against their plain versions at
    FLASH_SHAPES, forward (out and lse) and backward (dq, dk, dv from the
    plain forward's out and lse), f32 and bf16, and a second run of each
    kernel equal bit for bit to the first; bf16 on the tensor-core kernels
    and f32 on the FMA kernels (the split counters).  Timed by device time
    per launch (torch.profiler), the kernel and SDPA in turns, the plain
    version beside them: bf16 at every shape, f32 at the train shape.
    Returns {shape name: {"fwd" | "bwd": timing}} for bf16, the f32
    timings under "f32", and the largest errors under "err" ({"fwd" |
    "bwd": {dtype: err}})."""
    res = {}
    err = {p: dict.fromkeys(FLASH_TOL, 0.0) for p in ("fwd", "bwd")}
    for name, shape in FLASH_SHAPES.items():
        for dtype, (atol, rtol) in FLASH_TOL.items():
            q, k, v, g = (randn(*shape, dtype=dtype) for _ in range(4))
            before = _counts()
            out, lse = flash_attention_fwd(q, k, v)
            ref, ref_lse = plain_attention_fwd(q, k, v)
            torch.cuda.synchronize()
            what = f"flash {dtype} {shape}"
            err["fwd"][dtype] = max(err["fwd"][dtype],
                                    _compare(what + " out", out, ref, atol, rtol))
            _compare(what + " lse", lse, ref_lse, 1e-4, 1e-5)
            got = flash_attention_bwd(q, k, v, ref, ref_lse, g)
            want = plain_attention_bwd(q, k, v, ref, ref_lse, g)
            torch.cuda.synchronize()
            for grad, a, b in zip(("dq", "dk", "dv"), got, want):
                err["bwd"][dtype] = max(err["bwd"][dtype],
                                        _compare(f"{what} {grad}", a, b, atol, rtol))
            again = (*flash_attention_fwd(q, k, v),
                     *flash_attention_bwd(q, k, v, ref, ref_lse, g))
            assert all(torch.equal(a, b) for a, b in zip(again, (out, lse, *got))), \
                f"{what}: a second run differs"
            after = _counts()
            tc = dtype == torch.bfloat16
            assert all(after[n] - before[n] == 2 and after[SPLIT[n][0]] - before[SPLIT[n][0]]
                       == 2 * tc for n in FLASH_SPLIT), (what, before, after)
            if name == "train" or tc:
                key = name if tc else "f32"
                res[key] = {
                    "fwd": _flash_timing(shape, dtype, lambda: flash_attention_fwd(q, k, v),
                                         lambda: F.scaled_dot_product_attention(q, k, v),
                                         lambda: plain_attention_fwd(q, k, v), False),
                    "bwd": _flash_timing(
                        shape, dtype, lambda: flash_attention_bwd(q, k, v, ref, ref_lse, g),
                        _sdpa_grads(q, k, v, g),
                        lambda: plain_attention_bwd(q, k, v, ref, ref_lse, g), True)}
                print(f"[phase 7]   flash {name} {shape} {dtype}, one launch, device time: "
                      .replace("torch.", "")
                      + "; ".join(f"{p} {_flash_text(t)}" for p, t in res[key].items()),
                      flush=True)
            del q, k, v, g, out, lse, ref, ref_lse, got, want, again
    print(f"[phase 7] flash attention: {len(FLASH_SHAPES)} shapes ok, forward (out; lse "
          f"atol 1e-4 + rtol 1e-5) and backward (dq, dk, dv) against the plain versions, "
          + ", ".join(f"{d} atol {a} + rtol {r}" for d, (a, r) in
                      zip(("f32", "bf16"), FLASH_TOL.values()))
          + "; max err " + ", ".join(f"{p} {d} {e:.3e}".replace("torch.", "")
                                     for p, by in err.items() for d, e in by.items())
          + "; second runs equal bit for bit; bf16 launches on the tensor-core kernels, "
            "f32 on the FMA kernels", flush=True)
    res["err"] = err
    return res


def _step_check(make_model, batch, ds_factors, dev, dead=(), attention=0) -> str:
    """One train step from the same weights and batch, its loss and every
    parameter's gradient, on four routes: kernel and plain in f32, the
    kernel route in bf16 (the control: a route whose roundoff is known to
    be too large), and the plain route in f64 (f64 statistics and logits),
    which the other three are held to.  ``make_model(dtype, use_kernels)``
    builds the seeded model; the modules named in ``dead`` get no gradient
    on any route; ``attention`` is the model's number of attention blocks
    (one flash forward and backward each on the kernel routes).  The f32
    kernel route's fused convs and flash attention must run the FMA
    kernels, the bf16 control's the tensor-core kernels.  Raises where a
    limit is missed; returns the readings and the f32 route's FMA launches."""
    torch.backends.cudnn.allow_tf32 = False
    grads, fma = {}, None
    # the biases of the convs whose kernels ignore them (the fused and the
    # blocked route's), as the kernel route's forward takes them
    fused_bias = set()
    for route, use_kernels, dtype in (("kernel", True, torch.float32),
                                      ("plain", False, torch.float32),
                                      ("kernel bf16", True, torch.bfloat16),
                                      ("plain f64", False, torch.float64)):
        m = make_model(dtype, use_kernels)
        m = m.to(dev, torch.float64 if dtype == torch.float64 else torch.float32)
        hooks = [mod.register_forward_pre_hook(
            lambda mod, inp, n=n: fused_bias.add(f"{n}.conv.bias")
            if mod.route(inp[0].shape) in ("fused", "blocked") else None)
            for n, mod in m.named_modules() if isinstance(mod, ConvNormAct)] \
            if route == "kernel" else []
        before = _counts()
        loss = deep_supervision_loss(m(batch["data"]), batch["seg"].long(), ds_factors)
        for h in hooks:
            h.remove()
        loss.backward()
        after = _counts()
        launched = {name: after[name] - before[name] for name in SPLIT}
        assert not use_kernels or all(launched[n] > 0 for n in CONV_SPLIT) and all(
            launched[n] == attention for n in FLASH_SPLIT), (route, launched)
        if route == "kernel":
            fma = _fma_launches(before, after)
        elif route == "kernel bf16":
            assert all(after[tc] - before[tc] == launched[name]
                       for name, (tc, _) in SPLIT.items()), (before, after)
        else:
            assert all(after[n] == before[n] for n in SPLIT), (route, before, after)
        assert all(p.grad is None for d in dead for p in getattr(m, d).parameters()), route
        # the coarsest head has loss weight 0 and no gradient
        grads[route] = (loss.item(), {
            k: torch.zeros_like(p) if p.grad is None else p.grad.double()
            for k, p in m.named_parameters()})
    # such a bias: the InstanceNorm absorbs it, so its gradient is 0 on the
    # kernel route and roundoff of 0 on the plain route, held to 1e-3 of its
    # weight's gradient
    del m, loss
    (lk, gk), (lp, gp), (lb, gb), (l64, g64) = (
        grads[r] for r in ("kernel", "plain", "kernel bf16", "plain f64"))
    bias_err = max(gp[k].abs().max().item() / gp[k[:-4] + "weight"].abs().max().item()
                   for k in fused_bias if k.split(".")[0] not in dead)
    assert all(not gk[k].any() for k in fused_bias) and bias_err <= 1e-3, bias_err

    def worst(g):
        """max over parameters of |g - g64| / (1e-5 + 1e-3 max|g64|)"""
        return max(((g[k] - g64[k]).abs().max().item()
                    / (1e-5 + 1e-3 * g64[k].abs().max().item()), k)
                   for k in g64 if k not in fused_bias)

    (grad_err, worst_k), (plain_err, worst_p), (bf16_err, worst_b) = \
        worst(gk), worst(gp), worst(gb)
    readings = (lk, lp, lb, l64, grad_err, worst_k, plain_err, worst_p, bf16_err, worst_b)
    assert math.isfinite(lk) and abs(lk - l64) <= 1e-4, readings
    assert max(grad_err, plain_err) <= F32_GRAD_LIMIT < bf16_err, readings
    return fma, (f"f32 step against the plain route in f64: |loss diff| kernel "
            f"{abs(lk - l64):.3e} (limit 1e-4), plain {abs(lp - l64):.3e}, bf16 control "
            f"{abs(lb - l64):.3e}; worst gradient |diff| / (1e-5 + 1e-3 max|f64|): kernel "
            f"route {grad_err:.3f} ({worst_k}), plain route {plain_err:.3f} ({worst_p}), "
            f"limit {F32_GRAD_LIMIT}, kernel route in bf16 (control, must exceed it) "
            f"{bf16_err:.3f} ({worst_b}); the {len(fused_bias)} fused and blocked convs' "
            f"biases 0 vs plain <= {bias_err:.3e} of the weight's (limit 1e-3); launches "
            f"of the f32 kernel route on the FMA kernels {fma}, of the bf16 control on the "
            f"tensor-core kernels")


def _turns(make_model, batches, step_cfg, dev, order=(False, True, True, False),
           reps=STEP_REPS, profiled=(True, False)):
    """Warm seconds per train step (bf16, ``step_cfg``'s augmentation), the
    routes in turns (``order``: by default plain, kernel, kernel, plain;
    ``make_model(dtype, route)``), and the device time by kernel of each
    route in ``profiled`` over PROFILE_STEPS more warm steps (torch.profiler).
    Returns ({route: [s/step]}, {route: (wall s, [(ms, name)])})."""
    torch.backends.cudnn.allow_tf32 = True
    # the medians print in the reverse order of first turns: kernel, plain
    step_s, profile = {r: [] for r in sorted(set(order), key=lambda r: -order.index(r))}, {}
    for use_kernels in order:
        m = make_model(torch.bfloat16, use_kernels).to(dev)
        opt = PolySGD(m.parameters(), max_epochs=TRAIN_EPOCHS, iters_per_epoch=TRAIN_ITERS)
        train_step = make_train_step(
            m, opt, step_cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
        for i in range(3):
            train_step({}, batches[i % len(batches)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            train_step({}, batches[i % len(batches)])
        torch.cuda.synchronize()
        step_s[use_kernels].append((time.perf_counter() - t0) / reps)
        if use_kernels in profiled and use_kernels not in profile:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(PROFILE_STEPS):
                    train_step({}, batches[i % len(batches)])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / PROFILE_STEPS
            profile[use_kernels] = wall, sorted(
                ((e.self_device_time_total / PROFILE_STEPS / 1e3, e.key)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0), reverse=True)
        del m, opt, train_step
        torch.cuda.empty_cache()
    return step_s, profile


ROUTE_NAMES = {True: "kernel", False: "plain", "ct": "CT"}


def _turns_text(step_s) -> str:
    """The medians, the first-listed route first, and every run."""
    return ("warm s/step, bf16, in turns: " + " vs ".join(
        f"{ROUTE_NAMES.get(r, r)} route {statistics.median(t):.4f}" for r, t in step_s.items())
        + " (runs " + " vs ".join(str([round(x, 4) for x in t]) for t in step_s.values())
        + ")")


def _print_profile(phase: int, what: str, profile) -> None:
    for route in sorted(profile, key=lambda r: r is False):
        wall, kernels_ms = profile[route]
        busy = sum(t for t, _ in kernels_ms)
        print(f"[phase {phase}] {ROUTE_NAMES.get(route, route)} route, device time "
              f"per {what} (torch.profiler, {PROFILE_STEPS} warm steps): {busy:.3f} ms of "
              f"{1e3 * wall:.3f} ms wall under the profiler, busy share "
              f"{busy / (1e3 * wall):.3f}; {len(kernels_ms)} kernels, the top: "
              + "; ".join(f"{name[:60]} {t:.3f} ms" for t, name in kernels_ms[:12]),
              flush=True)


def _ct_work(blocks, model, batch) -> dict:
    """What the CT routes launch at ``batch``: the routes of the blocks, and
    the copy kernels' shapes with their (forward, backward) counts per train
    step, under "pack" ((x shape, bs)), "unpack" ((y shape, grid)) and
    "ileave" ((upsample input shape, weight shape))."""
    work = {"route": {}, "pack": {}, "unpack": {}, "ileave": {}}

    def add(kind, key, fwd, bwd):
        f, b = work[kind].get(key, (0, 0))
        work[kind][key] = (f + fwd, b + bwd)

    out_of = {}
    for i, (name, m, in_shape, out_shape) in enumerate(blocks):
        x_shape = (batch,) + in_shape
        work["route"][name] = m.route(x_shape)
        out_of[name] = out_shape
        bs = m.packed_bs(x_shape)
        if bs is None:
            continue
        grid = tuple(s // bs for s in in_shape[1:])
        nb = batch * math.prod(grid)
        add("pack", (x_shape, bs), 1, 0)
        add("unpack", ((nb, out_shape[0]) + (out_shape[1] // grid[0],) * 3, grid), 1, 0)
        if m.conv.stride == (1, 1, 1) and i > 0:    # the data gradient: dy in, dx out
            add("pack", ((batch,) + out_shape, bs), 0, 1)
            add("unpack", ((nb, in_shape[0]) + (bs,) * 3, grid), 0, 1)
    for d in range(model.num_pool):
        h_shape = (batch,) + out_of["bottleneck.block1" if d == 0 else f"dec{d - 1}.block1"]
        if model.interleaved(d, h_shape):
            add("ileave", (h_shape, tuple(getattr(model, f"up{d}").weight.shape)), 1, 1)
    return work


def _library_pack(x, bs):
    """The halo'd windows through F.pad and Tensor.unfold, materialized: the
    library time beside the pack kernel (never used by the port)."""
    S, C = bs + 2, x.shape[1]
    u = F.pad(x, (1,) * 6).unfold(2, S, bs).unfold(3, S, bs).unfold(4, S, bs)
    return u.permute(0, 2, 3, 4, 1, 5, 6, 7).reshape(-1, C, S, S, S)


def _library_unpack(y, batch, grid):
    """The inverse permute of the unfold chain, materialized."""
    nd, nh, nw = grid
    C, s = y.shape[1], y.shape[2]
    return y.view(batch, nd, nh, nw, C, s, s, s).permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(
        batch, C, nd * s, nh * s, nw * s)


def _octants(x, w):
    """The upsample's eight octant products, stacked [N, 8, Co D, H, W]: the
    interleave kernel's input on the main path."""
    N, Ci, D, H, W = x.shape
    Co = w.shape[1]
    w8 = w.to(x.dtype).permute(2, 3, 4, 1, 0).reshape(8 * Co, Ci)
    return torch.bmm(w8.expand(N, -1, -1), x.reshape(N, Ci, -1)).view(N, 8, Co * D, H, W)


def _grads_closure(fn, x, w, g):
    """A closure timing the backward (x and w gradients) of ``fn(x, w)``
    alone, its forward run once here."""
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    out = fn(xs, ws)
    return lambda: torch.autograd.grad(out, (xs, ws), g, retain_graph=True)


def _chunks(n, size=8):
    return [(i, min(n, i + size)) for i in range(0, n, size)]


def _ct_copy_phase(blocks, model, dev, gen) -> dict:
    """Phase 9: the four copy kernels against their plain versions, bit for
    bit, at every shape of the CT train step (B=2; bf16 and f32) and of CT
    serving (B=64; bf16, and f32 where it fits CT_F32_BYTES), the plain
    versions taken in batch chunks of 8 items at B=64; the octant route
    against F.conv_transpose3d at the same shapes; bf16 medians per train
    step of the kernel, its plain version, the library call and, for the
    interleaves, the octant route beside F.conv_transpose3d.  Returns
    {kernel: {"ms", "plain_ms", "library_ms", "route_ms", "bound", "err",
    "shapes"}}."""
    res = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "route_ms": 0.0, "bytes": 0,
               "err": 0.0, "shapes": 0} for n in ("pack_blocks", "unpack_blocks",
                                                  "interleave_up2", "deinterleave2")}
    up_err = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def add(name, n, nbytes, kernel, plain, library, route=None):
        r = res[name]
        r["ms"] += n * _time_ms(kernel)
        r["plain_ms"] += n * _time_ms(plain)
        r["library_ms"] += n * _time_ms(library)
        r["route_ms"] += n * _time_ms(route) if route else 0.0
        r["bytes"] += n * nbytes

    for batch in (TRAIN_BATCH, CT_SERVE_BATCH):
        work = _ct_work(blocks, model, batch)
        timed = batch == TRAIN_BATCH
        for (x_shape, bs), (f, b) in work["pack"].items():
            grid = tuple(s // bs for s in x_shape[2:])
            per_item = math.prod(grid)
            out_numel = batch * per_item * x_shape[1] * (bs + 2) ** 3
            for dtype in (torch.float32, torch.bfloat16):
                if not timed and dtype == torch.float32 and \
                        4 * (math.prod(x_shape) + out_numel) > CT_F32_BYTES:
                    continue
                x = rand(x_shape, dtype)
                before = dict(block_pack.pack_blocks.forms)
                out = block_pack.pack_blocks(x, bs)
                torch.cuda.synchronize()
                assert block_pack.pack_blocks.forms == {**before, "tma": before["tma"] + 1}, \
                    f"pack_blocks {dtype} {x_shape} bs {bs}: not in the tma form"
                for b0, b1 in _chunks(batch):
                    assert torch.equal(out[b0 * per_item:b1 * per_item],
                                       block_pack.plain_pack_blocks(x[b0:b1], bs)), \
                        f"pack_blocks {dtype} {x_shape} bs {bs}"
                res["pack_blocks"]["shapes"] += 1
                if timed and dtype == torch.bfloat16:
                    assert torch.equal(_library_pack(x, bs), out)
                    add("pack_blocks", f + b, 2 * (x.numel() + out.numel()),
                        lambda: block_pack.pack_blocks(x, bs),
                        lambda: block_pack.plain_pack_blocks(x, bs),
                        lambda: _library_pack(x, bs))
                del x, out
        for (y_shape, grid), (f, b) in work["unpack"].items():
            per_item = math.prod(grid)
            for dtype in (torch.float32, torch.bfloat16):
                if not timed and dtype == torch.float32 and \
                        8 * math.prod(y_shape) > CT_F32_BYTES:
                    continue
                y = rand(y_shape, dtype)
                out = block_pack.unpack_blocks(y, batch, grid)
                torch.cuda.synchronize()
                for b0, b1 in _chunks(batch):
                    assert torch.equal(out[b0:b1], block_pack.plain_unpack_blocks(
                        y[b0 * per_item:b1 * per_item], b1 - b0, grid)), \
                        f"unpack_blocks {dtype} {y_shape} grid {grid}"
                res["unpack_blocks"]["shapes"] += 1
                if timed and dtype == torch.bfloat16:
                    assert torch.equal(_library_unpack(y, batch, grid), out)
                    add("unpack_blocks", f + b, 2 * (y.numel() + out.numel()),
                        lambda: block_pack.unpack_blocks(y, batch, grid),
                        lambda: block_pack.plain_unpack_blocks(y, batch, grid),
                        lambda: _library_unpack(y, batch, grid))
                del y, out
        for (h_shape, w_shape), (f, b) in work["ileave"].items():
            for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-4),
                                      (torch.bfloat16, 2e-2, 1e-2)):
                if not timed and dtype == torch.float32 and \
                        4 * 3 * 8 * math.prod(h_shape) // h_shape[1] * w_shape[1] > CT_F32_BYTES:
                    continue
                x = rand(h_shape, dtype)
                w = rand(w_shape, torch.float32) * math.sqrt(1.0 / w_shape[0])
                y = _octants(x, w)
                parts = y.unbind(1)
                out = interleave._interleave(parts)
                back = interleave._deinterleave(out, 2)
                torch.cuda.synchronize()
                assert torch.equal(back, y), f"deinterleave2 {dtype} {tuple(y.shape)}"
                for b0, b1 in _chunks(batch):
                    assert torch.equal(out[b0:b1], interleave.plain_interleave(
                        [p[b0:b1] for p in parts])), f"interleave_up2 {dtype} {h_shape}"
                    assert torch.equal(back[b0:b1], torch.stack(
                        interleave.plain_deinterleave(out[b0:b1], 2), 1))
                del back
                # the octant route against the library's transposed conv
                for b0, b1 in _chunks(batch):
                    ref = F.conv_transpose3d(x[b0:b1], w.to(dtype), stride=2)
                    up_err[dtype] = max(up_err[dtype], _compare(
                        f"octant upsample {dtype} {h_shape}",
                        out[b0:b1].view(ref.shape), ref, atol, rtol))
                    del ref
                for name in ("interleave_up2", "deinterleave2"):
                    res[name]["shapes"] += 1
                if timed and dtype == torch.bfloat16:
                    wb = w.to(dtype)
                    g = rand(out.shape, dtype).view(
                        (batch, w_shape[1]) + tuple(2 * s for s in h_shape[2:]))
                    add("interleave_up2", f, 2 * 2 * out.numel(),
                        lambda: interleave._interleave(parts),
                        lambda: interleave.plain_interleave(parts),
                        lambda: F.conv_transpose3d(x, wb, stride=2),
                        lambda: interleave.conv_transpose3d_interleave(x, w))
                    lib_bwd = _grads_closure(lambda a, c: F.conv_transpose3d(a, c, stride=2),
                                             x, wb, g)
                    route_bwd = _grads_closure(interleave.conv_transpose3d_interleave, x, w, g)
                    add("deinterleave2", b, 2 * 2 * out.numel(),
                        lambda: interleave._deinterleave(out, 2),
                        lambda: torch.stack(interleave.plain_deinterleave(out, 2), 1),
                        lib_bwd, route_bwd)
                    del g, lib_bwd, route_bwd, wb
                del x, w, y, parts, out
        torch.cuda.empty_cache()
    for r in res.values():
        r["bound"] = _bound(0, r.pop("bytes"))
    res["up_err"] = up_err
    return res


# the pack's device time, in a process of its own (see _in_probe)
PACK_PROBE = os.path.join(ROOT, "lifelong_nnunet_tpu_torch", "tools", "pack_probe.py")


def _pack_probe(blocks, model) -> dict:
    """{group: timings} of pack_probe.py's groups, from a process of its
    own: device ms of the bf16 pack per CT train step ("ct_train", B=2) and
    per CT serving forward ("ct_serve", B=64), beside its bytes bound, the
    library chain (F.pad + Tensor.unfold) and the plain version (where it
    fits), every launch in the tma form; the probe's shapes held to what
    the CT routes launch."""
    for group, (batch, shapes) in pack_probe.GROUPS.items():
        work = _ct_work(blocks, model, batch)["pack"]
        got = {(x_shape[1:], bs): f + (b if group == "ct_train" else 0)
               for (x_shape, bs), (f, b) in work.items()}
        assert got == {(shape, pack_probe.BS): n for shape, n in shapes}, (group, got)
    probe = subprocess.run([sys.executable, PACK_PROBE, "--root", ROOT], capture_output=True,
                           text=True)
    assert probe.returncode == 0, probe.stderr[-3000:]
    out = {}
    for line in probe.stdout.strip().splitlines():
        g = json.loads(line)
        assert g["card"] == _card() and g["forms_used"] == ["tma"], (g["card"], g["forms_used"])
        out[g["group"]] = g
    assert sorted(out) == sorted(pack_probe.GROUPS), out.keys()
    return out


def _opt(v, fmt=".3f") -> str:
    return "not measured" if v is None else f"{v:{fmt}} ms"


# the fused conv's device time by kernel at the CT serving batch, in a
# process of its own (a fresh profiler: one started late in this long run
# has recorded no device events on the card)
FINISH_PROBE = os.path.join(ROOT, "lifelong_nnunet_tpu_torch", "tools", "conv_finish_probe.py")


def _ct_conv_phase(blocks, dev, gen) -> dict:
    """Phase 9, the tensor-core conv at CT scale: the fused forward at every
    stride-1 (Cin, Cout, spatial) of the CT U-Net (the ordinary kernel
    route runs all of them) at the train batch (2) and the serving batch
    (64), and its data gradient at the train batch for every block but the
    first, bf16, against the plain versions with phases 2 and 5's limits
    (atol 5e-2 + rtol 1e-2; at B=64 the plain version per 8 batch items:
    the statistics are per item), each launch counted on the tensor-core
    kernel.  Per shape at B=64: the kernel's and cuDNN's F.conv3d medians.
    Returns per-forward sums at B=64 (counts of the kernel route) and the
    largest errors."""
    fwd, dx = {}, {}
    for i, (_, m, in_shape, out_shape) in enumerate(blocks):
        if m.conv.stride == (1, 1, 1):
            key = (in_shape[0], out_shape[0], in_shape[1:])
            fwd[key] = fwd.get(key, 0) + 1
            if i > 0:
                dx[key] = dx.get(key, 0) + 1
    res = {"shapes": sum(fwd.values()), "err": 0.0, "dx_err": 0.0, "ms": 0.0, "lib_ms": 0.0,
           "flops": 0, "bytes": 0}

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def counted(name, fn):
        before = _counts()
        out = fn()
        after = _counts()
        assert after[name] == before[name] + 1 and \
            after[SPLIT[name][0]] == before[SPLIT[name][0]] + 1, (name, before, after)
        return out

    for (cin, cout, sp), count in fwd.items():
        w = rand((cout, cin, 3, 3, 3)) * math.sqrt(2.0 / (27 * cin))
        scale, off = rand(cout) * 0.1 + 1, rand(cout) * 0.1
        for batch in (TRAIN_BATCH, CT_SERVE_BATCH):
            x = rand((batch, cin) + sp, torch.bfloat16)
            out = counted("conv3d_in_lrelu", lambda: conv3d_in_lrelu_cf(x, w, scale, off))
            for b0, b1 in _chunks(batch):
                res["err"] = max(res["err"], _compare(
                    f"CT conv bf16 B={batch} [{b0}:{b1}] {cin}->{cout} {sp}", out[b0:b1],
                    plain_conv3d_in_lrelu(x[b0:b1], w, scale, off), 5e-2, 1e-2))
            del out
            if batch == CT_SERVE_BATCH:
                wb = w.to(torch.bfloat16)
                k_ms = _time_ms(lambda: conv3d_in_lrelu_cf(x, w, scale, off), reps=3)
                l_ms = _time_ms(lambda: F.conv3d(x, wb, padding=1), reps=3)
                flops = 2 * 27 * cin * cout * batch * math.prod(sp)
                nbytes = 2 * (batch * math.prod(sp) * (cin + cout) + 27 * cin * cout)
                for k, v in (("ms", k_ms), ("lib_ms", l_ms), ("flops", flops),
                             ("bytes", nbytes)):
                    res[k] += count * v
                print(f"[phase 9]   CT conv {cin:>3}->{cout:<3} {'x'.join(map(str, sp)):>11} "
                      f"B={batch} bf16 x{count}: tensor-core kernel {k_ms:8.3f} ms "
                      f"({flops / 1e9 / k_ms:.1f} TFLOP/s), cuDNN F.conv3d {l_ms:8.3f} ms",
                      flush=True)
                del wb
            del x
            torch.cuda.empty_cache()
        if (cin, cout, sp) in dx:
            dy = rand((TRAIN_BATCH, cout) + sp, torch.bfloat16)
            out = counted("conv3d_dx", lambda: conv3d_dx_cf(dy, w))
            res["dx_err"] = max(res["dx_err"], _compare(
                f"CT conv dx bf16 B={TRAIN_BATCH} {cin}<-{cout} {sp}", out,
                plain_conv3d_dx(dy, w), 5e-2, 1e-2))
            del dy, out
    res["dx_shapes"] = sum(dx.values())
    res["bound"] = _bound(res["flops"], res.pop("bytes"))
    return res


def _ct_in_phase(blocks, model, dev, gen) -> tuple:
    """Phase 9, the InstanceNorm kernels at CT scale: the forward at the
    outputs of the CT U-Net's cuDNN and blocked convs at the train batch (2)
    and the serving batch (64), the backward at every conv output at the
    train batch, f32 and bf16 (f32 at B=64 where its three copies fit
    CT_F32_BYTES), each through :func:`_in_check` (the plain forward per 8
    batch items); then their device time per launch, bf16, with the bytes
    bound and F.instance_norm beside it, from in_probe.py in a process of
    its own.  Returns ({"fwd" | "bwd": largest error}, {group: timings})."""
    routes = _ct_work(blocks, model, TRAIN_BATCH)["route"]
    shapes = {}
    for direction, outs in (("fwd", [o for name, _, _, o in blocks
                                     if routes[name] in ("conv", "blocked")]),
                            ("bwd", [o for _, _, _, o in blocks])):
        counts = {}
        for row in _rows(outs):
            counts[row] = counts.get(row, 0) + 1
        shapes[direction] = tuple((c, n, k) for (c, n), k in counts.items())
    assert (shapes["fwd"], shapes["bwd"]) == (in_probe.CT_FWD, in_probe.CT_BWD), shapes
    err = {"fwd": 0.0, "bwd": 0.0}
    for direction, batches in (("fwd", (TRAIN_BATCH, CT_SERVE_BATCH)), ("bwd", (TRAIN_BATCH,))):
        for c, n, _ in shapes[direction]:
            for b in batches:
                for dtype in (torch.float32, torch.bfloat16):
                    if dtype == torch.float32 and 3 * 4 * b * c * n > CT_F32_BYTES:
                        continue
                    args = in_probe.inputs(direction, b, c, n, gen, dtype)
                    err[direction] = max(err[direction], _in_check(direction, args, dev, 8))
                    del args
                    torch.cuda.empty_cache()
    return err, _in_probe("ct_fwd_b2", "ct_fwd_b64", "ct_bwd_b2")


def _ct_path(ct_dir, plans, blocks, model, work, pre, results, dev) -> dict:
    """Phase 10: the CT path through its entry points (see the module
    docstring).  Returns the launch counts of the two CLI runs, and the
    fused conv's FMA launches of the f32 checks (serving, the train step)."""
    task = os.path.basename(ct_dir)
    cfg = plans.config("3d_fullres")
    patch = tuple(cfg.patch_size)
    classes = plans.num_classes + 1
    b2 = TRAIN_BATCH
    plan = _ct_work(blocks, model, b2)
    routes = plan["route"]
    assert _ct_work(blocks, model, CT_SERVE_BATCH)["route"] == routes
    n = {r: sum(v == r for v in routes.values()) for r in ("blocked", "fused", "conv")}
    assert sum(n.values()) == len(routes), routes
    # every stride-1 block but the first, whose input is the data, runs its
    # data gradient through its route's kernels
    later = [(name, m) for name, m, _, _ in blocks[1:]]
    n_dx = {r: sum(routes[name] == r and m.conv.stride == (1, 1, 1) for name, m in later)
            for r in ("blocked", "fused")}
    n_up = sum(f for f, _ in plan["ileave"].values())
    # the InstanceNorm forward runs after the cuDNN and the blocked convs, its
    # backward on every conv's output
    in_rows = _rows([o for name, _, _, o in blocks if routes[name] in ("conv", "blocked")])
    all_rows = _rows([o for _, _, _, o in blocks])
    fwd = {"conv3d_in_lrelu": n["fused"], "instance_norm_leaky": n["conv"] + n["blocked"],
           "pack_blocks": n["blocked"], "unpack_blocks": n["blocked"],
           "interleave_up2": n_up}
    bwd = {"conv3d_dx": n_dx["fused"], "instance_norm_leaky_bwd": len(routes),
           "pack_blocks": n_dx["blocked"], "unpack_blocks": n_dx["blocked"],
           "deinterleave2": n_up}

    # -- training through the CLI, both switches on (set in phase 4)
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_training("base_v2", ["3d_fullres", "-t", task, "-f", "0", "-num_epochs", "1",
                             "-num_iters", str(CT_TRAIN_ITERS), "-val_iters", str(CT_VAL_ITERS),
                             "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = _counts()
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, vals = CT_TRAIN_ITERS, CT_VAL_ITERS
    # every pack of the path in the TMA form, as its launch plan predicts
    pack_forms = _pack_forms(dev, {k: f * (steps + vals) + b * steps
                                   for k, (f, b) in plan["pack"].items()})
    assert pack_forms["pack_blocks.scalar"] == 0, pack_forms
    expect = _expect(**{k: fwd.get(k, 0) * (steps + vals) + bwd.get(k, 0) * steps
                        for k in set(fwd) | set(bwd)},
                     **_in_forms(dev, fwd=_at(in_rows, [(b2, steps + vals)]),
                                 bwd=_at(all_rows, [(b2, steps)])), **pack_forms)
    assert train_launches == expect, (train_launches, expect)
    trained = output_folder(os.path.join(results, "nnUNet_ext"), "3d_fullres", task,
                            "base_v2", plans.plans_name, 0, transfer_heads=True)
    with open(os.path.join(trained, "progress.json")) as f:
        losses = json.load(f)["step_losses"]
    assert len(losses) == steps and all(map(math.isfinite, losses)), losses
    ckpt = os.path.join(trained, "model_final_checkpoint")

    # -- serving one 156^3 case through the CLI: one batch of 8 windows x 8
    # mirrors
    images = os.path.join(work, "images_ct")
    os.makedirs(images)
    shutil.copy(os.path.join(ct_dir, "imagesTr", "synth_000_0000.nii.gz"), images)
    ((case, files),) = case_files(images)
    data, _ = preprocess_for_inference(files, plans, "3d_fullres")
    n_win = len(window_grid(data.shape[:-1], patch)[2])
    assert n_win == CT_WINDOWS, (data.shape, n_win)
    forwards = math.ceil(n_win / WINDOW_BATCH)
    served = os.path.join(work, "seg_ct")
    torch.cuda.empty_cache()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_inference(["3d_fullres", "base_v2", "-i", images, "-o", served, "-trained_on", task,
                   "-window_batch", str(WINDOW_BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = _counts()
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serve_batch = min(n_win, WINDOW_BATCH) * TTA
    pack_forms = _pack_forms(dev, {k: f * forwards for k, (f, _) in
                                   _ct_work(blocks, model, serve_batch)["pack"].items()})
    assert pack_forms["pack_blocks.scalar"] == 0, pack_forms
    expect = _expect(**{k: v * forwards for k, v in fwd.items()},
                     **_in_forms(dev, fwd=_at(in_rows, [(serve_batch, forwards)])),
                     **pack_forms)
    assert serve_launches == expect, (serve_launches, expect)

    # the f32 overlap-added probabilities, CT routes against the ordinary
    # kernel route (window batch 1: an f32 batch of 64 at 128^3 would not
    # fit), and the CLI's segmentation against the plain route's
    torch.backends.cudnn.allow_tf32 = False
    probs = {}
    before = _counts()
    for name, r in (("ct", CT_ROUTES), ("kernel", DIRECT_ROUTES)):
        m, _, _ = restore_model(ckpt, dev, routes=r)
        m.dtype = torch.float32
        probs[name] = predict_sliding_window(m, data, patch, classes, device=dev,
                                             window_batch=1, output="probs")
        del m
        torch.cuda.empty_cache()
    fma_serve = _fma_launches(before, _counts())
    assert fma_serve["conv3d_in_lrelu_f32"] > 0, fma_serve
    pk = probs["ct"]
    assert pk.shape == data.shape[:-1] + (classes,) and np.isfinite(pk).all()
    assert np.allclose(pk.sum(-1), 1.0, atol=1e-4)
    prob_err = float(np.abs(pk - probs["kernel"]).max())
    assert prob_err <= 1e-3, prob_err
    del probs, pk
    m, _, _ = restore_model(ckpt, dev, use_kernels=False)
    plain_dir = os.path.join(work, "seg_ct_plain")
    predict_from_folder([m], plans, "3d_fullres", images, plain_dir, device=dev, window_batch=1)
    del m
    seg = np.asarray(read_image(os.path.join(served, f"{case}.nii.gz")).data)
    plain = np.asarray(read_image(os.path.join(plain_dir, f"{case}.nii.gz")).data)
    label = np.asarray(read_image(os.path.join(ct_dir, "labelsTr", f"{case}.nii.gz")).data)
    assert seg.shape == plain.shape == label.shape and int(seg.max()) < classes
    agree = float((seg == plain).mean())
    assert agree >= 0.99, agree
    dice = subject_metrics(seg, label, classes)["Dice"]

    # s/volume of the device path, the two kernel routes in turns, each
    # model warmed by one untimed volume (the first batch of 64 after the
    # other route's maps its memory anew)
    vol_s = {"ct": [], "kernel": []}
    for name in ("kernel", "ct", "ct", "kernel"):
        m, _, _ = restore_model(ckpt, dev, routes=CT_ROUTES if name == "ct" else DIRECT_ROUTES)
        for timed in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict_sliding_window(m, data, patch, classes, device=dev,
                                   window_batch=WINDOW_BATCH, output="probs_bf16")
            torch.cuda.synchronize()
            if timed:
                vol_s[name].append(time.perf_counter() - t0)
        del m

    # one train step on four routes, then s/step in turns
    stage = os.path.join(pre, task, "nnUNetData_plans_v2.1_3d_fullres")
    dataset = PreprocessedDataset(stage)
    sampler = PatchSampler(dataset, dataset.cases, patch, b2, seed=SEED)
    batches = [{k: torch.from_numpy(b[k]).to(dev) for k in ("data", "seg")}
               for b in (sampler.next_batch() for _ in range(2))]
    ds_factors = tuple(ds_scale_factors(cfg.pool_op_kernel_sizes))
    step_cfg = StepConfig(ds_factors=ds_factors, batch_dice=True, num_classes=classes,
                          augment=AugmentConfig())

    def ct_unet(dtype, route):
        """``route``: True / "ct" (the CT routes), "kernel", or False / "plain"."""
        return unet_from_plans(plans, "3d_fullres", dtype=dtype,
                               use_kernels=route not in (False, "plain"),
                               generator=torch.Generator().manual_seed(SEED),
                               **(CT_ROUTES if route in (True, "ct") else DIRECT_ROUTES))

    fma_step, step_text = _step_check(ct_unet, batches[0], ds_factors, dev)
    step_s, profile = _turns(ct_unet, batches, step_cfg, dev,
                             order=("plain", "kernel", "ct", "ct", "kernel", "plain"),
                             reps=CT_STEP_REPS, profiled=("ct",))
    print(f"[phase 10] CT configuration {plans.num_modalities}->{classes}, patch {patch}, "
          f"batch {b2}, pools {cfg.pool_op_kernel_sizes}, {cfg.base_num_features}->"
          f"{cfg.max_num_features} features; routes per forward {n}, blocked "
          f"{[name for name, r in routes.items() if r == 'blocked']}, interleaved upsamples "
          f"{n_up}; nnUNet_torch_train_base_v2 --device cuda, LNN_BLOCKED_CONV=1 "
          f"LNN_UPT_MODE=pallas, 1 epoch x {steps} steps + {vals} val batches: "
          f"{train_s:.2f} s in all, peak {train_peak_gb:.2f} GB; launches {train_launches} == "
          f"predicted per step {{forward {fwd}, backward {bwd}}} (+ the forward per val "
          f"batch); loss first 5 steps {statistics.mean(losses[:5]):.4f} -> last 5 "
          f"{statistics.mean(losses[-5:]):.4f}", flush=True)
    print(f"[phase 10] nnUNet_torch_inference --device cuda on one {data.shape[:-1]} case "
          f"({n_win} windows, {forwards} forward of {min(n_win, WINDOW_BATCH) * TTA}): "
          f"{serve_s:.2f} s (first run), peak {serve_peak_gb:.2f} GB, launches "
          f"{serve_launches} == predicted; f32 max |probs CT routes - kernel route| "
          f"{prob_err:.3e} (limit 1e-3; fused convs on the FMA kernel {fma_serve}); seg "
          f"agreement with the plain route {agree:.5f} "
          f"(limit 0.99); Dice ({steps} steps, recorded) {[round(d, 4) for d in dice]}; "
          f"s/volume of the sliding window, window batch {WINDOW_BATCH}, in turns: CT routes "
          f"{statistics.median(vol_s['ct']):.3f} vs kernel route "
          f"{statistics.median(vol_s['kernel']):.3f} (runs "
          f"{[round(t, 4) for t in vol_s['ct']]} vs {[round(t, 4) for t in vol_s['kernel']]})",
          flush=True)
    print(f"[phase 10] {step_text}; " + _turns_text(step_s), flush=True)
    _print_profile(10, "CT train step", profile)
    return ({"ct_train": train_launches, "ct_serve": serve_launches},
            {"ct_serve_f32": fma_serve, "ct_train_f32_step": fma_step})


class _SequenceProbe:
    """Phase 11's measurements, by wrapping three trainer methods while the
    CLIs run: the seconds of each ``train_task`` and of each
    ``_perform_validation`` (synchronized), every train step's seconds
    (synchronized before and after the step) and CL penalty, and the
    rehearsal pool of each task.  The wrappers only time and record."""

    def __init__(self):
        self.tasks, self.steps, self.val_s, self.pools = [], {}, [], {}
        self.penalties = {}     # task: [the step's CL penalty (a device tensor)]
        self._saved = {}

    def _wrap(self, cls, name, make):
        self._saved[(cls, name)] = getattr(cls, name)
        setattr(cls, name, make(getattr(cls, name)))

    def __enter__(self):
        probe = self

        def train_task(orig):
            def timed(self, task, *args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                probe.steps[task] = []
                out = orig(self, task, *args, **kw)
                torch.cuda.synchronize()
                probe.tasks.append((task, time.perf_counter() - t0))
                return out
            return timed

        def build_step(orig):
            def wrapped(self):
                orig(self)
                step, task = self._train_step, self.mh.active_task

                def timed(cl_state, batch):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = step(cl_state, batch)
                    torch.cuda.synchronize()
                    probe.steps.setdefault(task, []).append(time.perf_counter() - t0)
                    probe.penalties.setdefault(task, []).extend(
                        v for k, v in out[1].items() if k.endswith("_penalty"))
                    return out
                self._train_step = timed
            return wrapped

        def validation(orig):
            def timed(self, *args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(self, *args, **kw)
                torch.cuda.synchronize()
                probe.val_s.append(time.perf_counter() - t0)
                return out
            return timed

        def pool(orig):
            def recorded(self, task):
                out = orig(self, task)
                probe.pools[task] = [(os.path.basename(os.path.dirname(ds.stage_dir)), c)
                                     for ds, c in out]
                return out
            return recorded

        self._wrap(MultiHeadTrainer, "train_task", train_task)
        self._wrap(MultiHeadTrainer, "_build_step", build_step)
        self._wrap(MultiHeadTrainer, "_perform_validation", validation)
        self._wrap(RehearsalTrainer, "rehearsal_pool", pool)
        return self

    def __exit__(self, *exc):
        for (cls, name), orig in self._saved.items():
            setattr(cls, name, orig)

    def warm_step_s(self, task, skip=3):
        return statistics.median(self.steps[task][skip:])


def _train_expect(dev, shapes, batch, steps, vals, progress, fisher=0, attn=0) -> dict:
    """Every counter of a training run of a model whose blocks are
    ``shapes`` (:func:`_block_shapes`): ``steps`` train steps and ``fisher``
    fisher batches (a forward and a backward each) and ``vals`` validation
    batches at ``batch``, and a progress-validation forward at each batch
    of ``progress``; ``attn`` attention blocks per forward (the ViT's)."""
    n_fused = sum(f for f, _, _ in shapes)
    n_strided = len(shapes) - n_fused
    back = steps + fisher
    fwd = back + vals + len(progress)
    return _expect(
        conv3d_in_lrelu=n_fused * fwd, instance_norm_leaky=n_strided * fwd,
        conv3d_dx=(n_fused - 1) * back, instance_norm_leaky_bwd=(n_fused + n_strided) * back,
        flash_attention=attn * fwd, flash_attention_bwd=attn * back,
        **_in_forms(dev, fwd=_at(_rows([o for f, _, o in shapes if not f]),
                                 [(batch, back + vals)] + [(b, 1) for b in progress]),
                    bwd=_at(_rows([o for _, _, o in shapes]), [(batch, back)])))


def _task_stages(pre, tasks) -> tuple:
    """({task: its preprocessed dataset}, {task: its fold-0 split})."""
    stages = {t: PreprocessedDataset(os.path.join(pre, t, "nnUNetData_plans_v2.1_3d_fullres"))
              for t in tasks}
    return stages, {t: final_splits(os.path.join(pre, t), stages[t].cases)[0] for t in tasks}


def _val_batches(stage, split, patch) -> list:
    """The progress validation's window batches over a task's val cases
    (the trainer's window batch)."""
    out = []
    for case in split["val"]:
        n = len(window_grid(stage.load(case).shape[1:], patch)[2])
        out += [min(SEQ_WINDOW_BATCH, n - i) for i in range(0, n, SEQ_WINDOW_BATCH)]
    return out


def _serve_batches(images, plans, patch) -> list:
    """The model batches of serving a folder: windows per forward times the
    mirror variants."""
    out = []
    for _, files in case_files(images):
        data, _ = preprocess_for_inference(files, plans, "3d_fullres")
        n = len(window_grid(data.shape[:-1], patch)[2])
        out += [min(WINDOW_BATCH, n - i) * TTA for i in range(0, n, WINDOW_BATCH)]
    return out


def _sequence_path(task_dir, plans, shapes, work, pre, results, dev) -> tuple:
    """Phase 11: a sequence of two hippocampus-scale tasks through the CL
    entry points (see the module docstring).  Returns the launch counts of
    the training runs (``cl_train``) and of serving the heads
    (``cl_serve``), and Sequential's warm s/step per task."""
    cfg = plans.config("3d_fullres")
    patch, b2, classes = tuple(cfg.patch_size), TRAIN_BATCH, plans.num_classes + 1
    n_fused = sum(f for f, _, _ in shapes)
    n_strided = len(shapes) - n_fused
    strided = _rows([o for f, _, o in shapes if not f])
    a_dir = task_dir
    b_dir = make_synthetic_task(os.path.dirname(task_dir), task_name="Task098_SynthB",
                                shape=SMALL_SHAPE, num_cases=4, seed=7, intensity_shift=0.8)
    plan_and_preprocess([b_dir], pre, configs=("3d_fullres",), verbose=False)
    raw_dirs = {os.path.basename(d): d for d in (a_dir, b_dir)}
    tasks = list(raw_dirs)
    stages, splits = _task_stages(pre, tasks)

    # after A: A's val cases with head A; after B: A's and B's, each its head
    progress = _val_batches(stages[tasks[0]], splits[tasks[0]], patch) * 2 + \
        _val_batches(stages[tasks[1]], splits[tasks[1]], patch)
    steps, vals = 2 * SEQ_ITERS, 2 * SEQ_VAL_ITERS
    expect_train = _train_expect(dev, shapes, b2, steps, vals, progress)
    argv = ["3d_fullres", "-t"] + tasks + [
        "-num_epochs", "1", "-num_iters", str(SEQ_ITERS), "-val_iters", str(SEQ_VAL_ITERS),
        "-save_interval", "1", "--use_progress_val", "--device", "cuda"]
    ext_root = os.path.join(results, "nnUNet_ext")

    def folder(ext, upto):
        return build_output_folder(ext_root, "3d_fullres", tasks, tasks[: upto + 1],
                                   trainer_name(ext), plans.plans_name, 0, True)

    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    train_launches, probes, peak_gb = {}, {}, {}
    for ext in ("sequential", "rehearsal"):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with _SequenceProbe() as probe:
            run_training(ext, argv)
        torch.cuda.synchronize()
        peak_gb[ext] = torch.cuda.max_memory_allocated() / 1e9
        train_launches[ext] = _counts()
        assert train_launches[ext] == expect_train, (ext, train_launches[ext], expect_train)
        probes[ext] = probe
        final = folder(ext, 1)
        with open(os.path.join(final, "progress.json")) as f:
            record = json.load(f)
        assert len(record["step_losses"]) == steps, len(record["step_losses"])
        assert all(map(math.isfinite, record["step_losses"]))
        assert [e["task"] for e in record["epochs"]] == tasks, record["epochs"]
        assert all(math.isfinite(e["tr_loss"]) and math.isfinite(e["val_loss"])
                   for e in record["epochs"])
        with open(os.path.join(final, "val_metrics.json")) as f:
            history = json.load(f)
        assert [{t: r["head"] for t, r in h["results"].items()} for h in history] == \
            [{tasks[0]: tasks[0]}, {t: t for t in tasks}], history
        assert all(sorted(history[-1]["results"][t]["subjects"]) == sorted(splits[t]["val"])
                   for t in tasks)
        assert [t for t, _ in probe.tasks] == tasks and len(probe.val_s) == 2
    pools = probes["rehearsal"].pools
    tr_a, tr_b = splits[tasks[0]]["train"], splits[tasks[1]]["train"]
    n_rehearsed = max(1, round(0.25 * len(tr_a)))
    assert pools[tasks[0]] == [(tasks[0], c) for c in tr_a], pools
    assert pools[tasks[1]][: len(tr_b)] == [(tasks[1], c) for c in tr_b], pools
    rehearsed = pools[tasks[1]][len(tr_b):]
    assert len(rehearsed) == n_rehearsed == len(set(rehearsed)), pools
    assert all(t == tasks[0] and c in tr_a for t, c in rehearsed), pools

    # a second -c run of the finished sequence trains nothing
    _reset_counts()
    run_training("sequential", argv + ["-c"])
    resume_launches = _counts()
    assert resume_launches == _expect(), resume_launches

    # serving each head on each task's images
    images = {t: os.path.join(raw_dirs[t], "imagesTr") for t in tasks}
    labels = {t: os.path.join(raw_dirs[t], "labelsTr") for t in tasks}
    serve_batches = [b for t in tasks for b in _serve_batches(images[t], plans, patch)]
    serve_batches *= len(tasks)            # every head on every task
    _reset_counts()
    dice, served = {}, {}
    for head in tasks:
        for t in tasks:
            out = os.path.join(work, f"seq_{head}_on_{t}")
            run_inference(["3d_fullres", "sequential", "-i", images[t], "-o", out,
                           "-trained_on"] + tasks + ["-use_head", head, "-window_batch",
                                                     str(WINDOW_BATCH), "--device", "cuda"])
            served[(head, t)] = out
            per_case = []
            for case, files in case_files(images[t]):
                seg = np.asarray(read_image(os.path.join(out, f"{case}.nii.gz")).data)
                label = np.asarray(read_image(os.path.join(labels[t], f"{case}.nii.gz")).data)
                assert seg.shape == label.shape and int(seg.max()) < classes
                per_case.append(float(np.nanmean(subject_metrics(seg, label, classes)["Dice"])))
            dice[(head, t)] = statistics.mean(per_case)
    serve_launches = _counts()
    assert serve_launches == _expect(
        conv3d_in_lrelu=n_fused * len(serve_batches),
        instance_norm_leaky=n_strided * len(serve_batches),
        **_in_forms(dev, fwd=_at(strided, [(b, 1) for b in serve_batches]))), serve_launches

    # one case of B with head B on the plain route against the served one
    ckpt = os.path.join(folder("sequential", 1), "model_final_checkpoint")
    case, files = case_files(images[tasks[1]])[0]
    m, _, _ = restore_model(ckpt, dev, head=tasks[1], use_kernels=False)
    plain_seg, _, _ = predict_case([m], files, plans, "3d_fullres", device=dev,
                                   window_batch=WINDOW_BATCH)
    del m
    kernel_seg = np.asarray(read_image(os.path.join(served[(tasks[1], tasks[1])],
                                                    f"{case}.nii.gz")).data)
    agree = float((kernel_seg == plain_seg).mean())
    assert agree >= 0.99, agree

    per_step = (f"per step {{conv3d_in_lrelu: {n_fused}, instance_norm_leaky: {n_strided}, "
                f"conv3d_dx: {n_fused - 1}, instance_norm_leaky_bwd: {n_fused + n_strided}}}, "
                f"+{n_fused}/+{n_strided} per val batch and per progress-validation forward")
    for ext in ("sequential", "rehearsal"):
        probe = probes[ext]
        print(f"[phase 11] nnUNet_torch_train_{ext} -t {' '.join(tasks)} --device cuda, full "
              f"width, patch {patch}, batch {b2}, 1 epoch x {SEQ_ITERS} steps + {SEQ_VAL_ITERS} "
              f"val batches per task, progress validation after each task ("
              f"{len(progress)} forwards, window batches {progress}): seconds per task "
              + ", ".join(f"{t} {s:.2f}" for t, s in probe.tasks)
              + f"; warm s/step (median of steps 4-{SEQ_ITERS}, synchronized) "
              + ", ".join(f"{t} {probe.warm_step_s(t):.4f}" for t in tasks)
              + f"; progress validation {[round(s, 3) for s in probe.val_s]} s; peak "
              f"{peak_gb[ext]:.2f} GB; launches {train_launches[ext]} == predicted, "
              + per_step, flush=True)
    print(f"[phase 11] rehearsal pool of {tasks[1]}: its {len(tr_b)} train cases + "
          f"{n_rehearsed} of {tasks[0]}'s {len(tr_a)} ({[c for _, c in rehearsed]}, "
          f"RandomState(3299)); val_metrics.json after {tasks[1]} holds {tasks} with their "
          f"own heads; a second -c run trained nothing (all launch counts 0)", flush=True)
    print(f"[phase 11] nnUNet_torch_inference sequential -trained_on {' '.join(tasks)} "
          f"-use_head <head>: {len(serve_batches)} forwards, launches {serve_launches} == "
          f"predicted; mean foreground Dice (random init + {SEQ_ITERS} steps per task, "
          f"recorded; rows head, columns images) "
          + "; ".join(f"head {h}: " + ", ".join(f"{t} {dice[(h, t)]:.4f}" for t in tasks)
                      for h in tasks)
          + f"; {case} with head {tasks[1]}: seg agreement kernel vs plain route {agree:.5f} "
          f"(limit 0.99)", flush=True)
    cl_train = {k: train_launches["sequential"][k] + train_launches["rehearsal"][k]
                for k in train_launches["sequential"]}
    return ({"cl_train": cl_train, "cl_serve": serve_launches},
            {t: probes["sequential"].warm_step_s(t) for t in tasks})


class _RegularizerProbe(_SequenceProbe):
    """Phase 12's measurements on top of phase 11's: each fisher pass's
    seconds (synchronized) and the EWC anchors it finds on entry, and, per
    RW train step, the iteration counter and whether the running state
    was updated."""

    def __enter__(self):
        super().__enter__()
        probe = self
        self.fisher_s, self.anchors_on_entry, self.gate = [], [], []

        def fisher(orig):
            def timed(self, task):
                probe.anchors_on_entry.append((task, dict(self.cl_state["ewc_tasks"])))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig(self, task)
                torch.cuda.synchronize()
                probe.fisher_s.append((task, time.perf_counter() - t0))
            return timed

        def gate(orig):
            def wrapped(self):
                inner = orig(self)

                def update(cl_state, model, loss):
                    out = inner(cl_state, model, loss)
                    probe.gate.append((cl_state["running"]["iter"], out["running"]["fisher"]
                                       is not cl_state["running"]["fisher"]))
                    return out
                return update
            return wrapped

        self._wrap(EWCTrainer, "after_task", fisher)
        self._wrap(RWTrainer, "cl_state_update", gate)
        return self


def _launch_calls(fn, reps: int = 3) -> float:
    """Kernel launches the host issues per call of ``fn`` (the runtime's
    launch calls in torch.profiler, which the device's event buffer cannot
    drop), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                            "cuLaunchKernelEx")) / reps


def _regularizer_path(task_dir, plans, shapes, vit, work, pre, results, dev,
                      seq_step_s) -> dict:
    """Phase 12: the regularizing and freezing trainers through their entry
    points on phase 11's tasks A and B and a third task C (see the module
    docstring).  Returns the launch counts of the training runs, the
    resumed one included (``cl_reg_train``), and of serving EWC's heads
    (``cl_reg_serve``)."""
    cfg = plans.config("3d_fullres")
    patch, b2, classes = tuple(cfg.patch_size), TRAIN_BATCH, plans.num_classes + 1
    raw_root = os.path.dirname(task_dir)
    c_dir = make_synthetic_task(raw_root, **REG_TASK_C)
    plan_and_preprocess([c_dir], pre, configs=("3d_fullres",), verbose=False)
    tasks = [os.path.basename(task_dir), "Task098_SynthB", os.path.basename(c_dir)]
    raw_dirs = {t: os.path.join(raw_root, t) for t in tasks}
    stages, splits = _task_stages(pre, tasks)
    val_b = {t: _val_batches(stages[t], splits[t], patch) for t in tasks}
    ext_root = os.path.join(results, "nnUNet_ext")
    vit_arch = dict(vit=True, vit_version="V1", vit_type="base", task_specific_ln=False,
                    spt=False, lsa=False)
    vit_b = max(1, b2 // 2)
    steps_per, vals_per = SEQ_ITERS, SEQ_VAL_ITERS

    def argv(run):
        return ["3d_fullres", "-t"] + run + [
            "-num_epochs", "1", "-num_iters", str(steps_per), "-val_iters", str(vals_per),
            "-save_interval", "1", "--use_progress_val", "--device", "cuda"]

    def folder(ext, run, upto, vit_run=False):
        return build_output_folder(ext_root, "3d_fullres", run, run[: upto + 1],
                                   trainer_name(ext), plans.plans_name, 0,
                                   get_trainer(ext).TRANSFER_HEADS,
                                   **(vit_arch if vit_run else {}))

    def registry(base, device=torch.device("cpu")):
        mh, blob, manifest = load_registry(os.path.join(base, "model_final_checkpoint"),
                                           device, [])
        return mh, blob.get("cl_state"), manifest

    def progress(run):
        """After each task its val cases and every earlier task's."""
        return [b for i in range(len(run)) for t in run[: i + 1] for b in val_b[t]]

    runs = [("ewc", tasks, False, True), ("rw", tasks[:2], False, False),
            ("frozen_body_seq", tasks[:2], False, False), ("ewc_ln", tasks[:2], True, True),
            ("frozen_vit", tasks[:2], True, False)]
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    launches, probes, peak_gb, run_s = {}, {}, {}, {}
    for ext, run, vit_run, fisher in runs:
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _RegularizerProbe() as probe:
            run_training(ext, argv(run) + (["--use_vit"] if vit_run else []))
        torch.cuda.synchronize()
        run_s[ext] = time.perf_counter() - t0
        peak_gb[ext] = torch.cuda.max_memory_allocated() / 1e9
        launches[ext] = _counts()
        steps = len(run) * steps_per
        expect = _train_expect(dev, vit["shapes"] if vit_run else shapes,
                               vit_b if vit_run else b2, steps, len(run) * vals_per,
                               progress(run), fisher=steps if fisher else 0,
                               attn=vit["n_attn"] if vit_run else 0)
        assert launches[ext] == expect, (ext, launches[ext], expect)
        probes[ext] = probe
        final = folder(ext, run, len(run) - 1, vit_run)
        with open(os.path.join(final, "progress.json")) as f:
            record = json.load(f)
        assert len(record["step_losses"]) == steps and all(map(math.isfinite,
                                                              record["step_losses"])), ext
        assert [t for t, _ in probe.tasks] == run and len(probe.val_s) == len(run), ext
        assert [t for t, _ in probe.fisher_s] == (run if fisher else []), ext

    # ---- EWC over A, B, C: the penalty, the anchors, the checkpoints
    ewc = probes["ewc"]
    pens = {t: torch.stack(ewc.penalties[t]).float().cpu() if ewc.penalties.get(t) else None
            for t in tasks}
    assert pens[tasks[0]] is None, "EWC ran a penalty on its first task"
    assert all(bool(torch.isfinite(pens[t]).all() and (pens[t] > 0).all())
               and len(pens[t]) == steps_per for t in tasks[1:]), pens
    ckpt_bytes, anchored = [], []
    for i, t in enumerate(tasks):
        base = folder("ewc", tasks, i)
        _, cl, manifest = registry(base)
        assert manifest["has_cl_state"] and manifest["anchor_dtype"] == "bfloat16", manifest
        assert list(cl["ewc_tasks"]) == tasks[: i + 1], list(cl["ewc_tasks"])
        assert all(v.dtype == torch.bfloat16 for s in cl["ewc_tasks"].values()
                   for part in s.values() for v in part.values())
        ckpt_bytes.append(os.path.getsize(os.path.join(base, "model_final_checkpoint.pt")))
        anchored.append(len(cl["ewc_tasks"][t]["fisher"]))

    # the penalty and its gradient from B's final checkpoint, on the card
    # and on the CPU
    pen_on = {}
    for device in (dev, torch.device("cpu")):
        mh, cl, _ = registry(folder("ewc", tasks, 1), device)
        named = {k: torch.nn.Parameter(v.float()) for k, v in mh.assemble(tasks[1]).items()}
        pen = QuadraticPenalty(named, [{"weight": s["fisher"], "params": s["params"]}
                                       for s in cl["ewc_tasks"].values()], 0.4)
        value, _ = pen()
        pen.add_grad()
        pen_on[device.type] = (value.item(), {k: p.grad.cpu() for k, p in named.items()})
    (pen_cuda, g_cuda), (pen_cpu, g_cpu) = pen_on["cuda"], pen_on["cpu"]
    pen_rel = abs(pen_cuda - pen_cpu) / abs(pen_cpu)
    grad_rel = max(((g_cuda[k] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                   for k, g in g_cpu.items())
    assert pen_cpu > 0 and pen_rel <= PENALTY_RTOL and grad_rel <= PENALTY_RTOL, (
        pen_cuda, pen_cpu, grad_rel)

    # the EWC step's launches beside the same step without the penalty, at
    # C's first parameters (A's and B's anchors)
    tr = restore_trainer(os.path.join(folder("ewc", tasks, 2), "before_training"),
                         TrainerOptions(device="cuda"))
    batch = PatchSampler(stages[tasks[2]], splits[tasks[2]]["train"], patch, b2,
                         seed=SEED).next_batch()
    batch = {k: torch.from_numpy(batch[k]).to(dev) for k in ("data", "seg")}
    plain_step = make_train_step(tr.model, tr.optimizer, StepConfig(
        ds_factors=tr.ds_factors, batch_dice=True, num_classes=classes))
    ewc_step = make_train_step(tr.model, tr.optimizer, StepConfig(
        ds_factors=tr.ds_factors, batch_dice=True, num_classes=classes),
        loss_extras=tr.loss_extras())
    penalty = tr.loss_extras()
    calls = {"plain": _launch_calls(lambda: plain_step(tr.cl_state, batch)),
             "ewc": _launch_calls(lambda: ewc_step(tr.cl_state, batch)),
             "penalty": _launch_calls(lambda: (penalty(), penalty.add_grad()))}
    pen_ms = _time_ms(lambda: (penalty(), penalty.add_grad()))
    # the same step with and without the penalty, CUDA-event medians in
    # turns (plain, EWC, EWC, plain)
    step_ms = {"plain": [], "ewc": []}
    for name in ("plain", "ewc", "ewc", "plain"):
        step = plain_step if name == "plain" else ewc_step
        step_ms[name].append(_time_ms(lambda: step(tr.cl_state, batch), reps=STEP_REPS))
    del tr, plain_step, ewc_step, penalty

    # -c after C trains nothing; -c after a kill between C's model_latest
    # and its fisher pass restores A's and B's anchors and runs that pass
    _reset_counts()
    run_training("ewc", argv(tasks) + ["-c"])
    assert _counts() == _expect(), _counts()
    manifest_file = os.path.join(metadata_folder(ext_root, "3d_fullres", tasks,
                                                 trainer_name("ewc"), plans.plans_name),
                                 "ewc_trained_on.json")
    with open(manifest_file) as f:
        trained_on = json.load(f)
    trained_on["0"].update(finished_training_on=tasks[:2], start_training_on=tasks[2],
                           finished_validation_on=tasks[:2])
    with open(manifest_file, "w") as f:
        json.dump(trained_on, f)
    _, cl_b, _ = registry(folder("ewc", tasks, 1))
    _reset_counts()
    with _RegularizerProbe() as resumed:
        run_training("ewc", argv(tasks) + ["-c"])
    resume_launches = _counts()
    assert resume_launches == _train_expect(dev, shapes, b2, 0, 0, [], fisher=steps_per), \
        resume_launches
    (task_c, held), = resumed.anchors_on_entry
    assert task_c == tasks[2] and list(held) == tasks[:2], list(held)
    assert all(torch.equal(v.cpu(), cl_b["ewc_tasks"][t][part][k])
               for t in tasks[:2] for part in ("fisher", "params")
               for k, v in held[t][part].items())

    # serving each of the 3 heads on each task's images
    images = {t: os.path.join(raw_dirs[t], "imagesTr") for t in tasks}
    labels = {t: os.path.join(raw_dirs[t], "labelsTr") for t in tasks}
    serve_batches = [b for t in tasks for b in _serve_batches(images[t], plans, patch)]
    serve_batches *= len(tasks)
    n_fused = sum(f for f, _, _ in shapes)
    n_strided = len(shapes) - n_fused
    _reset_counts()
    dice = {}
    for head in tasks:
        for t in tasks:
            out = os.path.join(work, f"ewc_{head}_on_{t}")
            run_inference(["3d_fullres", "ewc", "-i", images[t], "-o", out, "-trained_on"]
                          + tasks + ["-use_head", head, "-window_batch", str(WINDOW_BATCH),
                                     "--device", "cuda"])
            per_case = []
            for case, _ in case_files(images[t]):
                seg = np.asarray(read_image(os.path.join(out, f"{case}.nii.gz")).data)
                label = np.asarray(read_image(os.path.join(labels[t], f"{case}.nii.gz")).data)
                assert seg.shape == label.shape and int(seg.max()) < classes
                per_case.append(float(np.nanmean(subject_metrics(seg, label, classes)["Dice"])))
            dice[(head, t)] = statistics.mean(per_case)
    serve_launches = _counts()
    assert serve_launches == _expect(
        conv3d_in_lrelu=n_fused * len(serve_batches),
        instance_norm_leaky=n_strided * len(serve_batches),
        **_in_forms(dev, fwd=_at(_rows([o for f, _, o in shapes if not f]),
                                 [(b, 1) for b in serve_batches]))), serve_launches

    # ---- RW over A, B: the gate, the running state, the anchor
    rw = probes["rw"]
    gate_every = METHOD_ARGS["rw"]["fisher_update_after"][1]      # the CLI's default
    assert rw.gate == [(i, i % gate_every == 0) for i in range(2 * steps_per)], rw.gate
    _, cl, manifest = registry(folder("rw", tasks[:2], 1))
    r, anchor = cl["running"], cl["anchor"]
    assert r["iter"] == 2 * steps_per and cl["num_tasks_done"] == 2
    assert all(bool(torch.isfinite(v.float()).all()) for part in (
        r["fisher"], r["scores"], anchor["scores"], *cl["score_sets"]) for v in part.values())
    assert all(v.dtype == torch.float32 for part in anchor.values() for v in part.values())
    assert [all(v.dtype == torch.bfloat16 for v in s.values()) for s in cl["score_sets"]] \
        == [True, True]
    assert manifest["anchor_dtype"] == "float32" and manifest["score_sets_dtype"] == "bfloat16"
    rw_pen = torch.stack(rw.penalties[tasks[1]]).float().cpu()
    assert not rw.penalties.get(tasks[0]) and bool(torch.isfinite(rw_pen).all()
                                                   and (rw_pen > 0).all())
    fisher_sum = sum(float(v.double().sum()) for v in r["fisher"].values())
    set_max = [max(float(v.float().max()) for v in s.values()) for s in cl["score_sets"]]

    # ---- frozen_body_seq: B's body is A's bit for bit, its head moved
    mh_a, _, _ = registry(folder("frozen_body_seq", tasks[:2], 0))
    mh_b, _, _ = registry(folder("frozen_body_seq", tasks[:2], 1))
    assert all(torch.equal(v, mh_a.body[k]) for k, v in mh_b.body.items())
    assert any(not torch.equal(v, mh_a.heads[tasks[0]][k]) for k, v in mh_b.heads[tasks[1]].items())

    # ---- ewc_ln (ViT-U-Net): anchors on the ViT's LayerNorms only
    mh_ln, cl_ln, _ = registry(folder("ewc_ln", tasks[:2], 1, True))
    ln_keys = sorted(k for k, on in name_filter_mask(mh_ln.assemble(), ["vit", "norm"],
                                                     True).items() if on)
    assert all(sorted(s[part]) == ln_keys for s in cl_ln["ewc_tasks"].values()
               for part in ("fisher", "params")) and len(cl_ln["ewc_tasks"]) == 2
    n_params = len(mh_ln.assemble())

    # ---- frozen_vit: the ViT as after A, bit for bit; the U-Net moved
    fa, _, _ = registry(folder("frozen_vit", tasks[:2], 0, True))
    fb, _, _ = registry(folder("frozen_vit", tasks[:2], 1, True))
    wa, wb = fa.assemble(tasks[0]), fb.assemble(tasks[1])
    vit_keys = [k for k in wb if k.startswith("vit.")]
    assert vit_keys and all(torch.equal(wb[k], wa[k]) for k in vit_keys)
    assert any(not torch.equal(wb[k], wa[k]) for k in wb if not k.startswith("vit."))

    # ---- the record
    per_step = "per train step and per fisher batch {conv3d_in_lrelu: %d, " \
        "instance_norm_leaky: %d, conv3d_dx: %d, instance_norm_leaky_bwd: %d%s}, +%d/+%d%s " \
        "per val batch and per progress-validation forward"
    u_step = per_step % (n_fused, n_strided, n_fused - 1, n_fused + n_strided, "", n_fused,
                         n_strided, "")
    v_fused = sum(f for f, _, _ in vit["shapes"])
    v_strided = len(vit["shapes"]) - v_fused
    v_step = per_step % (v_fused, v_strided, v_fused - 1, v_fused + v_strided,
                         f", flash_attention: {vit['n_attn']}, flash_attention_bwd: "
                         f"{vit['n_attn']}", v_fused, v_strided, f"/+{vit['n_attn']} flash")
    for ext, run, vit_run, fisher in runs:
        probe = probes[ext]
        print(f"[phase 12] nnUNet_torch_train_{ext} -t {' '.join(run)}"
              + (" --use_vit" if vit_run else "") + f" --device cuda, full width"
              + (" (V1, ViT-base, batch 1)" if vit_run else f" (batch {b2})")
              + f", 1 epoch x {steps_per} steps + {vals_per} val batches per task: "
              f"{run_s[ext]:.2f} s, seconds per task "
              + ", ".join(f"{t} {s:.2f}" for t, s in probe.tasks)
              + "; warm s/step (median of steps 4-30, synchronized) "
              + ", ".join(f"{t} {probe.warm_step_s(t):.4f}" for t in run)
              + ("; fisher pass s " + ", ".join(f"{t} {s:.3f}" for t, s in probe.fisher_s)
                 if fisher else "")
              + f"; progress validation {[round(v, 3) for v in probe.val_s]} s; peak "
              f"{peak_gb[ext]:.2f} GB; launches {launches[ext]} == predicted, "
              + (v_step if vit_run else u_step), flush=True)
    print(f"[phase 12] ewc: penalty per step 0 on {tasks[0]}, "
          + ", ".join(f"{t} {float(pens[t].min()):.4e}..{float(pens[t].max()):.4e}"
                      for t in tasks[1:])
          + f"; anchors (bf16) {anchored} tensors per task; model_final_checkpoint bytes "
          f"per task {ckpt_bytes}; from {tasks[1]}'s final checkpoint the penalty on the "
          f"card {pen_cuda:.6e} vs the CPU {pen_cpu:.6e} (rel {pen_rel:.2e}, gradient "
          f"{grad_rel:.2e}, limit {PENALTY_RTOL}); launch calls per step: Sequential-style "
          f"{calls['plain']:.0f}, EWC with 2 anchors {calls['ewc']:.0f} (+"
          f"{calls['ewc'] - calls['plain']:.0f}), the penalty and its gradient alone "
          f"{calls['penalty']:.0f} in {pen_ms:.3f} ms (CUDA events); the step in turns "
          f"(CUDA events, ms) plain {[round(v, 3) for v in step_ms['plain']]}, EWC "
          f"{[round(v, 3) for v in step_ms['ewc']]}; warm s/step beside "
          f"phase 11's Sequential " + ", ".join(f"{t} {v:.4f}" for t, v in seq_step_s.items())
          + "; a -c run after C trained nothing (all launch counts 0); a -c run after a kill "
          f"between {tasks[2]}'s model_latest and its fisher pass restored {tasks[:2]}'s "
          f"anchors bit for bit and ran that pass alone (launches {resume_launches})",
          flush=True)
    print(f"[phase 12] nnUNet_torch_inference ewc -trained_on {' '.join(tasks)} -use_head "
          f"<head>: {len(serve_batches)} forwards, launches {serve_launches} == predicted; "
          f"mean foreground Dice (rows head, columns images) "
          + "; ".join(f"head {h}: " + ", ".join(f"{t} {dice[(h, t)]:.4f}" for t in tasks)
                      for h in tasks), flush=True)
    print(f"[phase 12] rw: running state updated on iterations {[i for i, u in rw.gate if u]} "
          f"of {len(rw.gate)} (every {gate_every}), finite (fisher sum {fisher_sum:.4e}; "
          f"largest normalized score per task {set_max}); penalty on {tasks[1]} "
          f"{float(rw_pen.min()):.4e}..{float(rw_pen.max()):.4e}; anchor f32, score sets "
          f"bf16; frozen_body_seq: {tasks[1]}'s {len(mh_b.body)} body tensors equal "
          f"{tasks[0]}'s bit for bit, its head moved; ewc_ln: anchors on {len(ln_keys)} of "
          f"{n_params} tensors (the ViT's LayerNorms); frozen_vit: {len(vit_keys)} vit.* "
          f"tensors unchanged bit for bit through {tasks[1]}, the U-Net's moved", flush=True)
    cl_reg_train = {k: sum(c[k] for c in launches.values()) + resume_launches[k]
                    for k in resume_launches}
    return {"cl_reg_train": cl_reg_train, "cl_reg_serve": serve_launches}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: "
                         "torch.cuda.is_available() is false")
    # plain f32 references run in true f32 (cuDNN would use TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device("cuda")
    print(_card())
    t0 = time.perf_counter()
    ext = build.load_extension()
    print(f"[phase 0] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; kernels built from "
          f"{os.path.relpath(build.CSRC, ROOT)} by one cpp_extension.load in "
          f"{time.perf_counter() - t0:.2f} s -> {os.path.relpath(ext.__file__, ROOT)}",
          flush=True)

    work_root = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work_root, exist_ok=True)
    work = tempfile.mkdtemp(dir=work_root)
    try:
        # ---- the hippocampus-scale task and its plan (set-up for 1-4)
        raw = os.path.join(work, "raw", "nnUNet_raw_data")
        pre = os.path.join(work, "pre")
        task_dir = make_synthetic_task(raw, shape=SMALL_SHAPE, num_cases=4, seed=SEED)
        task = os.path.basename(task_dir)
        plan_and_preprocess([task_dir], pre, configs=("3d_fullres",), verbose=False)
        plans = Plans.load(plans_path(os.path.join(pre, task)))
        cfg = plans.config("3d_fullres")
        assert cfg.base_num_features == 32 and cfg.max_num_features == 320, cfg
        patch = tuple(cfg.patch_size)
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def randn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        # the folder to segment: the task's 4 cases (one window each) and one
        # larger case of the same kind (a 2x2x2 grid of windows), so the main
        # path overlap-adds several windows and runs the batch an 8-window
        # volume gives
        images = os.path.join(work, "images")
        shutil.copytree(os.path.join(task_dir, "imagesTr"), images)
        large_dir = make_synthetic_task(os.path.join(work, "raw_large"),
                                        task_name="Task098_Large", shape=LARGE_SHAPE,
                                        num_cases=1, seed=SEED + 1)
        shutil.copy(os.path.join(large_dir, "imagesTr", "synth_000_0000.nii.gz"),
                    os.path.join(images, "large_000_0000.nii.gz"))
        labels = {c: os.path.join(task_dir, "labelsTr", f"{c}.nii.gz")
                  for c, _ in case_files(os.path.join(task_dir, "imagesTr"))}
        labels["large_000"] = os.path.join(large_dir, "labelsTr", "synth_000.nii.gz")

        # the model batches the main path will run: its windows per forward
        # times the mirror variants
        cases = case_files(images)
        assert [c for c, _ in cases] == sorted(labels), cases
        batches, volumes, windows = [], [], []
        for _, files in cases:
            data, _ = preprocess_for_inference(files, plans, "3d_fullres")
            volumes.append(data)
            n = len(window_grid(data.shape[:-1], patch)[2])
            windows.append(n)
            batches += [min(WINDOW_BATCH, n - i) * TTA
                        for i in range(0, n, WINDOW_BATCH)]
        assert max(windows) == 8 and min(windows) == 1, windows
        forwards, batch = len(batches), max(batches)
        model_k = unet_from_plans(plans, "3d_fullres", dtype=torch.bfloat16,
                                  deep_supervision=False,
                                  generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
        shapes = _block_shapes(model_k, patch, dev)
        n_fused = sum(f for f, _, _ in shapes)
        n_strided = len(shapes) - n_fused

        # ---- phase 1: IN + LeakyReLU kernel at the post-stride maps
        # checked at the serving path's largest batch in f32 and bf16, timed
        # (bf16, device time) at that batch and the train step's
        strided = _rows([o for f, _, o in shapes if not f])
        assert tuple((c, n, 1) for c, n in strided) == in_probe.HIPPO_FWD, strided
        timed = sorted(set(batches) | {TRAIN_BATCH})     # phase 2's batches
        in_err = 0.0
        for c, n in strided:
            for dtype in (torch.float32, torch.bfloat16):
                args = in_probe.inputs("fwd", batch, c, n, gen, dtype)
                in_err = max(in_err, _in_check("fwd", args, dev))
                del args
        assert batch == 64, batches
        in_t = _in_probe("hippo_fwd_b2", "hippo_fwd_b64")
        print(f"[phase 1] instance_norm_leaky: {n_strided} post-stride shapes ok (B={batch}: "
              f"f32 atol 1e-4; bf16 atol 3e-2 + rtol 1e-2), max err {in_err:.3e}, second "
              f"runs equal bit for bit, each launch in the form its plan gives; per forward, "
              f"bf16, device time (in_probe.py): " + "; ".join(
                  f"B={g['batch']} {_in_text(g, dev)}" for g in in_t.values()), flush=True)

        # ---- phase 2: fused conv kernel at every stride-1 shape
        # bf16 input runs the tensor-core kernel (timed at every batch of
        # the serving path and the train step, cuDNN's F.conv3d beside it),
        # f32 input the FMA kernel (timed at the largest batch, cuDNN in f32)
        fused = {}
        for f, in_shape, out_shape in shapes:
            if f:
                key = (in_shape[0], out_shape[0], in_shape[1:])
                fused[key] = fused.get(key, 0) + 1
        conv_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
        conv_ms, conv_plain_ms = dict.fromkeys(timed, 0.0), dict.fromkeys(timed, 0.0)
        conv_lib_ms = dict.fromkeys(timed, 0.0)
        fma_ms = fma_plain_ms = fma_lib_ms = 0.0
        conv_flops, conv_bytes = 0, 0
        for (cin, cout, sp), count in fused.items():
            vox = batch * math.prod(sp)
            conv_flops += count * 2 * 27 * cin * cout * vox
            conv_bytes += count * 2 * (vox * (cin + cout) + 27 * cin * cout)
            w = randn(cout, cin, 3, 3, 3) * math.sqrt(2.0 / (27 * cin))
            scale, off = randn(cout) * 0.1 + 1, randn(cout) * 0.1
            for dtype, atol, rtol in ((torch.float32, 1e-3, 0.0),
                                      (torch.bfloat16, 5e-2, 1e-2)):
                x = randn(batch, cin, *sp, dtype=dtype)
                before = _counts()
                out = conv3d_in_lrelu_cf(x, w, scale, off)
                after = _counts()
                ref = plain_conv3d_in_lrelu(x, w, scale, off)
                torch.cuda.synchronize()
                assert after["conv3d_in_lrelu"] == before["conv3d_in_lrelu"] + 1 and \
                    after["conv3d_in_lrelu_tc"] == before["conv3d_in_lrelu_tc"] + (
                        dtype == torch.bfloat16), (dtype, before, after)
                conv_err[dtype] = max(conv_err[dtype], _compare(
                    f"conv {dtype} B={batch} {cin}->{cout} {sp}", out, ref, atol, rtol))
                if dtype == torch.float32:
                    fma_ms += count * _time_ms(lambda: conv3d_in_lrelu_cf(x, w, scale, off))
                    fma_plain_ms += count * _time_ms(
                        lambda: plain_conv3d_in_lrelu(x, w, scale, off))
                    fma_lib_ms += count * _time_ms(lambda: F.conv3d(x, w, padding=1))
            del out, ref
            wb = w.to(torch.bfloat16)
            for b in timed:
                xb = x[:b]
                p_ms = _time_ms(lambda: plain_conv3d_in_lrelu(xb, w, scale, off))
                k_ms = _time_ms(lambda: conv3d_in_lrelu_cf(xb, w, scale, off))
                l_ms = _time_ms(lambda: F.conv3d(xb, wb, padding=1))
                conv_ms[b] += count * k_ms
                conv_plain_ms[b] += count * p_ms
                conv_lib_ms[b] += count * l_ms
                flops = 2 * 27 * cin * cout * b * math.prod(sp)
                bound = _bound(flops, 2 * (b * math.prod(sp) * (cin + cout) + 27 * cin * cout))
                print(f"[phase 2]   conv {cin:>3}->{cout:<3} "
                      f"{'x'.join(map(str, sp)):>9} B={b:<2} bf16 x{count}: tensor-core kernel "
                      f"{k_ms:8.3f} ms ({flops / 1e9 / k_ms:.1f} TFLOP/s, "
                      f"{bound[0] / k_ms:.3f} of its bound), plain {p_ms:8.3f} ms, cuDNN "
                      f"F.conv3d {l_ms:8.3f} ms", flush=True)
            del x, xb, wb
        conv_bound = _bound(conv_flops, conv_bytes)
        # the same work in f32 on the CUDA cores, f32 read and written
        fma_bound = _bound(conv_flops, 2 * conv_bytes, PEAK_F32_FLOPS)
        print(f"[phase 2] conv3d_in_lrelu: {len(fused)} stride-1 shapes ok (B={batch}: "
              f"f32 on the FMA kernel, atol 1e-3, max err {conv_err[torch.float32]:.3e}; bf16 "
              f"on the tensor-core kernel, atol 5e-2 + rtol 1e-2, max err "
              f"{conv_err[torch.bfloat16]:.3e}); per forward, bf16, tensor-core kernel vs "
              f"plain vs cuDNN F.conv3d alone: "
              + "; ".join(f"B={b} {conv_ms[b]:.3f} vs {conv_plain_ms[b]:.3f} vs "
                          f"{conv_lib_ms[b]:.3f} ms" for b in timed)
              + f"; B={batch} {conv_flops / 1e9 / conv_ms[batch]:.1f} TFLOP/s, "
              f"{conv_bound[0] / conv_ms[batch]:.3f} of the bound {conv_bound[0]:.3f} ms "
              f"({conv_bound[1]}); f32 FMA kernel {fma_ms:.3f} ms vs plain {fma_plain_ms:.3f} "
              f"vs cuDNN f32 {fma_lib_ms:.3f} ms, bound {fma_bound[0]:.3f} ms "
              f"({fma_bound[1]})", flush=True)

        # ---- phase 3: the full-width model, kernel route vs plain route
        model_p = unet_from_plans(plans, "3d_fullres", dtype=torch.bfloat16,
                                  deep_supervision=False, use_kernels=False).to(dev).eval()
        model_p.load_state_dict(model_k.state_dict())
        x = randn(WINDOW_BATCH, plans.num_modalities, *patch)
        res = {}
        with torch.inference_mode():
            for dtype in (torch.float32, torch.bfloat16):
                model_k.dtype = model_p.dtype = dtype
                pk = torch.softmax(model_k(x)[0], 1)
                pp = torch.softmax(model_p(x)[0], 1)
                assert bool(torch.isfinite(pk).all()), "non-finite kernel-route output"
                res[dtype] = ((pk - pp).abs().max().item(),
                              (pk.argmax(1) == pp.argmax(1)).float().mean().item())
        model_k.dtype = model_p.dtype = torch.bfloat16
        print(f"[phase 3] full U-Net {plans.num_modalities}->{model_k.num_classes} "
              f"patch {patch}, {n_fused} fused + {n_strided} strided blocks, "
              f"B={WINDOW_BATCH}: max |softmax kernel - plain| f32 "
              f"{res[torch.float32][0]:.3e} (limit 1e-3), bf16 "
              f"{res[torch.bfloat16][0]:.3e}; bf16 argmax agreement "
              f"{res[torch.bfloat16][1]:.5f} (limit 0.95)", flush=True)
        assert res[torch.float32][0] <= 1e-3 and res[torch.bfloat16][1] >= 0.95, res
        del model_k, model_p, x

        # ---- phase 4: the serving path through the CLI entry point
        results = os.path.join(work, "results")
        # the CT routes' switches stay on for every CLI from here on: at
        # hippocampus scale their gates admit no conv and no upsample
        os.environ.update({"nnUNet_raw_data_base": os.path.join(work, "raw"),
                           "nnUNet_preprocessed": pre, "RESULTS_FOLDER": results,
                           "LNN_BLOCKED_CONV": "1", "LNN_UPT_MODE": "pallas"})
        model = unet_from_plans(plans, "3d_fullres",
                                generator=torch.Generator().manual_seed(SEED))
        base = os.path.join(results, "nnUNet_ext", "3d_fullres", task,
                            f"nnUNetTrainerV2__{plans.plans_name}", "Generic_UNet",
                            "fold_0", "model_final_checkpoint")
        save_checkpoint(base, {task: model.state_dict()},
                        base_manifest(plans, "3d_fullres", model))
        argv = ["3d_fullres", "nnUNetTrainerV2", "-i", images, "-trained_on", task,
                "-window_batch", str(WINDOW_BATCH), "--device", "cuda"]
        out_main = os.path.join(work, "seg_main")
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        run_inference(argv + ["-o", out_main])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = _counts()
        expect = _expect(conv3d_in_lrelu=n_fused * forwards,
                         instance_norm_leaky=n_strided * forwards,
                         **_in_forms(dev, fwd=_at(strided, [(b, 1) for b in batches])))
        assert launches == expect, (launches, expect)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # route timing, in turns: plain, kernel, kernel, plain; the whole
        # folder, and the device path alone (sliding window on the
        # preprocessed volumes, no host pre/post-processing or export), per
        # volume
        route_s = {True: [], False: []}
        window_s = {True: [], False: []}
        for use_kernels in (False, True, True, False):
            m, _, _ = restore_model(base, dev, use_kernels=use_kernels)
            out_dir = os.path.join(work, f"seg_{'kernel' if use_kernels else 'plain'}")
            t0 = time.perf_counter()
            predict_from_folder([m], plans, "3d_fullres", images, out_dir,
                                device=dev, window_batch=WINDOW_BATCH)
            torch.cuda.synchronize()
            route_s[use_kernels].append(time.perf_counter() - t0)
            per_volume = []
            for data in volumes:
                t0 = time.perf_counter()
                predict_sliding_window(m, data, patch, plans.num_classes + 1,
                                       device=dev, window_batch=WINDOW_BATCH,
                                       output="probs_bf16")
                per_volume.append(time.perf_counter() - t0)
            window_s[use_kernels].append(per_volume)
            del m

        # the multi-window volume in f32, kernel route against plain route:
        # the fused kernels at the batch an 8-window volume gives, inside the
        # Gaussian overlap-add of the port's accumulation path
        big = windows.index(max(windows))
        probs_f32 = {}
        before = _counts()
        for use_kernels in (True, False):
            m, _, _ = restore_model(base, dev, use_kernels=use_kernels)
            m.dtype = torch.float32
            probs_f32[use_kernels] = predict_sliding_window(
                m, volumes[big], patch, plans.num_classes + 1, device=dev,
                window_batch=WINDOW_BATCH, output="probs")
            del m
        fma_serve = _fma_launches(before, _counts())
        assert fma_serve["conv3d_in_lrelu_f32"] > 0, fma_serve
        pk, pp = probs_f32[True], probs_f32[False]
        assert pk.shape == volumes[big].shape[:-1] + (plans.num_classes + 1,), pk.shape
        assert np.isfinite(pk).all() and np.allclose(pk.sum(-1), 1.0, atol=1e-4)
        multi_err = float(np.abs(pk - pp).max())
        assert multi_err <= 1e-3, multi_err

        dice, agree = [], []
        for case, files in cases:
            seg = np.asarray(read_image(os.path.join(out_main, f"{case}.nii.gz")).data)
            plain = np.asarray(read_image(os.path.join(work, "seg_plain",
                                                       f"{case}.nii.gz")).data)
            label = np.asarray(read_image(labels[case]).data)
            assert seg.shape == label.shape == np.asarray(read_image(files[0]).data).shape
            assert int(seg.max()) < plans.num_classes + 1
            dice.append(subject_metrics(seg, label, plans.num_classes + 1)["Dice"])
            agree.append(float((seg == plain).mean()))
        assert min(agree) >= 0.99, agree
        m, _, _ = restore_model(base, dev)
        _, probs, _ = predict_case([m], cases[big][1], plans, "3d_fullres", device=dev,
                                   window_batch=WINDOW_BATCH)
        assert np.isfinite(probs).all() and np.allclose(probs.sum(-1), 1.0, atol=2e-2)
        n = len(cases)

        def window_ms(use_kernels, one):
            return 1e3 * statistics.median(statistics.mean(
                t for t, w in zip(run, windows) if (w == 1) == one)
                for run in window_s[use_kernels])

        print(f"[phase 4] nnUNet_torch_inference on {n} cases (windows per volume "
              f"{windows}; {forwards} forwards, batches {sorted(set(batches))} = windows x {TTA} "
              f"mirrors): {main_s / n:.3f} s/volume (first run, {main_s:.2f} s), peak "
              f"{peak_gb:.2f} GB; warm, in turns: kernel route "
              f"{statistics.median(route_s[True]) / n:.3f} s/volume vs plain route "
              f"{statistics.median(route_s[False]) / n:.3f} s/volume (runs "
              f"{[round(s / n, 4) for s in route_s[True]]} vs "
              f"{[round(s / n, 4) for s in route_s[False]]}); sliding window alone, "
              f"kernel vs plain: 1-window volume {window_ms(True, True):.1f} vs "
              f"{window_ms(False, True):.1f} ms, 8-window volume "
              f"{window_ms(True, False):.1f} vs {window_ms(False, False):.1f} ms; "
              f"8-window volume f32 max |probs kernel - plain| {multi_err:.3e} "
              f"(limit 1e-3; its fused convs on the FMA kernel: {fma_serve}); launches "
              f"{launches} == predicted, bf16 fused convs all on the tensor-core kernel; "
              f"seg agreement with "
              f"the plain route {min(agree):.5f}; Dice (random weights, recorded) "
              f"{[[round(d, 4) for d in ds] for ds in dice]}", flush=True)

        # ---- phase 5: the backward kernels at the train step's shapes (B=2)
        # every block's InstanceNorm backward runs on its conv output (the
        # raw conv output of a fused block); every fused block but the first,
        # whose input is the data, runs the data-gradient conv
        bwd_rows, dx_convs = {}, {}
        for i, (f, in_shape, out_shape) in enumerate(shapes):
            (row,) = _rows([out_shape])
            bwd_rows[row] = bwd_rows.get(row, 0) + 1
            if f and i > 0:
                key = (in_shape[0], out_shape[0], in_shape[1:])
                dx_convs[key] = dx_convs.get(key, 0) + 1
        n_dx, n_in_bwd = sum(dx_convs.values()), sum(bwd_rows.values())
        assert n_dx == n_fused - 1 and n_in_bwd == n_fused + n_strided
        assert tuple((c, n, k) for (c, n), k in bwd_rows.items()) == in_probe.HIPPO_BWD
        b2 = TRAIN_BATCH
        # every (x, dx) dtype pair: the f32 step checks run the mixed ones
        inb_err = 0.0
        for (c, n), count in bwd_rows.items():
            for dtype in (torch.float32, torch.bfloat16):
                args = in_probe.inputs("bwd", b2, c, n, gen, dtype)
                for dx_dtype in (torch.float32, torch.bfloat16):
                    inb_err = max(inb_err, _in_check("bwd", args + (0.01, dx_dtype), dev))
                del args
        inb_t = _in_probe("hippo_bwd_b2")["hippo_bwd_b2"]
        print(f"[phase 5] instance_norm_leaky_bwd: {len(bwd_rows)} shapes ({n_in_bwd} per "
              f"step) ok (B={b2}, every (x, dx) dtype pair: dx f32 atol 1e-4 + rtol 1e-4, bf16 "
              f"atol 2e-2 + rtol 1e-2; dscale/dbias atol 1e-3 + rtol 1e-4), max err "
              f"{inb_err:.3e}, second runs equal bit for bit, each launch in the form its plan "
              f"gives; per train step, bf16, device time (in_probe.py): {_in_text(inb_t, dev)}",
              flush=True)

        dx_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
        dx_ms = dx_plain_ms = dx_lib_ms = 0.0
        dxf_ms = dxf_plain_ms = dxf_lib_ms = 0.0
        dx_flops = dx_bytes = 0
        for (cin, cout, sp), count in dx_convs.items():
            vox = b2 * math.prod(sp)
            flops, nbytes = 2 * 27 * cin * cout * vox, 2 * (vox * (cin + cout) + 27 * cin * cout)
            dx_flops += count * flops
            dx_bytes += count * nbytes
            w = randn(cout, cin, 3, 3, 3) * math.sqrt(2.0 / (27 * cin))
            for dtype, atol, rtol in ((torch.float32, 1e-3, 0.0),
                                      (torch.bfloat16, 5e-2, 1e-2)):
                dy = randn(b2, cout, *sp, dtype=dtype)
                before = _counts()
                out = conv3d_dx_cf(dy, w)
                after = _counts()
                ref = plain_conv3d_dx(dy, w)
                torch.cuda.synchronize()
                assert after["conv3d_dx"] == before["conv3d_dx"] + 1 and \
                    after["conv3d_dx_tc"] == before["conv3d_dx_tc"] + (
                        dtype == torch.bfloat16), (dtype, before, after)
                dx_err[dtype] = max(dx_err[dtype], _compare(
                    f"conv dx {dtype} B={b2} {cin}<-{cout} {sp}", out, ref, atol, rtol))
                xs = torch.empty((b2, cin) + sp, dtype=dtype, device=dev)
                wd = w.to(dtype)
                k_ms = _time_ms(lambda: conv3d_dx_cf(dy, w))
                p_ms = _time_ms(lambda: plain_conv3d_dx(dy, w))
                l_ms = _time_ms(lambda: _library_dgrad(dy, xs, wd))
                if dtype == torch.float32:
                    dxf_ms, dxf_plain_ms, dxf_lib_ms = (dxf_ms + count * k_ms,
                                                        dxf_plain_ms + count * p_ms,
                                                        dxf_lib_ms + count * l_ms)
            dx_ms, dx_plain_ms, dx_lib_ms = (dx_ms + count * k_ms, dx_plain_ms + count * p_ms,
                                             dx_lib_ms + count * l_ms)
            print(f"[phase 5]   conv dx {cin:>3}<-{cout:<3} {'x'.join(map(str, sp)):>9} "
                  f"B={b2} bf16 x{count}: tensor-core kernel {k_ms:7.3f} ms "
                  f"({flops / 1e9 / k_ms:.1f} TFLOP/s, {_bound(flops, nbytes)[0] / k_ms:.3f} "
                  f"of its bound), plain {p_ms:7.3f} ms, cuDNN dgrad {l_ms:7.3f} ms", flush=True)
            del dy, out, ref, xs, wd
        dx_bound = _bound(dx_flops, dx_bytes)
        dxf_bound = _bound(dx_flops, 2 * dx_bytes, PEAK_F32_FLOPS)
        print(f"[phase 5] conv3d_dx: {len(dx_convs)} shapes ({n_dx} per step) ok "
              f"(B={b2}: f32 on the FMA kernel, atol 1e-3, max err "
              f"{dx_err[torch.float32]:.3e}; bf16 on the tensor-core kernel, atol 5e-2 + "
              f"rtol 1e-2, max err {dx_err[torch.bfloat16]:.3e}); per train step, bf16: "
              f"tensor-core kernel {dx_ms:.3f} ms ({dx_flops / 1e9 / dx_ms:.1f} TFLOP/s, "
              f"{dx_bound[0] / dx_ms:.3f} of the bound {dx_bound[0]:.3f} ms, {dx_bound[1]}) vs "
              f"plain {dx_plain_ms:.3f} ms vs cuDNN dgrad {dx_lib_ms:.3f} ms; f32: FMA "
              f"kernel {dxf_ms:.3f} ms vs plain {dxf_plain_ms:.3f} ms vs cuDNN dgrad "
              f"{dxf_lib_ms:.3f} ms, bound {dxf_bound[0]:.3f} ms ({dxf_bound[1]})", flush=True)

        # ---- phase 6: the training path through its entry point
        # the library's defaults (TF32 in cuDNN's f32 weight gradient) while
        # training; the f32 comparison below turns TF32 off again
        torch.backends.cudnn.allow_tf32 = True
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_training("base_v2", ["3d_fullres", "-t", task, "-f", "0", "-num_epochs",
                                 str(TRAIN_EPOCHS), "-num_iters", str(TRAIN_ITERS),
                                 "-val_iters", str(VAL_ITERS), "--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = _counts()
        train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps, val_steps = TRAIN_EPOCHS * TRAIN_ITERS, TRAIN_EPOCHS * VAL_ITERS
        expect = _expect(conv3d_in_lrelu=n_fused * (steps + val_steps),
                         instance_norm_leaky=n_strided * (steps + val_steps),
                         conv3d_dx=(n_fused - 1) * steps,
                         instance_norm_leaky_bwd=(n_fused + n_strided) * steps,
                         **_in_forms(dev, fwd=_at(strided, [(b2, steps + val_steps)]),
                                     bwd=_at(_rows([o for _, _, o in shapes]),
                                             [(b2, steps)])))
        assert train_launches == expect, (train_launches, expect)
        trained = output_folder(os.path.join(results, "nnUNet_ext"), "3d_fullres", task,
                                "base_v2", plans.plans_name, 0, transfer_heads=True)
        with open(os.path.join(trained, "progress.json")) as f:
            step_losses = json.load(f)["step_losses"]
        assert len(step_losses) == steps and all(map(math.isfinite, step_losses))
        first10, last10 = statistics.mean(step_losses[:10]), statistics.mean(step_losses[-10:])
        assert last10 < first10, (first10, last10)

        served = os.path.join(work, "seg_trained")
        run_inference(["3d_fullres", "base_v2", "-i", os.path.join(task_dir, "imagesTr"),
                       "-o", served, "-trained_on", task, "--device", "cuda"])
        trained_dice = []
        for case, _ in case_files(os.path.join(task_dir, "imagesTr")):
            seg = np.asarray(read_image(os.path.join(served, f"{case}.nii.gz")).data)
            label = np.asarray(read_image(labels[case]).data)
            assert seg.shape == label.shape
            trained_dice.append(subject_metrics(seg, label, plans.num_classes + 1)["Dice"])

        # one train step from the same weights and batch on four routes, then
        # s/step in turns and each route's device time by kernel
        stage = os.path.join(pre, task, "nnUNetData_plans_v2.1_3d_fullres")
        sampler = PatchSampler(PreprocessedDataset(stage), PreprocessedDataset(stage).cases,
                               patch, b2, seed=SEED)
        host = [sampler.next_batch() for _ in range(4)]
        dev_batches = [{k: torch.from_numpy(b[k]).to(dev) for k in ("data", "seg")}
                       for b in host]
        ds_factors = tuple(ds_scale_factors(cfg.pool_op_kernel_sizes))
        step_cfg = StepConfig(ds_factors=ds_factors, batch_dice=True,
                              num_classes=plans.num_classes + 1, augment=AugmentConfig())

        def unet(dtype, use_kernels):
            return unet_from_plans(plans, "3d_fullres", dtype=dtype, use_kernels=use_kernels,
                                   generator=torch.Generator().manual_seed(SEED))

        fma_train, step_text = _step_check(unet, dev_batches[0], ds_factors, dev)
        step_s, profile = _turns(unet, dev_batches, step_cfg, dev)
        print(f"[phase 6] nnUNet_torch_train_base_v2 --device cuda, full width "
              f"{plans.num_modalities}->{plans.num_classes + 1}, patch {patch}, batch {b2}, "
              f"{TRAIN_EPOCHS} epochs x {TRAIN_ITERS} steps + {VAL_ITERS} val batches, "
              f"augmentation on: {train_s:.2f} s in all, peak {train_peak_gb:.2f} GB; "
              f"launches {train_launches} == predicted per step {{conv3d_in_lrelu: "
              f"{n_fused} (+{n_fused} per val batch), instance_norm_leaky: {n_strided} "
              f"(+{n_strided}), conv3d_dx: {n_fused - 1}, instance_norm_leaky_bwd: "
              f"{n_fused + n_strided}}}; loss first 10 steps {first10:.4f} -> last 10 "
              f"{last10:.4f}; served by nnUNet_torch_inference: Dice "
              f"{[[round(d, 4) for d in ds] for ds in trained_dice]}; {step_text}; "
              + _turns_text(step_s), flush=True)
        _print_profile(6, "train step", profile)

        # ---- phase 7: the flash-attention kernels at the ViT path's shapes
        flash = _flash_phase(randn)

        # ---- phase 8: the ViT-U-Net (V1, base) through its entry points
        # what one forward runs: every block but the bottleneck's, whose
        # output V1 replaces, and one attention per transformer block
        vit_m = vit_unet_from_plans(plans, "3d_fullres", patch, dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(SEED)).to(dev)
        attn = vit_m.vit.block0.attn
        tokens = vit_m.vit.pos_embed_0.shape[1]
        assert (attn.qkv.in_features, attn.num_heads) == (768, 12), attn
        # phase 7's train shape is the one this path gives the kernel
        assert (1, 12, tokens, 64) == FLASH_SHAPES["train"], tokens
        vit_shapes = _block_shapes(vit_m, patch, dev)
        v_fused = sum(f for f, _, _ in vit_shapes)
        v_strided = len(vit_shapes) - v_fused
        n_attn = vit_m.vit.depth
        assert (v_fused, v_strided) == (n_fused - 1, n_strided - 1), vit_shapes
        del vit_m, attn
        torch.backends.cudnn.allow_tf32 = True
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_training_vit(["3d_fullres", task, "0", "-num_epochs", str(TRAIN_EPOCHS),
                          "-num_iters", str(TRAIN_ITERS), "-val_iters", str(VAL_ITERS),
                          "--device", "cuda"])
        torch.cuda.synchronize()
        vit_train_s = time.perf_counter() - t0
        vit_train_launches = _counts()
        vit_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the ViT-U-Net trains at half the plan's batch
        vit_b = max(1, b2 // 2)
        v_rows = _rows([o for f, _, o in vit_shapes if not f])
        expect = _expect(conv3d_in_lrelu=v_fused * (steps + val_steps),
                         instance_norm_leaky=v_strided * (steps + val_steps),
                         conv3d_dx=(v_fused - 1) * steps,
                         instance_norm_leaky_bwd=(v_fused + v_strided) * steps,
                         flash_attention=n_attn * (steps + val_steps),
                         flash_attention_bwd=n_attn * steps,
                         **_in_forms(dev, fwd=_at(v_rows, [(vit_b, steps + val_steps)]),
                                     bwd=_at(_rows([o for _, _, o in vit_shapes]),
                                             [(vit_b, steps)])))
        assert vit_train_launches == expect, (vit_train_launches, expect)
        vit_fold = os.path.join(results, "nnUNet_ext", "3d_fullres", task,
                                f"nnViTUNetTrainer__{plans.plans_name}",
                                arch_dir(vit=True), "fold_0")
        with open(os.path.join(vit_fold, "model_final_checkpoint.json")) as f:
            manifest = json.load(f)
        assert manifest["use_vit"] and manifest["vit"]["type"] == "base" \
            and manifest["batch_size"] == vit_b == 1, manifest["vit"]
        with open(os.path.join(vit_fold, "progress.json")) as f:
            vit_losses = json.load(f)["step_losses"]
        assert len(vit_losses) == steps and all(map(math.isfinite, vit_losses))
        vit_first10, vit_last10 = (statistics.mean(vit_losses[:10]),
                                   statistics.mean(vit_losses[-10:]))

        _reset_counts()
        served_vit = os.path.join(work, "seg_vit")
        run_inference(["3d_fullres", "nnViTUNetTrainer", "-i",
                       os.path.join(task_dir, "imagesTr"), "-o", served_vit, "-trained_on",
                       task, "--use_vit", "--device", "cuda"])
        vit_serve_launches = _counts()
        per_case = dict(zip((c for c, _ in cases), windows))
        vit_forwards = sum(math.ceil(per_case[c] / WINDOW_BATCH)
                           for c, _ in case_files(os.path.join(task_dir, "imagesTr")))
        served_batches = [min(WINDOW_BATCH, per_case[c] - i) * TTA
                          for c, _ in case_files(os.path.join(task_dir, "imagesTr"))
                          for i in range(0, per_case[c], WINDOW_BATCH)]
        assert len(served_batches) == vit_forwards
        expect = _expect(conv3d_in_lrelu=v_fused * vit_forwards,
                         instance_norm_leaky=v_strided * vit_forwards,
                         flash_attention=n_attn * vit_forwards,
                         **_in_forms(dev, fwd=_at(v_rows, [(b, 1) for b in served_batches])))
        assert vit_serve_launches == expect, (vit_serve_launches, expect)
        vit_dice = []
        for case, _ in case_files(os.path.join(task_dir, "imagesTr")):
            seg = np.asarray(read_image(os.path.join(served_vit, f"{case}.nii.gz")).data)
            label = np.asarray(read_image(labels[case]).data)
            assert seg.shape == label.shape and int(seg.max()) < plans.num_classes + 1
            vit_dice.append(subject_metrics(seg, label, plans.num_classes + 1)["Dice"])

        # one train step of the ViT-U-Net at its batch (1) on four routes, as
        # phase 6 (V1's bottleneck gets no gradient on any), then s/step in
        # turns and each route's device time by kernel
        vit_batches = [{k: t[:1] for k, t in b.items()} for b in dev_batches]

        def vit_unet(dtype, use_kernels):
            return vit_unet_from_plans(plans, "3d_fullres", patch, dtype=dtype,
                                       use_kernels=use_kernels,
                                       generator=torch.Generator().manual_seed(SEED))

        fma_vit, vit_step_text = _step_check(vit_unet, vit_batches[0], ds_factors, dev,
                                             dead=("bottleneck",), attention=n_attn)
        vit_step_s, vit_profile = _turns(vit_unet, vit_batches, step_cfg, dev)
        print(f"[phase 8] nnUNet_torch_train_vit 3d_fullres --device cuda: V1 ViT-U-Net, "
              f"ViT base (embed 768, depth {n_attn}, 12 heads, {tokens} tokens), U-Net "
              f"{plans.num_modalities}->{plans.num_classes + 1} full width, "
              f"patch {patch}, batch 1, {TRAIN_EPOCHS} epochs x {TRAIN_ITERS} steps + "
              f"{VAL_ITERS} val batches, augmentation on: {vit_train_s:.2f} s in all, peak "
              f"{vit_peak_gb:.2f} GB; launches {vit_train_launches} == predicted per step "
              f"{{conv3d_in_lrelu: {v_fused} (+{v_fused} per val batch), "
              f"instance_norm_leaky: {v_strided} (+{v_strided}), conv3d_dx: {v_fused - 1}, "
              f"instance_norm_leaky_bwd: {v_fused + v_strided}, flash_attention: {n_attn} "
              f"(+{n_attn}), flash_attention_bwd: {n_attn}}}; loss first 10 steps "
              f"{vit_first10:.4f} -> last 10 {vit_last10:.4f}; served by "
              f"nnUNet_torch_inference --use_vit ({vit_forwards} forwards): launches "
              f"{vit_serve_launches} == predicted, Dice "
              f"{[[round(d, 4) for d in ds] for ds in vit_dice]}; {vit_step_text}; "
              + _turns_text(vit_step_s), flush=True)
        _print_profile(8, "ViT-U-Net train step", vit_profile)
        del vit_batches, dev_batches

        # ---- phases 9-10: the CT scale; the task and its plan (set-up)
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.empty_cache()
        ct_dir = make_synthetic_task(os.path.join(work, "raw", "nnUNet_raw_data"),
                                     task_name="Task096_CT", shape=CT_SHAPE, num_cases=4,
                                     seed=SEED)
        plan_and_preprocess([ct_dir], pre, configs=("3d_fullres",), verbose=False)
        ct_plans = Plans.load(plans_path(os.path.join(pre, os.path.basename(ct_dir))))
        ct_cfg = ct_plans.config("3d_fullres")
        got = {"patch_size": list(ct_cfg.patch_size), "batch_size": ct_cfg.batch_size,
               "pool_op_kernel_sizes": [list(k) for k in ct_cfg.pool_op_kernel_sizes]}
        assert got == CT_PLAN and (ct_cfg.base_num_features, ct_cfg.max_num_features) == (
            32, 320), got
        model_ct = unet_from_plans(ct_plans, "3d_fullres", dtype=torch.bfloat16,
                                   deep_supervision=False,
                                   generator=torch.Generator().manual_seed(SEED),
                                   **CT_ROUTES).to(dev).eval()
        ct_blocks = _named_blocks(model_ct, ct_cfg.patch_size, dev)

        # ---- phase 9: the copy kernels at the CT shapes
        copies = _ct_copy_phase(ct_blocks, model_ct, dev, gen)
        for name, c in copies.items():
            if name != "up_err":
                print(f"[phase 9]   {name}: {c['shapes']} shape-dtype cases equal bit for bit; "
                      f"per CT train step (B={TRAIN_BATCH}), bf16: kernel {c['ms']:.3f} ms "
                      f"({c['bound'][0] / c['ms']:.3f} of the bound {c['bound'][0]:.3f} ms, "
                      f"{c['bound'][1]}), plain {c['plain_ms']:.3f} ms, library "
                      f"{c['library_ms']:.3f} ms" + (f", octant route {c['route_ms']:.3f} ms"
                                                     if c["route_ms"] else ""), flush=True)
        pack_t = _pack_probe(ct_blocks, model_ct)
        for g in pack_t.values():
            print(f"[phase 9]   pack_blocks, bf16, device time "
                  f"({os.path.relpath(PACK_PROBE, ROOT)}), per CT "
                  f"{'train step' if g['group'] == 'ct_train' else 'serving forward'} "
                  f"(B={g['batch']}, {sum(r['count'] for r in g['shapes'])} launches, every one "
                  f"in the tma form): kernel {g['ms']:.4f} ms ({g['share']:.3f} of the bound "
                  f"{g['bound_ms']:.4f} ms, bytes), library chain {_opt(g['library_ms'], '.4f')}, "
                  f"plain {_opt(g['plain_ms'], '.4f')}; PyTorch's elementwise x * 1 "
                  f"reaches {g['copy_share']:.3f} of its own bound" + (
                      f"; the CUDA-event median above {copies['pack_blocks']['ms']:.4f} ms"
                      if g["group"] == "ct_train" else ""), flush=True)
        print(f"[phase 9] copy kernels at the CT shapes (B={TRAIN_BATCH} and B={CT_SERVE_BATCH}, "
              f"bf16 and f32) equal to their plain versions bit for bit, every pack in the tma "
              f"form; the octant upsample "
              f"against F.conv_transpose3d: max err "
              + ", ".join(f"{d} {e:.3e}".replace("torch.", "")
                          for d, e in copies["up_err"].items())
              + " (f32 atol 1e-4 + rtol 1e-4, bf16 atol 2e-2 + rtol 1e-2)", flush=True)

        ct_conv = _ct_conv_phase(ct_blocks, dev, gen)
        torch.cuda.empty_cache()
        probe = subprocess.run([sys.executable, FINISH_PROBE, "--root", ROOT,
                                "--batch", str(CT_SERVE_BATCH)], capture_output=True, text=True)
        assert probe.returncode == 0, probe.stderr[-3000:]
        finish = json.loads(probe.stdout.strip().splitlines()[-1])["per_forward"]
        assert finish["conv"] > 0 and finish["finish"] > 0, probe.stdout
        print(f"[phase 9] tensor-core conv at the CT shapes: {ct_conv['shapes']} fused convs "
              f"(B={TRAIN_BATCH} and B={CT_SERVE_BATCH}) and {ct_conv['dx_shapes']} data "
              f"gradients (B={TRAIN_BATCH}) ok, bf16 atol 5e-2 + rtol 1e-2, max err "
              f"{ct_conv['err']:.3e} / {ct_conv['dx_err']:.3e}, every launch on the "
              f"tensor-core kernel; per CT serving forward (B={CT_SERVE_BATCH}, the kernel "
              f"route's {ct_conv['shapes']} convs): kernel {ct_conv['ms']:.3f} ms "
              f"({ct_conv['flops'] / 1e9 / ct_conv['ms']:.1f} TFLOP/s, "
              f"{ct_conv['bound'][0] / ct_conv['ms']:.3f} of the bound "
              f"{ct_conv['bound'][0]:.3f} ms, {ct_conv['bound'][1]}) vs cuDNN F.conv3d "
              f"{ct_conv['lib_ms']:.3f} ms; the 128^3 and 64^3 convs of that forward by "
              f"kernel (torch.profiler, {os.path.relpath(FINISH_PROBE, ROOT)}): conv "
              f"{finish['conv']:.3f} ms, split-K reduce {finish['reduce']:.3f} ms, finish "
              f"(statistics + normalize) {finish['finish']:.3f} ms of {finish['ms']:.3f} ms",
              flush=True)

        ct_in_err, ct_in = _ct_in_phase(ct_blocks, model_ct, dev, gen)
        for name, g in ct_in.items():
            print(f"[phase 9]   IN {name}, bf16, device time (in_probe.py): {_in_text(g, dev)}",
                  flush=True)
        print(f"[phase 9] instance_norm_leaky / _bwd at the CT shapes (B={TRAIN_BATCH} forward "
              f"and backward, B={CT_SERVE_BATCH} forward; f32 and bf16) ok, max err forward "
              f"{ct_in_err['fwd']:.3e}, backward {ct_in_err['bwd']:.3e} (IN_TOL), second runs "
              f"equal bit for bit, each launch in the form its plan gives", flush=True)

        # ---- phase 10: the CT path through its entry points
        ct_paths, fma_ct = _ct_path(ct_dir, ct_plans, ct_blocks, model_ct, work, pre,
                                    results, dev)

        # ---- phase 11: a task sequence through the CL entry points
        cl_paths, seq_step_s = _sequence_path(task_dir, plans, shapes, work, pre, results, dev)

        # ---- phase 12: the regularizing and freezing trainers
        reg_paths = _regularizer_path(task_dir, plans, shapes,
                                      {"shapes": vit_shapes, "n_attn": n_attn}, work, pre,
                                      results, dev, seq_step_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    loaded = sorted({m.split(".")[0] for m, mod in sys.modules.items()
                     if mod is not None} & set(NO_JAX))
    assert not loaded, f"the port imported {loaded}"
    csrc = os.path.relpath(build.CSRC, ROOT)
    pallas = "lifelong_nnunet_tpu/ops/pallas"
    def scaled(timing, n=1):
        """(ms, plain, bound, library) of a measured (ms, plain, library,
        (bound, by)), times n"""
        ms, plain_ms, lib_ms, (bound, by) = timing
        return n * ms, n * plain_ms, (n * bound, by), n * lib_ms

    rows = [  # name, source, replaces, err, ms, plain, bound, library, per
        ("conv3d_in_lrelu_tc", "conv3d_in_lrelu.cu", f"{pallas}/conv3d.py:225",
         conv_err[torch.bfloat16], conv_ms[batch], conv_plain_ms[batch], conv_bound,
         conv_lib_ms[batch], f"forward at B={batch}, bf16, tensor cores"),
        ("conv3d_in_lrelu_f32", "conv3d_in_lrelu.cu", f"{pallas}/conv3d.py:225",
         conv_err[torch.float32], fma_ms, fma_plain_ms, fma_bound, fma_lib_ms,
         f"forward at B={batch}, f32 input, FMA kernel"),
        ("instance_norm_leaky", "instance_norm.cu", f"{pallas}/instance_norm.py:82", in_err,
         in_t["hippo_fwd_b64"]["ms"], in_t["hippo_fwd_b64"]["plain_ms"],
         (in_t["hippo_fwd_b64"]["bound_ms"], "bytes"), None, f"forward at B={batch}, device time"),
        ("conv3d_dx_tc", "conv3d_in_lrelu.cu", f"{pallas}/conv3d.py:343",
         dx_err[torch.bfloat16], dx_ms, dx_plain_ms, dx_bound, dx_lib_ms,
         f"train step at B={TRAIN_BATCH}, bf16, tensor cores"),
        ("conv3d_dx_f32", "conv3d_in_lrelu.cu", f"{pallas}/conv3d.py:343",
         dx_err[torch.float32],
         dxf_ms, dxf_plain_ms, dxf_bound, dxf_lib_ms,
         f"train step at B={TRAIN_BATCH}, f32 input, FMA kernel"),
        ("instance_norm_leaky_bwd", "instance_norm.cu", f"{pallas}/instance_norm.py:122", inb_err,
         inb_t["ms"], inb_t["plain_ms"], (inb_t["bound_ms"], "bytes"), None,
         f"train step at B={TRAIN_BATCH}, device time"),
    ] + [(f"{name}_{kind}", "flash_attention.cu", "lifelong_nnunet_tpu/models/vit.py:172",
          flash["err"][p][dtype],
          *scaled(tuple(flash[key][p][k] for k in ("ms", "plain_ms", "library_ms", "bound")),
                  n_attn),
          f"ViT-U-Net train step at B=1 ({n_attn} blocks), {what}, device time")
         for name, p in (("flash_attention", "fwd"), ("flash_attention_bwd", "bwd"))
         for kind, key, dtype, what in (
             ("tc", "train", torch.bfloat16, "bf16, tensor cores"),
             ("f32", "f32", torch.float32, "f32 input, FMA kernel"))
    ] + [(name, src, f"{pallas}/{where}", copies[name]["err"],
          *scaled(tuple(copies[name][k] for k in ("ms", "plain_ms", "library_ms", "bound"))),
          f"CT train step at B={TRAIN_BATCH}")
         for name, src, where in (("pack_blocks", "block_pack.cu", "block_pack.py:137"),
                                  ("unpack_blocks", "block_pack.cu", "block_pack.py:197"),
                                  ("interleave_up2", "interleave.cu", "interleave.py:58"),
                                  ("deinterleave2", "interleave.cu", "interleave.py:73"))]
    paths = {"serve": launches, "train": train_launches, "vit_train": vit_train_launches,
             "vit_serve": vit_serve_launches, **ct_paths, **cl_paths, **reg_paths}
    # the FMA kernel runs f32 input only, off the bf16 main paths (0
    # launches there, asserted above); its launches in the f32 checks of
    # phases 4, 6, 8 and 10 are kept apart, under ``check_launches``
    f32_checks = {"serve_f32": fma_serve, "train_f32_step": fma_train,
                  "vit_train_f32_step": fma_vit, **fma_ct}
    kernels = []
    for name, src, where, err, ms, plain_ms, bound, lib_ms, per in rows:
        kernels.append(
            {"name": name, "route": "cuda", "source": f"{csrc}/{src}",
             "replaces": where,
             "launches": sum(c[name] for c in paths.values()), "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": lib_ms, "per": per,
             "launches_by_path": {path: c[name] for path, c in paths.items()}})
        if name.endswith("_f32"):
            kernels[-1]["check_launches"] = {check: c[name] for check, c in f32_checks.items()}
        if name in IN_FORMED:
            # by the form of the launch plan; the yardstick, F.instance_norm
            # alone (or its backward), is not the same function
            kernels[-1]["launches_by_form"] = {
                form: sum(c[f"{name}.{form}"] for c in paths.values()) for form in FORMS}
            kernels[-1]["yardstick_ms"] = (in_t["hippo_fwd_b64"] if name == IN_FORMED[0]
                                           else inb_t)["yard_ms"]
        if name in ("interleave_up2", "deinterleave2"):
            # the whole upsample on the octant route, beside the library's
            kernels[-1]["route_ms"] = copies[name]["route_ms"]
        if name == "pack_blocks":
            # by device time (pack_probe.py) per CT train step, the CUDA-event
            # median beside; per CT serving forward too; launches by form
            tr, sv = pack_t["ct_train"], pack_t["ct_serve"]
            kernels[-1].update(
                ms=tr["ms"], plain_ms=tr["plain_ms"], library_ms=tr["library_ms"],
                event_ms=copies[name]["ms"], per=f"CT train step at B={TRAIN_BATCH}, device time",
                serve_ms=sv["ms"], serve_bound_ms=sv["bound_ms"],
                serve_library_ms=sv["library_ms"], serve_plain_ms=sv["plain_ms"],
                launches_by_form={form: sum(c[f"pack_blocks.{form}"] for c in paths.values())
                                  for form in block_pack.FORMS})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
