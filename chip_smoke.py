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
     window each) and one larger case (8 windows, overlap-added) through
     the volume stream, its default (the larger case's batch of 8 x 8, the
     four small cases' windows in one batch of 4 x 8); the launch
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
     and the kernel route's device time by kernel (torch.profiler); then
     moreDA's elastic deformation (``ELASTIC``: every sample displaced, the
     other moreDA defaults on): warm kernel-route steps through
     ``make_train_step`` with finite losses and the launches of as many
     steps without it, one batch's ``apply_params`` on the card against
     the CPU with the same parameters, and ``augment_batch``'s time with
     and without the field (CUDA events, in turns) and its share of the
     warm step;
  7. the flash-attention kernels (forward, and the backward's three
     kernels) against their plain versions at the ViT train step's
     (1, 12, 490, 64), serving's (8, 12, 490, 64; the stream's four
     one-window cases 32, 12, 490, 64), CT scale's (1, 12, 512, 64) and
     hd 80's (1, 16, 512, 80), f32 (on the FMA
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
     the finish); then the weight-gradient kernel against its plain version
     in f32 at the CT step's 17 stride-1 shapes (B=2), a second run bit for
     bit, and its device time per CT train step beside the plain version,
     the library's TF32 route on f32 copies that it replaced and the library
     on the bf16 tensors (lifelong_nnunet_tpu_torch/tools/wgrad_probe.py in
     a process of its own); then the InstanceNorm kernels at every CT shape
     they run at (forward at B=2 and B=64, backward at B=2; f32 and bf16) as phase 1
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
     ``nnUNet_torch_train_rehearsal`` (1 epoch of 20 steps and 2 validation
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
     20 steps and 2 validation batches per task (``-save_interval 1
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
     medians in turns, and the penalty's time;
  13. the distilling trainers and the evaluation CLIs, on the tasks of
     phases 11-12 with their settings: ``nnUNet_torch_train_lwf 3d_fullres
     -t A B C`` (a freeze phase, then a joint phase on B and C),
     ``_mib -t A B`` and, with ViT-base (V1, batch 1), ``_lwf -t A B
     --use_vit``: the launch counters of each run as the route predicts (a
     freeze step as a Sequential step; a joint step at P earlier tasks
     1 + P forwards and backwards and P forwards without grad, MiB's one
     forward without grad), every conv, dx and flash launch on the
     tensor-core kernels; the distillation term finite on every step it
     runs and > 0 after the first of each phase; the body through each
     freeze run equal to the task before's bit for bit, ``model_freezed``
     and ``lwf_phase`` in the manifests, a ``-c`` run after C training
     nothing; ``nnUNet_torch_evaluate2 ewc -trained_on A B C -use_head X``
     for each head X giving phase 12's served Dice of each task within
     1e-4; ``nnUNet_torch_evaluate`` on each stage checkpoint of EWC, LwF
     (3 x 3), MiB and phase 11's Sequential (2 x 2), the accuracy matrices
     with BWT and FWT (``cl_metrics.json``), its windows counted from
     ``window_grid`` (batch 4, 8 mirrors); ``determine_postprocessing`` on
     A, whose ``postprocessing.json`` ``nnUNet_torch_inference
     --postprocess`` applies to phase 12's served segmentation.  Recorded:
     seconds per task and phase, the LwF joint step at P = 1 and 2 beside
     a Sequential-style step (CUDA-event medians in turns), evaluation
     seconds per stage and head, peak memory;
  14. the POD trainers on the tasks of phases 11-13 with their settings
     but 15 steps a task: ``nnUNet_torch_train_plop 3d_fullres -t A B C``,
     ``_pod -t A B``,
     ``_ownm2 -t A B``, ``_ownm4 -t A B`` and, with ViT-base (V1, batch 1),
     ``_ownm1 -t A B --use_vit``: the launch counters of each run as the
     route predicts (from the second task on a step is a forward+backward
     unit and a teacher forward without grad, both capturing taps, which
     with the ViT runs V1's bottleneck stage forward; PLOP's threshold
     pass 15 teacher forwards a task; OwnM's fisher pass after each task), every
     conv, dx and flash launch on the tensor-core kernels; every step's
     loss finite, the first of each later task included (the student's
     taps equal the teacher's there) with the hippocampus bottleneck's 5x7
     tap in PLOP's and POD's sum; the POD term > 0 after that step; each
     PLOP threshold in [0.001, 1] for every deep-supervision output;
     OwnM4's pseudo iterations those its counter gives when it runs on
     across tasks (26 of B's 15-29); ``nnUNet_torch_inference plop
     -trained_on A B C -use_head X`` for each head X on its task's images
     (Dice recorded); ``nnUNet_torch_evaluate`` on each stage of PLOP (3 x
     3) and POD (2 x 2), the accuracy matrices with BWT and FWT.  Recorded:
     seconds per task, warm s/step, the threshold pass's seconds, peak
     memory, checkpoint bytes, and at C's first parameters the PLOP and POD
     steps beside a plain step (CUDA-event medians in turns), their launch
     calls, and the POD term alone (forward and backward) with its launch
     calls and its share of the PLOP step;
  15. the ViT-U-Net's other placements and its task-specific LayerNorms,
     at full width on phase 11's tasks A and B, and rematerialization:
     ``nnUNet_torch_train_vit 3d_fullres A 0 -v 2 --do_LSA --do_SPT``,
     ``-v 3`` and ``-v 4`` (ViT-base, batch 1, 1 epoch of 15 steps and 2
     validation batches) each served on one case by ``nnUNet_torch_inference
     nnViTUNetTrainer --use_vit``: the launch counters as the route predicts
     (every block runs; a flash forward and backward per transformer block
     and ViT call: 12 on V3, 4 stages x 12 = 48 on V4 at 490 tokens each, 0
     on V2, whose LSA takes the plain route; SPT's patch embedding takes 5 x
     32 channels), a finite loss that falls (the mean of the last 5 steps
     below the first 5's), the f32 step check of phase 8 on each, peak
     memory, warm s/step, and the V1 and V4 steps in turns (V1, V4, V4, V1);
     ``nnUNet_torch_train_sequential`` and ``_ewc_ln 3d_fullres -t A B
     --use_vit --task_specific_ln`` (15 steps a task, progress validation):
     launches as predicted, the sets ``ln_A`` and ``ln_B`` of every LayerNorm
     in the registry after B with the manifest's ``ln_tasks`` and
     ``active_task_idx``, Sequential's ``ln_A`` after B equal to its value
     after A under weight decay alone (an f64 recurrence, within one f32
     rounding of each tensor's largest value per step), EWC-LN's anchors of
     A on ``ln_A`` only, a ``-c`` run training nothing, and each head served
     with ``-use_head X --use_vit --task_specific_ln`` (Dice recorded);
     ``nnUNet_torch_train_multihead 3d_fullres -t A --remat`` (10 steps):
     launches as predicted, each train step's forward kernels twice (the
     recompute), then one step with and without ``remat`` from the same
     weights and batch, f32 and bf16: the loss and every gradient within the
     f32 check's limits, the forward launches doubled, the peak memory of
     both;
  16. the orchestration: ``nnUNet_torch_parameter_search 3d_fullres ewc -t A
     B -g ewc_lambda:0.1,0.4 -num_epochs 1 -num_iters 10 --device cuda``
     (two experiments in this process, each task trained on the 80:20
     split of its train cases and then validated in evaluation mode):
     launches as predicted, each experiment's CSV, the summary and
     ``best_setting.json``; the same command again trains nothing
     (``backup.json``; every counter 0); the same search with ``-n_workers
     2`` in two spawned workers sharing the card (both experiments finish,
     both workers report the card; their launches are counted in their own
     processes); ``-n_workers 2 -devices_per_exp 1`` refused before any
     worker starts; ``nnUNet_torch_plan_and_preprocess`` on a copy of task
     A's raw data (the same plan and cases) and
     ``nnUNet_torch_update_checkpoints`` (then ``_all``, back) on a copy of
     phase 15's task-LN manifests;
  17. the other configurations: (a) the ``2d`` configuration of phase 4's
     task (patch 80x56, batch 11, four pools, 32 -> 512 features; every
     conv cuDNN's, each followed by the InstanceNorm kernel at 2D shapes)
     trained by ``nnUNet_torch_train_sequential 2d --use_progress_val``
     (1 epoch of 20 steps and 2 validation batches, then the sliding
     window over the validation volumes slice by slice), served by
     ``nnUNet_torch_inference 2d`` on phase 4's folder (each volume slice by
     slice, TTA over the two in-plane axes) and scored by
     ``nnUNet_torch_evaluate 2d``: launches as predicted (the
     InstanceNorm forward and backward by form, no fused conv), a loss that
     falls, the kernel route's bf16 segmentations against the plain
     route's (>= ROUTE_AGREE_2D of voxels) and the largest case's f32
     probabilities of both (within 1e-3), the InstanceNorm kernels against
     their plain versions at every 2D shape (the forward at the train and
     serving batches, the backward at the train batch, each launch in its
     planned form), Dice recorded; (b) the volume stream: phase 4's
     folder through ``predict_from_folder`` at its default and case by case
     (``volume_batch=1``) from phase 6's trained model, in turns: launches
     as predicted, segmentations equal on >= 0.9999 of voxels, the largest
     |difference| of the bf16 probabilities and s/volume of both recorded;
     (c) the cascade: a task of two 272^3 cases (cropped to 268^3), planned
     to 3d_fullres (128^3) and 3d_lowres (128x160x160, batch 2) and
     preprocessed to both, ``nnUNet_torch_train_sequential 3d_lowres``
     (20 steps, 2 validation batches, progress validation),
     ``nnUNet_torch_prepare_cascade`` (the lowres model over both cases,
     the one-hot foreground masks appended to the fullres cases),
     ``CascadeFullResTrainer(...).train_task`` on that stage (3 input
     channels; 20 steps, 2 validation batches, progress validation) and
     ``restore_trainer`` on its checkpoint: launches as predicted per path
     (every pack in the tma form, the lowres patch's 4x5x5 block grid, the
     interleave), the one-hot channels in {0, 1}, every kernel of both
     stages against its plain version at the stages' shapes (the copy
     kernels bit for bit at B=2 and 8; the fused conv at each stride-1
     shape, the cascade's first at Cin = 3, and its data gradient at B=2;
     the InstanceNorm forward at B=2 and 8 and its backward at B=2), the
     f32 step check of phase 6 on the lowres and the cascade model on the
     CT routes (the cascade's first conv blocked at Cin = 3), seconds and
     peak memory per stage, warm s/step and the validation Dice recorded;
     then phase 17's seconds and the run's.
  18. Several devices (``_multi_device_path``): the full-width U-Net
     trained ``MULTI_STEPS`` steps (one val batch, augmentation on)
     through the trainer at data parallel 2 and at model parallel 2, two
     ranks spawned (``parallel/launch.py``, the patch gather and the
     kernels built in this process first) on ``cuda:0`` and ``cuda:1``
     over NCCL where the host has two GPUs, else both on ``cuda:0`` over
     gloo (printed, with a probe of gloo's all_reduce / all_gather /
     broadcast on CUDA tensors in f32 and bf16): each rank's launches as
     predicted (a data-parallel rank's the one-device counts at batch 1,
     a model-parallel rank's at batch 2 on half the channels), the losses
     equal on both ranks, each run's parameter update within
     ``MULTI_UPDATE_RTOL`` of one device's (bf16), the gradient
     all-reduce's ms per step, the per-rank parameter bytes under model
     parallel below ``MP_BYTES_RATIO`` of data parallel's; the fused conv,
     its data gradient and the InstanceNorm kernels against their plain
     versions at both layouts' shapes; ``predict_sliding_window_sharded``
     on phase 4's cases that pad alike over the same two device slots
     (phase 6's model): equal bit for bit to the volume stream over the
     same groups, on >= ``SHARDED_AGREE`` of voxels to the per-volume
     path; the CT task's sampler at 128^3, batch 2, native gather against
     numpy: equal batches, ms/batch of both in turns.
Phases 4, 6, 8 and 11-18 run with both switches set: at hippocampus scale
and on the 2D U-Net the gates admit nothing, so their launch counts are
those of the ordinary routes; phase 17's cascade runs the CT routes.  The
fused conv, its data gradient and flash attention (forward and backward)
count every launch and, apart, those on the tensor-core kernels: on the
main paths (bf16) every one must take them, in the f32 checks of phases
4, 6, 8, 10, 15 and 17 none.  The line
before the last is the kernels' JSON record (the U-Net's forward kernels
per forward at the serving path's largest batch, its backward kernels per
train step, the flash kernels per ViT-U-Net train step, the copy kernels
per CT train step, the pack by device time with its CUDA-event median as
``event_ms`` and its time per CT serving forward as ``serve_ms`` beside
``serve_bound_ms``; ``launches`` summed over the paths' runs, and per
path under ``launches_by_path``: ``serve``, ``train``, ``vit_train``,
``vit_serve``, ``ct_train``, ``ct_serve``, ``cl_train`` (both sequence
trainings), ``cl_serve`` (the four servings of phase 11), ``cl_reg_train``
(phase 12's five trainings and its resumed fisher pass), ``cl_reg_serve``
(the nine servings of EWC's heads), ``cl_distill_train`` (phase 13's
three trainings), ``cl_eval`` (its evaluations, the postprocessing
decision and the postprocessed serving), ``cl_pod_train`` (phase 14's five
trainings), ``cl_pod_serve`` (its servings of PLOP's heads and the
evaluations of PLOP's and POD's stages), ``vit_var_train`` /
``vit_var_serve`` (phase 15's V2, V3 and V4 runs and servings),
``vit_ln_train`` / ``vit_ln_serve`` (its task-LN sequences, their ``-c``
run and servings), ``remat_train`` (its ``--remat`` run),
``param_search`` (phase 16's search in this process), ``2d_train`` /
``2d_serve`` (phase 17's 2d training; its serving and evaluation),
``stream_serve`` (its four stream / per-case servings), ``lowres_train``,
``cascade_prepare`` and ``cascade_train`` (the cascade's training and its
validation), ``dp2_train.rank{0,1}`` / ``mp2_train.rank{0,1}`` (phase 18's
ranks, counted in their own processes) and ``sharded_serve``; the two
kernels of the fused
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
predicts); the weight gradient's row, ``conv3d_wgrad``, counts its
launches on the kernel (bf16 at stride 1; f32 input and stride 2 take the
library and count nothing), its error relative to max |plain|, with
``tf32_route_ms``, the library route it replaced; the last line is ``{"ok": true,
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

from lifelong_nnunet_tpu_torch.data.augment import (  # noqa: E402
    AugmentConfig, apply_params, augment_batch, draw_params)
from lifelong_nnunet_tpu_torch.data.dataset import (  # noqa: E402
    PreprocessedDataset, final_splits, param_search_split)
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler  # noqa: E402
from lifelong_nnunet_tpu_torch.device import resolve_device  # noqa: E402
from lifelong_nnunet_tpu_torch.evaluation.cl_metrics import (  # noqa: E402
    cl_report, mean_dice_of, write_cl_report)
from lifelong_nnunet_tpu_torch.evaluation.metrics import subject_metrics  # noqa: E402
from lifelong_nnunet_tpu_torch.inference.postprocessing import (  # noqa: E402
    determine_postprocessing, load_postprocessing)
from lifelong_nnunet_tpu_torch.inference.predict import (  # noqa: E402
    case_files, predict_case, predict_from_folder, preprocess_for_inference,
    remove_all_but_largest_component)
from lifelong_nnunet_tpu_torch.inference.cascade import CascadeFullResTrainer  # noqa: E402
from lifelong_nnunet_tpu_torch.inference.sliding_window import (  # noqa: E402
    predict_sliding_window, predict_sliding_window_multi, window_grid)
from lifelong_nnunet_tpu_torch.models.unet import (  # noqa: E402
    ConvNormAct, ds_scale_factors, unet_from_plans)
from lifelong_nnunet_tpu_torch.models.vit_unet import vit_unet_from_plans  # noqa: E402
from lifelong_nnunet_tpu_torch.data import native as native_gather  # noqa: E402
from lifelong_nnunet_tpu_torch.inference.sliding_window import (  # noqa: E402
    predict_sliding_window_sharded)
from lifelong_nnunet_tpu_torch.parallel.launch import backend_for, spawn  # noqa: E402
from lifelong_nnunet_tpu_torch.parallel.mesh import param_bytes  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels import build  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels import block_pack  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels import interleave  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.kernels.attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_fwd, plain_attention_bwd,
    plain_attention_fwd)
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import (  # noqa: E402
    conv3d_dx_cf, conv3d_in_lrelu_cf, conv3d_weight_grad, plain_conv3d_dx,
    plain_conv3d_in_lrelu, plain_conv3d_weight_grad)
from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (  # noqa: E402
    FORMS, card_limits, instance_norm_leaky_bwd_cf, instance_norm_leaky_cf, launch_plan,
    plain_instance_norm_leaky, plain_instance_norm_leaky_bwd)
from lifelong_nnunet_tpu_torch.models.multihead import name_filter_mask  # noqa: E402
from lifelong_nnunet_tpu_torch.ops.cl_losses import (  # noqa: E402
    QuadraticPenalty, local_pod_loss, pod_regions, pod_scales)
from lifelong_nnunet_tpu_torch.ops.losses import deep_supervision_loss  # noqa: E402
from lifelong_nnunet_tpu_torch.planning.plans import Plans, plans_path  # noqa: E402
from lifelong_nnunet_tpu_torch.run import prepare_cascade  # noqa: E402
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess  # noqa: E402
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import (  # noqa: E402
    main as plan_and_preprocess_main)
from lifelong_nnunet_tpu_torch.run.run_param_search import run_param_search  # noqa: E402
from lifelong_nnunet_tpu_torch.run.run_evaluation import (  # noqa: E402
    run_evaluation, run_evaluation2_cli)
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference  # noqa: E402
from lifelong_nnunet_tpu_torch.run.run_training import (  # noqa: E402
    METHOD_ARGS, output_folder, run_training, trainer_name)
from lifelong_nnunet_tpu_torch.run.run_training_vit import run_training_vit  # noqa: E402
from lifelong_nnunet_tpu_torch.scripts import update_checkpoints  # noqa: E402
from lifelong_nnunet_tpu_torch.tools import in_probe  # noqa: E402
from lifelong_nnunet_tpu_torch.tools import pack_probe  # noqa: E402
from lifelong_nnunet_tpu_torch.tools.flash_probe import device_ms  # noqa: E402
from lifelong_nnunet_tpu_torch.training import checkpoints as checkpoint_io  # noqa: E402
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
from lifelong_nnunet_tpu_torch.training.trainers.own import OwnM4Trainer  # noqa: E402
from lifelong_nnunet_tpu_torch.training.trainers.plop import PLOPTrainer  # noqa: E402
from lifelong_nnunet_tpu_torch.training.trainers.rehearsal import RehearsalTrainer  # noqa: E402
from lifelong_nnunet_tpu_torch.training.trainers.rw import RWTrainer  # noqa: E402
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image  # noqa: E402
from lifelong_nnunet_tpu_torch.utilities.synthetic import make_synthetic_task  # noqa: E402

WINDOW_BATCH = 8                 # the CLI's default
VOLUME_BATCH = 8                 # the serving CLI's default volume stream
STEP_REPS = 5                    # timed train steps per route and turn
PROFILE_STEPS = 5                # profiled kernel-route train steps
TTA = 8                          # mirror combos over 3 axes
SEED = 0
SMALL_SHAPE = (60, 84, 60)       # hippocampus scale: crops to one patch
LARGE_SHAPE = (84, 120, 84)      # crops to 80x116x80: a 2x2x2 window grid
TRAIN_BATCH = 2                  # the plan's batch
TRAIN_EPOCHS, TRAIN_ITERS, VAL_ITERS = 2, 60, 4
VIT_TRAIN_ITERS = 30             # phase 8's steps an epoch (cut from 60 for time)
# one f32 train step's worst gradient |diff| from the f64 plain route, in
# units of 1e-5 + 1e-3 of each gradient's scale: the limit both f32 routes
# must meet and the bf16 control must exceed.  On an H100 80GB HBM3 (700 W)
# both f32 routes read 6.09 and the bf16 kernel route 78.2 (PERF.md)
F32_GRAD_LIMIT = 10.0
# phase 6's elastic deformation: every sample displaced, the other moreDA
# defaults on; warm steps on the kernel route, and the card's augmentation
# against the CPU's on one batch (data within 1e-4 and seg equal on all but
# that share of voxels: a coordinate within roundoff of a voxel border)
ELASTIC = AugmentConfig(do_elastic=True, p_eldef=1.0)
ELASTIC_STEPS = 3
ELASTIC_OFF = 1e-3
# flash attention (phase 7): the train step's shape (ViT-base on the
# hippocampus plan's first skip, 56x80x56 -> a 7x10x7 grid of patch 8), the
# serving path's (8 mirrors of one window; the volume stream's 4 one-window
# cases x 8 mirrors), CT scale (128^3 -> 16^3 patches)
# and the huge preset's head dim; limits (atol, rtol) against the plain
# versions on the same inputs
FLASH_SHAPES = {"train": (1, 12, 490, 64), "serve": (8, 12, 490, 64),
                "stream": (32, 12, 490, 64), "CT": (1, 12, 512, 64),
                "hd80": (1, 16, 512, 80)}
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
# the task sequence (phase 11): steps and validation batches per task (cut
# from 30 to keep the whole run inside its time limit), the progress
# validation's window batch (the trainer's)
SEQ_ITERS, SEQ_VAL_ITERS, SEQ_WINDOW_BATCH = 20, 2, 4
# the regularizing trainers (phase 12): its third task, made like task B,
# and the limit on the penalty's (and its gradient's) relative difference
# between the card and the CPU from one checkpoint
REG_TASK_C = dict(task_name="Task099_SynthC", shape=SMALL_SHAPE, num_cases=4, seed=11,
                  intensity_shift=-0.6)
PENALTY_RTOL = 1e-5
# the distilling trainers (phase 13): their terms in the train step's
# metrics; evaluator2's Dice against phase 12's served Dice
DISTILL_TERMS = ("lwf_distill", "mib")
EVAL2_DICE_TOL = 1e-4
# the POD trainers (phase 14): steps per task (half of phases 11-13's, to
# keep the script's time), their terms in the train step's metrics, and
# OwnM4's pseudo iterations on task B (its counter runs on across tasks:
# B sees iterations POD_ITERS .. 2 POD_ITERS - 1, every 13th a pseudo one)
POD_ITERS = 15
POD_TERMS = ("pod", "plop_pseudo", "mib_kd", "pseudo_mse", "ewc_penalty")
OWNM4_PSEUDO = [i for i in range(POD_ITERS, 2 * POD_ITERS) if i % 13 == 0]
DIRECT_ROUTES = {"blocked_conv": False, "upsample": "direct"}
# the ViT variants and task-specific LayerNorms (phase 15): each variant's
# flags, the steps of its run, of a task of the task-LN sequences and of
# the --remat run; the parameter search's steps a task (phase 16)
VIT_VARIANTS = {"V2": ("--do_LSA", "--do_SPT"), "V3": (), "V4": ()}
VAR_ITERS, LN_ITERS, REMAT_ITERS, SEARCH_ITERS = 15, 15, 10, 10
# the checkpoints phases 15-16 write to disk (the others stay in memory)
FINAL = ("model_final_checkpoint",)
# the other nnU-Net configurations (phase 17): the 2d plan of phase 4's task
# and its steps; the cascade's task (two cases of 272^3, cropped to 268^3,
# which the planner gives a 3d_lowres configuration), the two plans it
# gives and the steps of each stage
PLAN_2D = {"patch_size": [80, 56], "batch_size": 11,
           "pool_op_kernel_sizes": [[2, 2], [2, 2], [2, 2], [2, 1]]}
CFG2D_ITERS = 20
CASCADE_TASK = dict(task_name="Task095_Cascade", shape=(272, 272, 272), num_cases=2, seed=3)
CASCADE_PLANS = {"3d_fullres": {"patch_size": [128, 128, 128], "batch_size": 2},
                 "3d_lowres": {"patch_size": [128, 160, 160], "batch_size": 2}}
CASCADE_ITERS, CASCADE_VAL_ITERS = 20, 2
# the lowres patch's block grid on the blocked route (bs 32 on 128x160x160),
# and the kernels both cascade trainings must launch
CASCADE_GRID = (4, 5, 5)
CASCADE_KERNELS = ("conv3d_in_lrelu", "conv3d_dx", "instance_norm_leaky",
                   "instance_norm_leaky_bwd", "pack_blocks", "unpack_blocks", "interleave_up2",
                   "deinterleave2")
# the stream's segmentations against the per-case path's, and the 2d
# configuration's kernel route's against its plain route's in bf16 (share
# of voxels; the second pair rounds differently: after 20 steps 0.99965-
# 0.99969 of voxels agreed on an H100 80GB HBM3, 700 W).  The plain route's
# InstanceNorm normalizes in bf16 and moves ~10% of its outputs by more
# than one ulp at every layer, the kernel within one ulp of its plain
# version; every voxel that flips lies within 16 bf16 ulps of a tie
# (tools/route2d_probe.py, PERF.md)
STREAM_AGREE = 0.9999
ROUTE_AGREE_2D = 0.999
# the multi-device paths (phase 18): train steps of each run, validation
# batches, the bf16 tolerance on a rank's parameter update against one
# device's (|d2 - d1| / |d1| over every parameter), the least share of
# voxels on which the sharded serving agrees with the per-volume path (its
# shards equal the volume stream over the same groups bit for bit; the
# per-volume path runs other batches, so bf16 near ties may flip), the
# per-rank parameter bytes under model_parallel 2 against data parallel, and
# the patch gather's batches (the CT patch) timed native vs numpy
MULTI_STEPS = 3
MULTI_VAL = 1
MULTI_VIT_ATTN = 12              # ViT-base's blocks: a flash launch each per pass
MULTI_UPDATE_RTOL = 5e-2
# the checkpoints phase 18 writes to disk (the update check reads them; the
# others stay in memory)
MULTI_KEEP = ("before_training", "model_final_checkpoint")
SHARDED_AGREE = 0.999
MP_BYTES_RATIO = 0.62
GATHER_BATCHES = 6
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
           "conv3d_wgrad": conv3d_weight_grad,
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


class _ModelCache:
    """While active, ``unet_from_plans`` and ``vit_unet_from_plans`` (in
    every module of the port that calls them, and here) return a copy of
    the model they built before from the same arguments and the same
    generator state, and leave the generator in the state that building it
    left: the same parameters bit for bit, without drawing them again.
    Drawing a ViT-base's 114M seeded parameters takes seconds of one CPU
    core, and the script builds such models tens of times (each trainer,
    each restore, the four routes of each step check, each turn).  The
    parameters (f32) do not depend on ``ROUTE`` (the dtype and the
    routes), which only set attributes that the forward reads: a model
    asked for in another dtype or route is a copy of one built in another,
    with those attributes set.  A model is kept as its ``torch.save`` bytes in
    memory and copied by ``torch.load``; the least recently used are
    dropped past ``max_bytes``.  A call that passes its generator by
    position is not cached."""

    MODULES = ("lifelong_nnunet_tpu_torch.models.unet",
               "lifelong_nnunet_tpu_torch.models.vit_unet",
               "lifelong_nnunet_tpu_torch.training.trainer",
               "lifelong_nnunet_tpu_torch.training.restore", __name__)
    ROUTE = ("dtype", "use_kernels", "blocked_conv", "upsample")

    def __init__(self, max_bytes=24e9):
        self.max_bytes = max_bytes
        self.models = {}     # key without ROUTE -> (saved model, generator state after, bytes)
        self.hits = self.misses = 0
        self._saved = []

    @staticmethod
    def _bind(fn, args, kwargs):
        """The call's arguments by name, the defaults filled in and the
        ones the builders take from the plans resolved as they do."""
        code = fn.__code__
        names = code.co_varnames[:code.co_argcount]
        defaults = fn.__defaults__ or ()
        bound = dict(zip(names[len(names) - len(defaults):], defaults))
        bound.update(zip(names, args))
        bound.update((k, v) for k, v in kwargs.items() if k in names)
        bound["overrides"] = {k: v for k, v in kwargs.items() if k not in names}
        plans = bound.pop("plans")
        cfg = plans.config(bound["config_name"])
        bound["in_channels"] = bound["in_channels"] or plans.num_modalities
        for k in ("base_num_features", "max_num_features"):
            bound[k] = bound[k] or getattr(cfg, k)
        if "patch_size" in bound:
            bound["patch_size"] = tuple(bound["patch_size"] or cfg.patch_size)
        bound["plans"] = (plans.num_modalities, plans.num_classes, repr(cfg))
        return bound

    def _wrap(self, fn):
        def build(*args, **kwargs):
            if any(isinstance(a, torch.Generator) for a in args):
                return fn(*args, **kwargs)
            bound = self._bind(fn, args, kwargs)
            gen = bound.pop("generator")
            route = {k: bound.pop(k) for k in self.ROUTE}
            key = (fn.__name__, repr(sorted(bound.items())),
                   None if gen is None else bytes(gen.get_state().numpy()))
            if key not in self.models:
                self.misses += 1
                model = fn(*args, **kwargs)
                buf = tempfile.SpooledTemporaryFile(max_size=1 << 40)   # stays in memory
                torch.save(model, buf)
                self.models[key] = (buf, None if gen is None else gen.get_state(), buf.tell())
                while sum(n for _, _, n in self.models.values()) > self.max_bytes:
                    self.models.pop(next(iter(self.models)))[0].close()
                return model
            self.hits += 1
            entry = self.models.pop(key)
            self.models[key] = entry                    # the most recently used
            buf, state, _ = entry
            if gen is not None:
                gen.set_state(state)
            buf.seek(0)
            model = torch.load(buf, weights_only=False)
            for m in model.modules():
                for k, v in route.items():
                    if hasattr(m, k):
                        setattr(m, k, v)
            return model
        return build

    def __enter__(self):
        for mod_name in self.MODULES:
            mod = sys.modules[mod_name]
            for name in ("unet_from_plans", "vit_unet_from_plans"):
                if hasattr(mod, name):
                    self._saved.append((mod, name, getattr(mod, name)))
        wrapped = {name: self._wrap(fn) for _, name, fn in self._saved}
        for mod, name, _ in self._saved:
            setattr(mod, name, wrapped[name])
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        for buf, _, _ in self.models.values():
            buf.close()
        self._saved, self.models = [], {}


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
# dscale / dbias against the plain version's steps in f64
IN_TOL = {"fwd": {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 1e-2)},
          "bwd": {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}}
IN_STAT_TOL = (1e-3, 1e-4)
# the backward's LeakyReLU branch at an input within this much of 0 (in f64)
# is a tie within f32 roundoff: the kernel and its plain version compute
# that input in different orders and may take either branch, which moves
# that element's dx and its channel's dscale and dbias by ~|g| (phase 9's
# (2, 32, 2097152) f32 backward once read dx 0.31 and dbias 0.55 off; every
# such element lay within 4.5e-9 of 0, a few f32 ulps of its terms)
IN_TIE = 1e-6
# the InstanceNorm's device time, in a process of its own (see _in_probe)
IN_PROBE = os.path.join(ROOT, "lifelong_nnunet_tpu_torch", "tools", "in_probe.py")
CT_IN_GROUPS = ("ct_fwd_b2", "ct_fwd_b64", "ct_bwd_b2")


def _in_check(direction, args, dev, chunk=None) -> float:
    """Two launches of the InstanceNorm kernel on ``args`` (in_probe.inputs,
    and for the backward optionally alpha and dx's dtype): each counted
    under the form the launch plan predicts for its shape on this card, the
    second equal to the first bit for bit, the first against the plain
    version within IN_TOL (the forward's per batch slice of ``chunk``
    items where given; dscale and dbias against its steps in f64 within
    IN_STAT_TOL).  Returns the largest |kernel - plain| of the output
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
        tie, flip = _in_bwd_ties(*args), None
        if bool(tie.any()):
            # the ties where the kernel's dx is the other branch's: the plain
            # version takes that branch there too, for dx, dscale and dbias
            dx, other = out[0].float(), _in_bwd_flipped(*args, flip=tie)[0].float()
            flip = tie & ((dx - other).abs() < (dx - ref[0].float()).abs())
            moved = int(flip.sum())
            if moved:
                print(f"[IN tie] {what}: {moved} of {int(tie.sum())} elements within "
                      f"{IN_TIE} of 0 took the kernel's LeakyReLU branch", flush=True)
            ref = _in_bwd_flipped(*args, flip=flip)
            del dx, other
        del tie
        err = _compare(what + " dx", out[0], ref[0], *IN_TOL["bwd"][out[0].dtype])
        del ref
        # dscale and dbias each sum B*N products: held to the plain version's
        # steps in f64, since its f32 sums carry roundoff of the limit's order
        # (up to 1e-3 at B*N = 6.5M, against the kernel's own 1-3e-3)
        ref64 = _in_bwd_flipped(*args, flip=flip, acc=torch.float64)
        for o, r, stat in zip(out[1:], ref64[1:], ("dscale", "dbias")):
            _compare(f"{what} {stat} (against f64)", o.double(), r, *IN_STAT_TOL)
        return err
    err = 0.0
    for b0, b1 in _chunks(B, chunk or B):
        err = max(err, _compare(f"{what} [{b0}:{b1}]", out[b0:b1],
                                plain_instance_norm_leaky(x[b0:b1], *args[1:3]),
                                *IN_TOL["fwd"][x.dtype]))
    return err


def _in_bwd_ties(x, scale, bias, mean, rstd, *_):
    """The elements of ``x [B, C, N]`` whose LeakyReLU input lies within
    IN_TIE of 0 (computed in f64)."""
    bc = (slice(None), slice(None), None)
    y = (x.double() - mean.double()[bc]) * rstd.double()[bc] * scale.double()[:, None] \
        + bias.double()[:, None]
    return y.abs() < IN_TIE


def _in_bwd_flipped(x, scale, bias, mean, rstd, g, alpha=0.01, dx_dtype=None, *, flip,
                    acc=torch.float32):
    """plain_instance_norm_leaky_bwd's steps on ``x [B, C, N]`` in ``acc``
    with the other LeakyReLU branch taken at ``flip`` (None: nowhere):
    (dx, dscale, dbias).  The branch is the f32 plain version's in any
    ``acc``, so ``flip`` means the same in f64."""
    bc = (slice(None), slice(None), None)
    n = float(x.shape[2])
    xhat = (x.float() - mean[bc]) * rstd[bc]
    y = xhat * scale.float()[:, None] + bias.float()[:, None]
    passes = y >= 0 if flip is None else (y >= 0) ^ flip
    del y
    if acc != torch.float32:
        xhat = (x.to(acc) - mean.to(acc)[bc]) * rstd.to(acc)[bc]
    gf = g.to(acc)
    dy = torch.where(passes, gf, alpha * gf)
    del passes
    dscale = (dy * xhat).sum(dim=2).sum(dim=0)
    dbias = dy.sum(dim=2).sum(dim=0)
    dxhat = dy * scale.to(acc)[:, None]
    del dy, gf
    m1 = dxhat.sum(dim=2, keepdim=True) / n
    m2 = (dxhat * xhat).sum(dim=2, keepdim=True) / n
    dx = rstd.to(acc)[bc] * (dxhat - m1 - xhat * m2)
    return dx.to(dx_dtype or x.dtype), dscale, dbias


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


def _elastic_check(make_model, batches, step_cfg, shapes, dev) -> tuple:
    """Phase 6's elastic deformation (``ELASTIC``): ELASTIC_STEPS warm bf16
    steps on the kernel route through ``make_train_step`` (finite losses,
    the launches of as many steps without it), one batch's ``apply_params``
    on the card against the CPU with the same parameters, and
    ``augment_batch``'s time with and without the field (CUDA events, in
    turns) beside the warm step's.  Returns (the steps' launches, the
    readings)."""
    torch.backends.cudnn.allow_tf32 = True
    m = make_model(torch.bfloat16, True).to(dev)
    opt = PolySGD(m.parameters(), max_epochs=TRAIN_EPOCHS, iters_per_epoch=TRAIN_ITERS)
    cfg = StepConfig(ds_factors=step_cfg.ds_factors, batch_dice=step_cfg.batch_dice,
                     num_classes=step_cfg.num_classes, augment=ELASTIC)
    train_step = make_train_step(m, opt, cfg,
                                 generator=torch.Generator(device=dev).manual_seed(SEED))
    train_step({}, batches[0])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses = [train_step({}, batches[i % len(batches)])[1]["loss"]
              for i in range(ELASTIC_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / ELASTIC_STEPS * 1e3
    launches = _counts()
    losses = [x.item() for x in losses]
    del m, opt, train_step
    assert all(map(math.isfinite, losses)), losses
    assert launches == _train_expect(dev, shapes, TRAIN_BATCH, ELASTIC_STEPS, 0, []), launches

    data, seg = batches[0]["data"], batches[0]["seg"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = draw_params(data.shape[0], data.dim() - 2, ELASTIC, gen, dev,
                         patch=tuple(data.shape[2:]))
    noise = torch.randn(data.shape, generator=gen, device=dev)
    assert bool(params["do_elastic"].all()), params["do_elastic"]
    card_d, card_s = apply_params(data, seg, params, ELASTIC, noise)
    t0 = time.perf_counter()
    cpu_d, cpu_s = apply_params(data.cpu(), seg.cpu(), {k: v.cpu() for k, v in params.items()},
                                ELASTIC, noise.cpu())
    cpu_s_time = time.perf_counter() - t0
    assert bool(torch.isfinite(card_d).all()) and card_s.dtype == seg.dtype
    d_off = ((card_d.cpu() - cpu_d).abs() > 1e-4).float().mean().item()
    s_off = (card_s.cpu() != cpu_s).float().mean().item()
    moved = (cpu_s != seg.cpu()).float().mean().item()
    assert d_off <= ELASTIC_OFF and s_off <= ELASTIC_OFF, (d_off, s_off)

    aug_ms = {"moreDA": [], "elastic": []}
    for name in ("moreDA", "elastic", "elastic", "moreDA"):
        aug = ELASTIC if name == "elastic" else AugmentConfig()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        aug_ms[name].append(_time_ms(lambda: augment_batch(data, seg, aug, gen)))
    el_ms, da_ms = (statistics.median(aug_ms[k]) for k in ("elastic", "moreDA"))
    text = (f"elastic deformation (do_elastic, p_eldef 1.0, magnitude "
            f"{ELASTIC.elastic_magnitude}, grid {ELASTIC.elastic_grid}, the other moreDA "
            f"defaults on): {ELASTIC_STEPS} warm kernel-route bf16 steps, losses "
            f"{[round(x, 4) for x in losses]}, {step_ms:.2f} ms/step, launches {launches} == "
            f"predicted ({ELASTIC_STEPS} steps without it); one batch's apply_params card vs "
            f"CPU ({cpu_s_time:.2f} s on the CPU): data off by > 1e-4 on {d_off:.3e} of "
            f"voxels, seg off on {s_off:.3e} (limit {ELASTIC_OFF} each; {moved:.3f} of the "
            f"seg moved); augment_batch at {tuple(data.shape)} by CUDA events, in turns: "
            f"elastic {el_ms:.3f} ms {[round(x, 3) for x in aug_ms['elastic']]} vs moreDA "
            f"default {da_ms:.3f} ms {[round(x, 3) for x in aug_ms['moreDA']]}, "
            f"{el_ms / step_ms:.4f} of the elastic warm step; {_card()}")
    return launches, text


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


def _ct_copy_phase(blocks, model, dev, gen, batches=(TRAIN_BATCH, CT_SERVE_BATCH),
                   timed=True) -> dict:
    """Phase 9: the four copy kernels against their plain versions, bit for
    bit, at every shape of the CT train step (B=2; bf16 and f32) and of CT
    serving (B=64; bf16, and f32 where it fits CT_F32_BYTES), the plain
    versions taken in batch chunks of 8 items at B=64; the octant route
    against F.conv_transpose3d at the same shapes; with ``timed``, bf16
    medians per train step of the kernel, its plain version, the library
    call and, for the interleaves, the octant route beside
    F.conv_transpose3d.  Phase 17 gives its own ``batches`` (the train
    batch first).  Returns {kernel: {"ms", "plain_ms", "library_ms",
    "route_ms", "bound", "err", "shapes"}}."""
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

    for batch in batches:
        work = _ct_work(blocks, model, batch)
        train = batch == TRAIN_BATCH
        timing = timed and train
        for (x_shape, bs), (f, b) in work["pack"].items():
            grid = tuple(s // bs for s in x_shape[2:])
            per_item = math.prod(grid)
            out_numel = batch * per_item * x_shape[1] * (bs + 2) ** 3
            for dtype in (torch.float32, torch.bfloat16):
                if not train and dtype == torch.float32 and \
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
                if timing and dtype == torch.bfloat16:
                    assert torch.equal(_library_pack(x, bs), out)
                    add("pack_blocks", f + b, 2 * (x.numel() + out.numel()),
                        lambda: block_pack.pack_blocks(x, bs),
                        lambda: block_pack.plain_pack_blocks(x, bs),
                        lambda: _library_pack(x, bs))
                del x, out
        for (y_shape, grid), (f, b) in work["unpack"].items():
            per_item = math.prod(grid)
            for dtype in (torch.float32, torch.bfloat16):
                if not train and dtype == torch.float32 and \
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
                if timing and dtype == torch.bfloat16:
                    assert torch.equal(_library_unpack(y, batch, grid), out)
                    add("unpack_blocks", f + b, 2 * (y.numel() + out.numel()),
                        lambda: block_pack.unpack_blocks(y, batch, grid),
                        lambda: block_pack.plain_unpack_blocks(y, batch, grid),
                        lambda: _library_unpack(y, batch, grid))
                del y, out
        for (h_shape, w_shape), (f, b) in work["ileave"].items():
            for dtype, atol, rtol in ((torch.float32, 1e-4, 1e-4),
                                      (torch.bfloat16, 2e-2, 1e-2)):
                if not train and dtype == torch.float32 and \
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
                if timing and dtype == torch.bfloat16:
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


def _ct_conv_phase(blocks, dev, gen, batches=(TRAIN_BATCH, CT_SERVE_BATCH),
                   dx_batch=TRAIN_BATCH) -> dict:
    """Phase 9, the tensor-core conv at CT scale: the fused forward at every
    stride-1 (Cin, Cout, spatial) of the CT U-Net (the ordinary kernel
    route runs all of them) at the train batch (2) and the serving batch
    (64), and its data gradient at the train batch (``dx_batch``) for every
    block but the first, bf16, against the plain versions with phases 2 and 5's limits
    (atol 5e-2 + rtol 1e-2; at B=64 the plain version per 8 batch items:
    the statistics are per item), each launch counted on the tensor-core
    kernel.  Per shape at B=64: the kernel's and cuDNN's F.conv3d medians.
    Phase 17 gives its own ``batches``.  Returns per-forward sums at B=64
    (counts of the kernel route) and the largest errors."""
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
        for batch in batches:
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
            dy = rand((dx_batch, cout) + sp, torch.bfloat16)
            out = counted("conv3d_dx", lambda: conv3d_dx_cf(dy, w))
            res["dx_err"] = max(res["dx_err"], _compare(
                f"CT conv dx bf16 B={dx_batch} {cin}<-{cout} {sp}", out,
                plain_conv3d_dx(dy, w), 5e-2, 1e-2))
            del dy, out
    res["dx_shapes"] = sum(dx.values())
    res["bound"] = _bound(res["flops"], res.pop("bytes"))
    return res


WGRAD_PROBE = os.path.join(ROOT, "lifelong_nnunet_tpu_torch", "tools", "wgrad_probe.py")


def _ct_wgrad_phase(blocks, dev, gen) -> dict:
    """Phase 9, the weight-gradient kernel at CT scale: at every stride-1
    (Cin, Cout, spatial) of the CT U-Net (the 17 of the train step,
    ``wgrad_probe.CT``) at the train batch, bf16 x and dy against the plain
    version in f32 (TF32 off) on the same inputs: every product is exact in
    f32 on both sides, and the kernel's sums run on the tensor cores, up to
    ~8000 k16 additions a partial that are not rounded to nearest, so
    |kernel - plain| <= 5e-4 max|plain| (8000 x 2^-24 = 4.8e-4;
    tests/test_torch_conv3d_wgrad.py); a second run equal bit for bit; each
    launch counted on the kernel.  Then, from wgrad_probe.py in a process of
    its own, the device time per CT train step of the kernel, of the plain
    version, of the library's TF32 weight gradient on f32 copies (the route
    it replaced) and of the library on the bf16 tensors, and the bound.
    Returns the largest error and the probe's sums."""
    from lifelong_nnunet_tpu_torch.tools import wgrad_probe
    shapes = sorted((in_shape[0], out_shape[0], in_shape[1:])
                    for _, m, in_shape, out_shape in blocks if m.conv.stride == (1, 1, 1))
    assert shapes == sorted(wgrad_probe.CT), shapes
    torch.backends.cudnn.allow_tf32 = False
    err = 0.0
    for cin, cout, sp in shapes:
        x, w, dy = wgrad_probe.inputs(dev, gen, TRAIN_BATCH, cin, cout, sp)
        before = _counts()
        got = conv3d_weight_grad(x, w, dy)
        after = _counts()
        assert after["conv3d_wgrad"] == before["conv3d_wgrad"] + 1, (before, after)
        assert torch.equal(got, conv3d_weight_grad(x, w, dy)), (cin, cout, sp)
        ref = plain_conv3d_weight_grad(x, w, dy)
        gap = (got - ref).abs().max().item() / ref.abs().max().item()
        assert bool(torch.isfinite(got).all()) and gap <= 5e-4, (cin, cout, sp, gap)
        err = max(err, gap)
        del x, w, dy, got, ref
    torch.cuda.empty_cache()
    probe = subprocess.run([sys.executable, WGRAD_PROBE, "--reps", "5"], capture_output=True,
                           text=True)
    assert probe.returncode == 0, probe.stderr[-3000:]
    last = json.loads(probe.stdout.strip().splitlines()[-1])
    assert last["card"] == _card() and last["launches"] == len(shapes), last
    return {"err": err, "shapes": len(shapes), **last["per_step"]}


def _ct_in_phase(blocks, model, dev, gen, probe) -> tuple:
    """Phase 9, the InstanceNorm kernels at CT scale: the forward at the
    outputs of the CT U-Net's cuDNN and blocked convs at the train batch (2)
    and the serving batch (64), the backward at every conv output at the
    train batch, f32 and bf16 (f32 at B=64 where its three copies fit
    CT_F32_BYTES), each through :func:`_in_check` (the plain forward per 8
    batch items); beside them their device time per launch, bf16, with the
    bytes bound and F.instance_norm, from ``probe`` (in_probe.py's groups,
    read in a process of its own in phase 1).  Returns ({"fwd" | "bwd":
    largest error}, {group: timings})."""
    shapes = _in_shapes(blocks, _ct_work(blocks, model, TRAIN_BATCH)["route"])
    assert (shapes["fwd"], shapes["bwd"]) == (in_probe.CT_FWD, in_probe.CT_BWD), shapes
    err = _in_checks(shapes, (TRAIN_BATCH, CT_SERVE_BATCH), (TRAIN_BATCH,), dev, gen)
    return err, {g: probe[g] for g in CT_IN_GROUPS}


def _in_shapes(blocks, routes) -> dict:
    """{"fwd" | "bwd": ((C, N, blocks), ...)}: the InstanceNorm kernels'
    rows in a forward and a train step of ``blocks`` on ``routes`` (the
    forward after each cuDNN or blocked conv, the backward at every conv
    output)."""
    shapes = {}
    for direction, outs in (("fwd", [o for name, _, _, o in blocks
                                     if routes[name] in ("conv", "blocked")]),
                            ("bwd", [o for _, _, _, o in blocks])):
        counts = {}
        for row in _rows(outs):
            counts[row] = counts.get(row, 0) + 1
        shapes[direction] = tuple((c, n, k) for (c, n), k in counts.items())
    return shapes


def _in_checks(shapes, fwd_batches, bwd_batches, dev, gen) -> dict:
    """:func:`_in_check` at every row of ``shapes`` (:func:`_in_shapes`),
    the forward at each of ``fwd_batches``, the backward at each of
    ``bwd_batches``, f32 and bf16 (f32 where its three copies fit
    CT_F32_BYTES), the plain forward per 8 batch items.  Returns {"fwd" |
    "bwd": largest error}."""
    err = {"fwd": 0.0, "bwd": 0.0}
    for direction, batches in (("fwd", fwd_batches), ("bwd", bwd_batches)):
        for c, n, _ in shapes[direction]:
            for b in batches:
                for dtype in (torch.float32, torch.bfloat16):
                    if dtype == torch.float32 and 3 * 4 * b * c * n > CT_F32_BYTES:
                        continue
                    args = in_probe.inputs(direction, b, c, n, gen, dtype)
                    err[direction] = max(err[direction], _in_check(direction, args, dev, 8))
                    del args
                    torch.cuda.empty_cache()
    return err


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
    # the weight gradient's kernel in every fused block and every stride-1
    # blocked one (the blocked route's stride 2 takes the library)
    n_wgrad = sum(routes[name] == "fused" or (routes[name] == "blocked"
                                              and m.conv.stride == (1, 1, 1))
                  for name, m, _, _ in blocks)
    bwd = {"conv3d_dx": n_dx["fused"], "instance_norm_leaky_bwd": len(routes),
           "conv3d_wgrad": n_wgrad,
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
        # task: [the step's CL penalty or distillation term (a device tensor)]
        self.penalties = {}
        # task: [{name: device tensor} of the step's terms in POD_TERMS]
        self.terms = {}
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
                        v for k, v in out[1].items() if k.endswith("_penalty")
                        or k in DISTILL_TERMS)
                    probe.terms.setdefault(task, []).append(
                        {k: v for k, v in out[1].items() if k in POD_TERMS})
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
        conv3d_dx=(n_fused - 1) * back, conv3d_wgrad=n_fused * back,
        instance_norm_leaky_bwd=(n_fused + n_strided) * back,
        flash_attention=attn * fwd, flash_attention_bwd=attn * back,
        **_in_forms(dev, fwd=_at(_rows([o for f, _, o in shapes if not f]),
                                 [(batch, back + vals)] + [(b, 1) for b in progress]),
                    bwd=_at(_rows([o for _, _, o in shapes]), [(batch, back)])))


def _task_stages(pre, tasks) -> tuple:
    """({task: its preprocessed dataset}, {task: its fold-0 split})."""
    stages = {t: PreprocessedDataset(os.path.join(pre, t, "nnUNetData_plans_v2.1_3d_fullres"))
              for t in tasks}
    return stages, {t: final_splits(os.path.join(pre, t), stages[t].cases)[0] for t in tasks}


def _val_batches(stage, split, patch, batch=SEQ_WINDOW_BATCH) -> list:
    """The window batches of a sliding window over a task's val cases (by
    default the progress validation's, the trainer's window batch)."""
    out = []
    for case in split["val"]:
        n = len(window_grid(stage.load(case).shape[1:], patch)[2])
        out += [min(batch, n - i) for i in range(0, n, batch)]
    return out


def _stream_batches(volumes, patch, window_batch=WINDOW_BATCH, tta=True,
                    volume_batch=VOLUME_BATCH) -> list:
    """The model batches of ``predict_from_folder`` on preprocessed
    ``volumes`` (in case order): chunks of 2 x ``volume_batch`` cases; in a
    chunk, consecutive volumes that pad alike form groups of up to
    ``volume_batch`` (an even patch; one volume each otherwise) whose
    (volume, window) pairs share batches of ``window_batch``; a 2D patch
    runs each volume's (slice, window) pairs alone; times the mirror
    variants (``tta``).  ``volume_batch=1`` is the per-case path."""
    mirrors = 2 ** len(patch) if tta else 1
    limit = volume_batch if all(p % 2 == 0 for p in patch) else 1
    out = []

    def run(pairs):
        out.extend(min(window_batch, pairs - i) * mirrors for i in range(0, pairs, window_batch))

    chunk = max(2 * volume_batch, 2) if volume_batch > 1 else 1
    for c in range(0, len(volumes), chunk):
        group = []                          # (padded shape, windows) of its volumes
        for v in volumes[c:c + chunk]:
            if v.ndim - 1 == len(patch) + 1:
                run(sum(n for _, n in group))
                group = []
                run(v.shape[0] * len(window_grid(v.shape[1:-1], patch)[2]))
                continue
            pads, _, origins = window_grid(v.shape[:-1], patch)
            shape = tuple(s + lo + hi for s, (lo, hi) in zip(v.shape[:-1], pads))
            if group and group[0][0] != shape:
                run(sum(n for _, n in group))
                group = []
            group.append((shape, len(origins)))
            if len(group) >= limit:
                run(sum(n for _, n in group))
                group = []
        run(sum(n for _, n in group))
    return out


def _serve_batches(images, plans, patch, config="3d_fullres", volume_batch=VOLUME_BATCH,
                   tta=True) -> list:
    """The model batches of serving a folder through ``predict_from_folder``
    (by default the volume stream, the CLIs' path)."""
    volumes = [preprocess_for_inference(files, plans, config)[0]
               for _, files in case_files(images)]
    return _stream_batches(volumes, patch, tta=tta, volume_batch=volume_batch)


def _path_expect(blocks, model, dev, runs) -> dict:
    """Every counter of ``runs`` [(batch, forwards, backwards)] of the model
    whose blocks are ``blocks`` (:func:`_named_blocks`, any dimension), each
    block on the route its input takes at that batch (the CT routes' gates
    included, :func:`_ct_work`): per forward a fused block's conv, another
    block's InstanceNorm (after cuDNN, or after the blocked conv's pack and
    unpack), an interleave per admitted upsample; per backward every
    block's InstanceNorm backward, the data gradient of every stride-1
    block but the first (on the fused kernel, or the blocked conv's pack
    and unpack), the weight gradient's kernel in every fused block and
    every stride-1 blocked one, a de-interleave per interleave; the InstanceNorm's and the pack's
    launches in the forms their plans give."""
    counts, fwd_in, bwd_in, packs = {"conv3d_wgrad": 0}, [], [], {}
    for batch, fwd, bwd in runs:
        work = _ct_work(blocks, model, batch)
        routes = work["route"]
        for i, (name, m, _, _) in enumerate(blocks):
            key = "conv3d_in_lrelu" if routes[name] == "fused" else "instance_norm_leaky"
            counts[key] = counts.get(key, 0) + fwd
            if routes[name] == "fused" and i > 0:
                counts["conv3d_dx"] = counts.get("conv3d_dx", 0) + bwd
            if routes[name] == "fused" or (routes[name] == "blocked"
                                           and m.conv.stride == (1, 1, 1)):
                counts["conv3d_wgrad"] += bwd
        counts["instance_norm_leaky_bwd"] = \
            counts.get("instance_norm_leaky_bwd", 0) + len(routes) * bwd
        for kind, names in (("pack", ("pack_blocks",)), ("unpack", ("unpack_blocks",)),
                            ("ileave", ("interleave_up2", "deinterleave2"))):
            for shape_key, (f, b) in work[kind].items():
                if kind == "ileave":
                    counts[names[0]] = counts.get(names[0], 0) + f * fwd
                    counts[names[1]] = counts.get(names[1], 0) + b * bwd
                else:
                    counts[names[0]] = counts.get(names[0], 0) + f * fwd + b * bwd
                if kind == "pack":
                    packs[shape_key] = packs.get(shape_key, 0) + f * fwd + b * bwd
        fwd_in += _at(_rows([o for name, _, _, o in blocks
                             if routes[name] in ("conv", "blocked")]), [(batch, fwd)])
        bwd_in += _at(_rows([o for _, _, _, o in blocks]), [(batch, bwd)])
    return _expect(**counts, **_in_forms(dev, fwd=fwd_in, bwd=bwd_in),
                   **_pack_forms(dev, packs))


def _cl_argv(run, iters=SEQ_ITERS) -> list:
    """The CL CLIs' arguments of phases 11-14 for the task sequence ``run``
    at ``iters`` steps a task."""
    return ["3d_fullres", "-t"] + list(run) + [
        "-num_epochs", "1", "-num_iters", str(iters), "-val_iters", str(SEQ_VAL_ITERS),
        "-save_interval", "1", "--use_progress_val", "--device", "cuda"]


VIT_ARCH = dict(vit=True, vit_version="V1", vit_type="base", task_specific_ln=False,
                spt=False, lsa=False)


def _cl_folders(results, plans, arch=VIT_ARCH):
    """``folder(ext, run, upto, vit_run=False)``: the output folder of
    ``ext`` trained on ``run`` up to task ``upto`` (``--use_vit``: ``arch``,
    by default V1, ViT-base)."""
    def folder(ext, run, upto, vit_run=False) -> str:
        return build_output_folder(os.path.join(results, "nnUNet_ext"), "3d_fullres", run,
                                   run[: upto + 1], trainer_name(ext), plans.plans_name, 0,
                                   get_trainer(ext).TRANSFER_HEADS,
                                   **(arch if vit_run else {}))
    return folder


def _forward_expect(dev, shapes, batches, attn=0) -> dict:
    """Every counter of forwards (no backward) of a model whose blocks are
    ``shapes`` at each model batch of ``batches``; ``attn`` attention blocks
    per forward (the ViT's)."""
    n_fused = sum(f for f, _, _ in shapes)
    return _expect(conv3d_in_lrelu=n_fused * len(batches),
                   instance_norm_leaky=(len(shapes) - n_fused) * len(batches),
                   flash_attention=attn * len(batches),
                   **_in_forms(dev, fwd=_at(_rows([o for f, _, o in shapes if not f]),
                                            [(b, 1) for b in batches])))


def _sequence_path(task_dir, plans, shapes, work, pre, results, dev) -> tuple:
    """Phase 11: a sequence of two hippocampus-scale tasks through the CL
    entry points (see the module docstring).  Returns the launch counts of
    the training runs (``cl_train``) and of serving the heads
    (``cl_serve``), and Sequential's warm s/step per task."""
    cfg = plans.config("3d_fullres")
    patch, b2, classes = tuple(cfg.patch_size), TRAIN_BATCH, plans.num_classes + 1
    n_fused = sum(f for f, _, _ in shapes)
    n_strided = len(shapes) - n_fused
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
    argv = _cl_argv(tasks)
    folder = _cl_folders(results, plans)

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
        final = folder(ext, tasks, 1)
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
    assert serve_launches == _forward_expect(dev, shapes, serve_batches), serve_launches

    # one case of B with head B on the plain route against the served one
    ckpt = os.path.join(folder("sequential", tasks, 1), "model_final_checkpoint")
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
    (``cl_reg_serve``), and the mean Dice of each EWC head on each task
    ({(head, task): Dice})."""
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
    vit_b = max(1, b2 // 2)
    steps_per, vals_per = SEQ_ITERS, SEQ_VAL_ITERS
    folder = _cl_folders(results, plans)

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
            run_training(ext, _cl_argv(run) + (["--use_vit"] if vit_run else []))
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
    run_training("ewc", _cl_argv(tasks) + ["-c"])
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
        run_training("ewc", _cl_argv(tasks) + ["-c"])
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
    assert serve_launches == _forward_expect(dev, shapes, serve_batches), serve_launches

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
    return {"cl_reg_train": cl_reg_train, "cl_reg_serve": serve_launches}, dice


def _distill_eval_path(task_dir, plans, shapes, vit, work, pre, results, dev,
                       ewc_dice) -> dict:
    """Phase 13: the distilling trainers through their entry points on the
    tasks of phases 11-12, and the evaluation CLIs on the sequences of
    phases 11-13 (see the module docstring).  ``ewc_dice``: phase 12's
    {(head, task): mean Dice}.  Returns the launch counts of the trainings
    and the resumed run (``cl_distill_train``) and of the evaluations, the
    postprocessing decision and the postprocessed serving (``cl_eval``)."""
    cfg = plans.config("3d_fullres")
    patch, b2 = tuple(cfg.patch_size), TRAIN_BATCH
    raw_root = os.path.dirname(task_dir)
    tasks = [os.path.basename(task_dir), "Task098_SynthB", REG_TASK_C["task_name"]]
    images = {t: os.path.join(raw_root, t, "imagesTr") for t in tasks}
    stages, splits = _task_stages(pre, tasks)
    val_b = {t: _val_batches(stages[t], splits[t], patch) for t in tasks}
    ext_root = os.path.join(results, "nnUNet_ext")

    folder = _cl_folders(results, plans)

    def registry(base, name="model_final_checkpoint"):
        return load_registry(os.path.join(base, name), torch.device("cpu"), [])

    def progress(run, phases):
        """The progress validation's batches: after the first task its val
        cases, after each phase of a later task those of every task so far."""
        return val_b[run[0]] + [b for i in range(1, len(run)) for _ in range(phases)
                                for t in run[: i + 1] for b in val_b[t]]

    # per train step a forward and a backward; LwF's joint step at P earlier
    # tasks adds P of both (the earlier heads) and P forwards without grad
    # (the teachers), MiB's step one forward without grad; each counted like
    # a train step or a validation batch at the train batch
    def lwf_expect(run, vit_run):
        earlier = range(1, len(run))
        return _train_expect(
            dev, vit["shapes"] if vit_run else shapes, max(1, b2 // 2) if vit_run else b2,
            SEQ_ITERS * (1 + sum(2 + p for p in earlier)),
            SEQ_VAL_ITERS * (1 + 2 * len(earlier)) + SEQ_ITERS * sum(earlier),
            progress(run, 2), attn=vit["n_attn"] if vit_run else 0)

    runs = [("lwf", tasks, False), ("mib", tasks[:2], False), ("lwf", tasks[:2], True)]
    expects = [lwf_expect(tasks, False),
               _train_expect(dev, shapes, b2, 2 * SEQ_ITERS, 2 * SEQ_VAL_ITERS + SEQ_ITERS,
                             progress(tasks[:2], 1)),
               lwf_expect(tasks[:2], True)]
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    launches, probes, peak_gb, run_s = [], [], [], []
    for (ext, run, vit_run), expect in zip(runs, expects):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _SequenceProbe() as probe:
            run_training(ext, _cl_argv(run) + (["--use_vit"] if vit_run else []))
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
        peak_gb.append(torch.cuda.max_memory_allocated() / 1e9)
        launches.append(_counts())
        assert launches[-1] == expect, (ext, vit_run, launches[-1], expect)
        probes.append(probe)
        phases = [t for t, _ in probe.tasks]
        assert phases == ([run[0]] + [t for t in run[1:] for _ in range(2)]
                          if ext == "lwf" else run), (ext, phases)
        with open(os.path.join(folder(ext, run, len(run) - 1, vit_run),
                               "progress.json")) as f:
            record = json.load(f)
        assert all(map(math.isfinite, record["step_losses"])), ext
        # the distillation term on every step it runs: LwF's joint steps, 0
        # (to roundoff) on the first, where the earlier heads and the body
        # are their teachers; MiB's steps on B
        assert not probe.penalties.get(run[0]), ext
        for t in run[1:]:
            terms = torch.stack(probe.penalties[t]).float().cpu()
            assert len(terms) == SEQ_ITERS and bool(torch.isfinite(terms).all()), (ext, t)
            assert bool((terms[1:] > 0).all()), (ext, t, terms)

    # LwF's checkpoints: the freeze run leaves the body as it was, each
    # phase in the manifest
    phases = {}
    for i, t in enumerate(tasks):
        base = folder("lwf", tasks, i)
        _, _, manifest = registry(base)
        phases[t] = [manifest["lwf_phase"]]
        if i:
            frozen, _, m_frozen = registry(base, "model_freezed")
            before, _, _ = registry(folder("lwf", tasks, i - 1))
            assert all(torch.equal(v, before.body[k]) for k, v in frozen.body.items()), t
            phases[t].insert(0, m_frozen["lwf_phase"])
    assert phases == {tasks[0]: [0], tasks[1]: [1, 2], tasks[2]: [1, 2]}, phases
    # -c after C trains nothing
    _reset_counts()
    run_training("lwf", _cl_argv(tasks) + ["-c"])
    assert _counts() == _expect(), _counts()
    train_launches = {k: sum(c[k] for c in launches) for k in launches[0]}

    # ---- evaluator2 on each of EWC's heads: phase 12's served Dice
    os.environ["EVALUATION_FOLDER"] = os.path.join(work, "evaluation")
    eval_root = os.path.join(work, "evaluation", "nnUNet_ext")

    def evaluated(ext, run, upto):
        return os.path.join(eval_root, os.path.relpath(folder(ext, run, upto), ext_root))

    _reset_counts()
    eval2_dice, eval2_s = {}, []
    for head in tasks:
        t0 = time.perf_counter()
        run_evaluation2_cli(["3d_fullres", "ewc", "-trained_on"] + tasks + ["-evaluate_on"]
                            + tasks + ["-use_head", head, "--device", "cuda"])
        eval2_s.append(time.perf_counter() - t0)
        with open(os.path.join(evaluated("ewc", tasks, 2), "eval2", "eval2_metrics.json")) as f:
            res = json.load(f)
        for t in tasks:
            assert res[t]["head"] == head, res[t]["head"]
            eval2_dice[(head, t)] = statistics.mean(
                float(np.nanmean(m["Dice"])) for m in res[t]["cases"].values())
    eval2_launches = _counts()
    serve_batches = [b for t in tasks for b in _serve_batches(images[t], plans, patch)]
    assert eval2_launches == _forward_expect(dev, shapes, serve_batches * len(tasks)), \
        eval2_launches
    eval2_err = max(abs(eval2_dice[k] - v) for k, v in ewc_dice.items())
    assert eval2_err <= EVAL2_DICE_TOL, (eval2_dice, ewc_dice)

    # ---- the accuracy matrices through nnUNet_torch_evaluate, stage by stage
    sequences = {"ewc": tasks, "lwf": tasks, "mib": tasks[:2], "sequential": tasks[:2]}
    reports, eval_s, eval_batches = {}, {}, []
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for ext, run in sequences.items():
        acc = np.full((len(run), len(run)), np.nan)
        eval_s[ext] = []
        for s in range(len(run)):
            t0 = time.perf_counter()
            run_evaluation(["3d_fullres", ext, "-trained_on"] + run + ["-use_model"]
                           + run[: s + 1] + ["-evaluate_on"] + run + ["--device", "cuda"])
            eval_s[ext].append(time.perf_counter() - t0)
            with open(os.path.join(evaluated(ext, run, s), "val_metrics_eval.json")) as f:
                res = json.load(f)[-1]["results"]
            assert {t: r["head"] for t, r in res.items()} == \
                {t: t if i <= s else run[s] for i, t in enumerate(run)}, res
            acc[s] = [mean_dice_of(res, t) for t in run]
            eval_batches += [b * TTA for t in run for b in val_b[t]]
        assert np.isfinite(acc).all(), (ext, acc)
        reports[ext] = cl_report(acc, run)
        write_cl_report(reports[ext], evaluated(ext, run, len(run) - 1))
    eval_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_launches = _counts()
    assert eval_launches == _forward_expect(dev, shapes, eval_batches), eval_launches
    # the matrix's diagonal after the last stage is the validation split's
    # Dice of each head: BWT and FWT from it
    for ext, rep in reports.items():
        a = np.asarray(rep["accuracy_matrix"])
        assert rep["BWT"] == statistics.mean(a[-1, i] - a[i, i] for i in range(len(a) - 1))

    # ---- the postprocessing decision on task A, read by the serving CLI
    final = folder("ewc", tasks, 2)
    tr = restore_trainer(os.path.join(final, "model_final_checkpoint"),
                         TrainerOptions(device="cuda"))
    tr.register_task_data(tasks[0], stages[tasks[0]].stage_dir)
    _reset_counts()
    decision = determine_postprocessing(tr, tasks[0], final)
    del tr
    out = os.path.join(work, "ewc_pp_on_A")
    run_inference(["3d_fullres", "ewc", "-i", images[tasks[0]], "-o", out, "-trained_on"]
                  + tasks + ["-window_batch", str(WINDOW_BATCH), "--postprocess",
                             "--device", "cuda"])
    pp_launches = _counts()
    assert pp_launches == _forward_expect(
        dev, shapes, _val_batches(stages[tasks[0]], splits[tasks[0]], patch, WINDOW_BATCH)
        + _serve_batches(images[tasks[0]], plans, patch)), pp_launches
    kept = load_postprocessing(final)
    assert kept == decision["for_which_classes"], (kept, decision)
    for case, _ in case_files(images[tasks[0]]):
        served = np.asarray(read_image(os.path.join(work, f"ewc_{tasks[2]}_on_{tasks[0]}",
                                                    f"{case}.nii.gz")).data)
        pp = np.asarray(read_image(os.path.join(out, f"{case}.nii.gz")).data)
        assert np.array_equal(pp, remove_all_but_largest_component(served, kept)), case

    # ---- LwF's joint step at P = 1 and 2 beside a Sequential-style step, at
    # the same parameters, CUDA-event medians in turns
    batch = PatchSampler(stages[tasks[2]], splits[tasks[2]]["train"], patch, b2,
                         seed=SEED).next_batch()
    batch = {k: torch.from_numpy(batch[k]).to(dev) for k in ("data", "seg")}
    steps = {}
    for p in (1, 2):
        tr = restore_trainer(os.path.join(folder("lwf", tasks, p), "model_final_checkpoint"),
                             TrainerOptions(device="cuda"))
        assert len(tr.extra_params()) == p * len(tr.mh.heads[tasks[0]]), p
        step_cfg = StepConfig(ds_factors=tr.ds_factors, batch_dice=True,
                              num_classes=tr.num_classes)
        steps[f"P={p}"] = (make_train_step(tr.model, tr.optimizer, step_cfg,
                                           loss_extras=tr.loss_extras()), tr.cl_state)
        if p == 1:
            steps["plain"] = (make_train_step(tr.model, tr.optimizer, step_cfg), tr.cl_state)
    step_ms = {name: [] for name in steps}
    for name in ("plain", "P=1", "P=2", "P=2", "P=1", "plain"):
        step, cl_state = steps[name]
        step_ms[name].append(_time_ms(lambda: step(cl_state, batch), reps=STEP_REPS))
    del steps, tr

    # ---- the record
    for (ext, run, vit_run), probe, secs, peak, counts in zip(runs, probes, run_s, peak_gb,
                                                               launches):
        print(f"[phase 13] nnUNet_torch_train_{ext} -t {' '.join(run)}"
              + (" --use_vit" if vit_run else "") + " --device cuda, full width"
              + (" (V1, ViT-base, batch 1)" if vit_run else f" (batch {b2})")
              + f", 1 epoch x {SEQ_ITERS} steps + {SEQ_VAL_ITERS} val batches per task and "
              f"phase: {secs:.2f} s, seconds per task and phase "
              + ", ".join(f"{t} {s:.2f}" for t, s in probe.tasks)
              + f"; warm s/step of each task's last phase (median of steps 4-{SEQ_ITERS}, "
              "synchronized) " + ", ".join(f"{t} {probe.warm_step_s(t):.4f}" for t in run)
              + f"; {'lwf_distill' if ext == 'lwf' else 'mib'} per step "
              + ", ".join(f"{t} {float(torch.stack(probe.penalties[t]).min()):.4e}.."
                          f"{float(torch.stack(probe.penalties[t]).max()):.4e}"
                          for t in run[1:])
              + f"; progress validation {[round(v, 3) for v in probe.val_s]} s; peak "
              f"{peak:.2f} GB; launches {counts} == predicted", flush=True)
    print(f"[phase 13] lwf: lwf_phase per checkpoint (model_freezed, final) {phases}; the "
          f"body after each freeze run equal to the task before's bit for bit; a -c run "
          f"after {tasks[2]} trained nothing (all launch counts 0); the joint step "
          f"(CUDA events, ms, in turns; one augmentation-free batch of {tasks[2]}) "
          + ", ".join(f"{k} {[round(v, 3) for v in step_ms[k]]}" for k in ("plain", "P=1", "P=2"))
          + f"; step time over the plain step's: P=1 "
          f"{statistics.mean(step_ms['P=1']) / statistics.mean(step_ms['plain']):.3f}, P=2 "
          f"{statistics.mean(step_ms['P=2']) / statistics.mean(step_ms['plain']):.3f}",
          flush=True)
    print(f"[phase 13] nnUNet_torch_evaluate2 ewc -trained_on {' '.join(tasks)} -use_head "
          f"<head>: per head {[round(v, 2) for v in eval2_s]} s, {len(serve_batches) * 3} "
          f"forwards, launches == predicted; mean Dice against phase 12's served matrix, "
          f"largest |diff| {eval2_err:.2e} (limit {EVAL2_DICE_TOL})", flush=True)
    for ext, rep in reports.items():
        print(f"[phase 13] nnUNet_torch_evaluate {ext} -trained_on "
              f"{' '.join(sequences[ext])} -use_model <prefix>: seconds per stage "
              f"{[round(v, 2) for v in eval_s[ext]]}; accuracy matrix (rows stages, columns "
              f"tasks, validation split, TTA 8) "
              + "; ".join(", ".join(f"{v:.4f}" for v in row) for row in rep["accuracy_matrix"])
              + f"; BWT {rep['BWT']:.4f}, FWT {rep['FWT']:.4f}, final mean Dice "
              f"{rep['final_mean_dice']:.4f} (cl_metrics.json)", flush=True)
    print(f"[phase 13] evaluation peak {eval_peak_gb:.2f} GB, {len(eval_batches)} forwards "
          f"(window batches of 4 x 8 mirrors), launches == predicted; "
          f"determine_postprocessing on {tasks[0]}: classes {decision['for_which_classes']}, "
          f"Dice raw {decision['dice_raw']}, largest component {decision['dice_pp']}; "
          f"nnUNet_torch_inference --postprocess applied {kept} (launches == predicted)",
          flush=True)
    return {"cl_distill_train": train_launches,
            "cl_eval": {k: eval2_launches[k] + eval_launches[k] + pp_launches[k]
                        for k in eval_launches}}


class _PodProbe(_SequenceProbe):
    """Phase 14's measurements on top of phase 11's: each PLOP threshold
    pass's seconds (synchronized) and thresholds, and each of OwnM4's
    pseudo-weight readings (iteration, epoch, weight)."""

    def __enter__(self):
        super().__enter__()
        probe = self
        self.threshold_s, self.weights = [], []

        def thresholds(orig):
            def timed(self, task, teacher):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(self, task, teacher)
                torch.cuda.synchronize()
                probe.threshold_s.append((task, time.perf_counter() - t0, out))
                return out
            return timed

        def weight(orig):
            def recorded(self, it, epoch):
                out = orig(self, it, epoch)
                probe.weights.append((it, epoch, out))
                return out
            return recorded

        self._wrap(PLOPTrainer, "compute_thresholds", thresholds)
        self._wrap(OwnM4Trainer, "pseudo_weight", weight)
        return self


class _CheckpointBytes:
    """While active, every checkpoint blob that ``training/checkpoints.py``
    saves is serialized into memory and its size recorded ({file: bytes})
    instead of being written (the JSON manifests still are).  Phase 14 runs
    the OwnM trainings under it: nothing reads their checkpoints back, and
    with OwnM1's ViT-base blobs on disk (up to 2.2 GB each: model,
    momentum, teacher, two anchor sets; ~10.6 GB in all) the whole script
    writes ~47 GB to disk, ~35 GB without them.  Blobs whose file name
    starts with one of ``keep`` are written as usual (phase 15 reads its
    runs' final checkpoints back)."""

    def __init__(self, keep=()):
        self.sizes = {}
        self.keep = tuple(keep)

    def __enter__(self):
        sizes, keep = self.sizes, self.keep

        class Torch:
            def __getattr__(self, name):
                return getattr(torch, name)

            @staticmethod
            def save(obj, path):
                if keep and os.path.basename(path).startswith(keep):
                    torch.save(obj, path)
                    return
                # a spooled file this large never leaves memory
                with tempfile.SpooledTemporaryFile(max_size=1 << 40) as buf:
                    torch.save(obj, buf)
                    sizes[path] = buf.tell()

        checkpoint_io.torch = Torch()
        return self

    def __exit__(self, *exc):
        checkpoint_io.torch = torch


def _pod_path(task_dir, plans, shapes, vit, work, pre, results, dev) -> dict:
    """Phase 14: the POD trainers through their entry points on the tasks of
    phases 11-13, PLOP's heads served and PLOP's and POD's stages scored
    (see the module docstring).  Returns the launch counts of the trainings
    (``cl_pod_train``) and of the servings and evaluations
    (``cl_pod_serve``)."""
    cfg = plans.config("3d_fullres")
    patch, b2, classes = tuple(cfg.patch_size), TRAIN_BATCH, plans.num_classes + 1
    raw_root = os.path.dirname(task_dir)
    tasks = [os.path.basename(task_dir), "Task098_SynthB", REG_TASK_C["task_name"]]
    images = {t: os.path.join(raw_root, t, "imagesTr") for t in tasks}
    labels = {t: os.path.join(raw_root, t, "labelsTr") for t in tasks}
    stages, splits = _task_stages(pre, tasks)
    val_b = {t: _val_batches(stages[t], splits[t], patch) for t in tasks}
    ext_root = os.path.join(results, "nnUNet_ext")
    folder = _cl_folders(results, plans)
    S, V, vit_b = POD_ITERS, SEQ_VAL_ITERS, max(1, b2 // 2)

    def progress(run):
        """After each task its val cases and every earlier task's."""
        return [b for i in range(len(run)) for t in run[: i + 1] for b in val_b[t]]

    def expect(ext, run, vit_run):
        """From the second task on a step is a forward+backward unit and a
        teacher forward without grad; PLOP's threshold pass adds S forwards
        a task, EWC's fisher pass S forward+backward units after each task.
        With the ViT the taps path runs V1's bottleneck stage forward (the
        U-Net's blocks, in the student's and the teacher's forwards); OwnM
        distils the decoder taps only, so no loss reaches that stage and its
        backward does not run."""
        later = len(run) - 1
        fisher = S * len(run) if ext.startswith("ownm") else 0
        thresholds = S * later if ext == "plop" else 0
        if not vit_run:
            return _train_expect(dev, shapes, b2, S * len(run),
                                 V * len(run) + S * later + thresholds, progress(run),
                                 fisher=fisher)
        base = _train_expect(dev, vit["shapes"], vit_b, S * len(run),
                             V * len(run) + S * later, progress(run), fisher=fisher,
                             attn=vit["n_attn"])
        taps = 2 * S * later
        with_stage = _train_expect(dev, shapes, vit_b, 0, taps, [])
        without = _train_expect(dev, vit["shapes"], vit_b, 0, taps, [])
        return {k: base[k] + with_stage[k] - without[k] for k in base}

    runs = [("plop", tasks, False), ("pod", tasks[:2], False), ("ownm2", tasks[:2], False),
            ("ownm4", tasks[:2], False), ("ownm1", tasks[:2], True)]
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    launches, probes, peak_gb, run_s, ckpt_mb, kept_gb = {}, {}, {}, {}, {}, {}
    for ext, run, vit_run in runs:
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kept = _CheckpointBytes() if ext.startswith("ownm") else None
        with _PodProbe() as probe:
            if kept:
                with kept:
                    run_training(ext, _cl_argv(run, S) + (["--use_vit"] if vit_run else []))
            else:
                run_training(ext, _cl_argv(run, S))
        torch.cuda.synchronize()
        run_s[ext] = time.perf_counter() - t0
        peak_gb[ext] = torch.cuda.max_memory_allocated() / 1e9
        launches[ext] = _counts()
        assert launches[ext] == expect(ext, run, vit_run), (ext, launches[ext])
        probes[ext] = probe
        final = folder(ext, run, len(run) - 1, vit_run)
        with open(os.path.join(final, "progress.json")) as f:
            record = json.load(f)
        # finite on every step, the first of each later task included (the
        # student's taps equal the teacher's there)
        assert len(record["step_losses"]) == S * len(run), ext
        assert all(map(math.isfinite, record["step_losses"])), (ext, record["step_losses"])
        assert [t for t, _ in probe.tasks] == run and len(probe.val_s) == len(run), ext
        assert not any(probe.terms[run[0]]), ext
        for t in run[1:]:
            terms = {k: torch.stack([d[k] for d in probe.terms[t]]).float().cpu()
                     for k in probe.terms[t][0]}
            assert "pod" in terms and all(len(v) == S for v in terms.values()), (ext, t)
            assert all(bool(torch.isfinite(v).all()) for v in terms.values()), (ext, t, terms)
            assert bool((terms["pod"][1:] > 0).all()), (ext, t, terms["pod"])
        ckpt = os.path.join(final, "model_final_checkpoint.pt")
        ckpt_mb[ext] = (kept.sizes[ckpt] if kept else os.path.getsize(ckpt)) / 1e6
        if kept:
            kept_gb[ext] = (len(kept.sizes), sum(kept.sizes.values()) / 1e9)

    # ---- PLOP's thresholds, from the model after the task before
    plop = probes["plop"]
    assert [t for t, _, _ in plop.threshold_s] == tasks[1:], plop.threshold_s
    n_out = len(ds_scale_factors(cfg.pool_op_kernel_sizes))
    for i, t in enumerate(tasks[1:], start=1):
        _, blob, _ = load_registry(os.path.join(folder("plop", tasks, i),
                                                "model_final_checkpoint"), torch.device("cpu"),
                                   [])
        thr = blob["cl_state"]["thresholds"]
        assert len(thr) == n_out and all(v.shape == (classes,) for v in thr), thr
        assert all(bool(((v >= 0.001) & (v <= 1.0)).all()) for v in thr), thr
        probed = [v.cpu() for v in plop.threshold_s[i - 1][2]]
        assert all(torch.equal(a, b) for a, b in zip(probed, thr)), (probed, thr)
    thresholds = {t: [[round(float(x), 3) for x in v] for v in out]
                  for t, _, out in plop.threshold_s}
    # ---- OwnM4's pseudo iterations: its counter runs on across tasks
    weights = probes["ownm4"].weights
    assert [it for it, _, _ in weights] == list(range(S, 2 * S)), weights
    assert [it for it, _, w in weights if w > 0] == OWNM4_PSEUDO, weights
    assert {w for it, _, w in weights if w > 0} == {METHOD_ARGS["ownm4"]["pseudo_alpha"][1]}
    train_launches = {k: sum(c[k] for c in launches.values()) for k in launches["plop"]}

    # ---- PLOP's heads served, each on its task's images
    _reset_counts()
    dice = {}
    for head in tasks:
        out = os.path.join(work, f"plop_{head}")
        run_inference(["3d_fullres", "plop", "-i", images[head], "-o", out, "-trained_on"]
                      + tasks + ["-use_head", head, "-window_batch", str(WINDOW_BATCH),
                                 "--device", "cuda"])
        per_case = []
        for case, _ in case_files(images[head]):
            seg = np.asarray(read_image(os.path.join(out, f"{case}.nii.gz")).data)
            label = np.asarray(read_image(os.path.join(labels[head], f"{case}.nii.gz")).data)
            assert seg.shape == label.shape and int(seg.max()) < classes
            per_case.append(float(np.nanmean(subject_metrics(seg, label, classes)["Dice"])))
        dice[head] = statistics.mean(per_case)
    serve_batches = [b for t in tasks for b in _serve_batches(images[t], plans, patch)]
    serve_launches = _counts()
    assert serve_launches == _forward_expect(dev, shapes, serve_batches), serve_launches

    # ---- PLOP's and POD's accuracy matrices through nnUNet_torch_evaluate
    os.environ["EVALUATION_FOLDER"] = os.path.join(work, "evaluation")
    eval_root = os.path.join(work, "evaluation", "nnUNet_ext")
    sequences = {"plop": tasks, "pod": tasks[:2]}
    reports, eval_s, eval_batches = {}, {}, []
    _reset_counts()
    for ext, run in sequences.items():
        acc = np.full((len(run), len(run)), np.nan)
        eval_s[ext] = []
        for s in range(len(run)):
            t0 = time.perf_counter()
            run_evaluation(["3d_fullres", ext, "-trained_on"] + run + ["-use_model"]
                           + run[: s + 1] + ["-evaluate_on"] + run + ["--device", "cuda"])
            eval_s[ext].append(time.perf_counter() - t0)
            where = os.path.join(eval_root, os.path.relpath(folder(ext, run, s), ext_root))
            with open(os.path.join(where, "val_metrics_eval.json")) as f:
                res = json.load(f)[-1]["results"]
            acc[s] = [mean_dice_of(res, t) for t in run]
            eval_batches += [b * TTA for t in run for b in val_b[t]]
        assert np.isfinite(acc).all(), (ext, acc)
        reports[ext] = cl_report(acc, run)
        write_cl_report(reports[ext], where)
    eval_launches = _counts()
    assert eval_launches == _forward_expect(dev, shapes, eval_batches), eval_launches

    # ---- the PLOP and POD steps beside a plain step at C's first
    # parameters (teacher: the model after B), CUDA-event medians in turns,
    # and the POD term alone (forward and backward) with its launch calls
    tr = restore_trainer(os.path.join(folder("plop", tasks, 2), "before_training"),
                         TrainerOptions(device="cuda"))
    batch = PatchSampler(stages[tasks[2]], splits[tasks[2]]["train"], patch, b2,
                         seed=SEED).next_batch()
    batch = {k: torch.from_numpy(batch[k]).to(dev) for k in ("data", "seg")}
    step_cfg = StepConfig(ds_factors=tr.ds_factors, batch_dice=True, num_classes=classes)
    plop_extras = tr.loss_extras()
    tr.PSEUDO = False                 # the same teacher and taps through POD's loss
    pod_extras = tr.loss_extras()
    del tr.PSEUDO
    steps = {"plain": make_train_step(tr.model, tr.optimizer, step_cfg),
             "pod": make_train_step(tr.model, tr.optimizer, step_cfg, loss_extras=pod_extras),
             "plop": make_train_step(tr.model, tr.optimizer, step_cfg,
                                     loss_extras=plop_extras)}
    step_ms = {name: [] for name in steps}
    for name in ("plain", "pod", "plop", "plop", "pod", "plain"):
        step_ms[name].append(_time_ms(lambda: steps[name](tr.cl_state, batch), reps=STEP_REPS))
    with torch.no_grad():
        _, t_taps = tr.model(batch["data"], capture_taps=True)
    s_taps = {k: (v.detach().float() + 0.01).to(v.dtype).requires_grad_(True)
              for k, v in t_taps.items()}

    def pod_term():
        local_pod_loss(s_taps, t_taps, tr.pod_scales, tr.pod_lambda).backward()

    pod_ms = _time_ms(pod_term, reps=STEP_REPS)
    pod_calls = _launch_calls(pod_term)
    step_calls = {name: _launch_calls(lambda: steps[name](tr.cl_state, batch))
                  for name in steps}
    regions = {k: len(pod_regions(*v.shape[-2:], pod_scales(*v.shape[-2:], tr.pod_scales)))
               for k, v in t_taps.items()}
    del tr, steps, s_taps, t_taps

    # ---- the record
    for ext, run, vit_run in runs:
        probe = probes[ext]
        terms = {t: {k: torch.stack([d[k] for d in probe.terms[t]]).float().cpu()
                     for k in probe.terms[t][0]} for t in run[1:]}
        print(f"[phase 14] nnUNet_torch_train_{ext} -t {' '.join(run)}"
              + (" --use_vit" if vit_run else "") + " --device cuda, full width"
              + (" (V1, ViT-base, batch 1)" if vit_run else f" (batch {b2})")
              + f", 1 epoch x {S} steps + {V} val batches per task: {run_s[ext]:.2f} s, "
              "seconds per task " + ", ".join(f"{t} {s:.2f}" for t, s in probe.tasks)
              + f"; warm s/step (median of steps 4-{S}, synchronized) "
              + ", ".join(f"{t} {probe.warm_step_s(t):.4f}" for t in run)
              + "; every step's loss finite; the POD term on each later task's first step "
              + ", ".join(f"{t} {float(d['pod'][0]):.3e}" for t, d in terms.items())
              + "; per step on later tasks "
              + "; ".join(f"{t}: " + ", ".join(f"{k} {float(v.min()):.4e}..{float(v.max()):.4e}"
                                               for k, v in sorted(d.items()))
                          for t, d in terms.items())
              + f"; progress validation {[round(v, 3) for v in probe.val_s]} s; peak "
              f"{peak_gb[ext]:.2f} GB; model_final_checkpoint {ckpt_mb[ext]:.1f} MB"
              + (f" ({kept_gb[ext][0]} checkpoint blobs, {kept_gb[ext][1]:.2f} GB, serialized "
                 "in memory, not written)" if ext in kept_gb else "")
              + f"; launches {launches[ext]} == predicted", flush=True)
    print(f"[phase 14] plop: threshold pass ({S} teacher forwards, 100-bin histograms) "
          + ", ".join(f"{t} {s:.3f} s" for t, s, _ in plop.threshold_s)
          + f"; thresholds per DS output (classes 0..{classes - 1}) {thresholds}, every one in "
          f"[0.001, 1]; ownm4: pseudo iterations {OWNM4_PSEUDO} of {S}..{2 * S - 1} at weight "
          f"{METHOD_ARGS['ownm4']['pseudo_alpha'][1]} (the counter runs on across tasks)",
          flush=True)
    print(f"[phase 14] the step at {tasks[2]}'s first parameters (CUDA events, ms, in turns; "
          f"one augmentation-free batch) " + ", ".join(
              f"{k} {[round(v, 3) for v in step_ms[k]]}" for k in ("plain", "pod", "plop"))
          + f"; over the plain step: pod {statistics.mean(step_ms['pod']) / statistics.mean(step_ms['plain']):.3f}, "
          f"plop {statistics.mean(step_ms['plop']) / statistics.mean(step_ms['plain']):.3f}; "
          f"launch calls per step plain {step_calls['plain']:.0f}, pod {step_calls['pod']:.0f}, "
          f"plop {step_calls['plop']:.0f}; the POD term alone (forward and backward over "
          f"{len(regions)} taps, {sum(regions.values())} regions {regions}) {pod_ms:.3f} ms in "
          f"{pod_calls:.0f} launch calls, {pod_ms / statistics.mean(step_ms['plop']):.3f} of "
          f"the PLOP step", flush=True)
    print(f"[phase 14] nnUNet_torch_inference plop -trained_on {' '.join(tasks)} -use_head "
          f"<head> on its task's images: mean foreground Dice "
          + ", ".join(f"{t} {d:.4f}" for t, d in dice.items())
          + f"; {len(serve_batches)} forwards, launches == predicted", flush=True)
    for ext, rep in reports.items():
        print(f"[phase 14] nnUNet_torch_evaluate {ext} -trained_on "
              f"{' '.join(sequences[ext])} -use_model <prefix>: seconds per stage "
              f"{[round(v, 2) for v in eval_s[ext]]}; accuracy matrix (rows stages, columns "
              f"tasks, validation split, TTA 8) "
              + "; ".join(", ".join(f"{v:.4f}" for v in row) for row in rep["accuracy_matrix"])
              + f"; BWT {rep['BWT']:.4f}, FWT {rep['FWT']:.4f}, final mean Dice "
              f"{rep['final_mean_dice']:.4f} (cl_metrics.json)", flush=True)
    return {"cl_pod_train": train_launches,
            "cl_pod_serve": {k: serve_launches[k] + eval_launches[k] for k in serve_launches}}


def _drop_blobs(root) -> None:
    """Delete the checkpoint blobs (``*.pt``) under ``root``, keeping the
    manifests: the disk of the card's machine holds a run's files."""
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pt"):
                os.remove(os.path.join(d, f))


def _tree_gb(root) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root)
               for f in files) / 1e9


def _decay_only(p, steps, lr=1e-2, wd=3e-5, momentum=0.99):
    """``p`` after ``steps`` PolySGD steps in which it gets no gradient but
    its weight decay (Nesterov momentum, the poly LR of epoch 0, ``lr``),
    in ``p``'s dtype."""
    buf = None
    for _ in range(steps):
        g = wd * p
        buf = g if buf is None else momentum * buf + g
        p = p - lr * (g + momentum * buf)
    return p


def _add_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _grad_units(g, ref) -> tuple:
    """max over parameters of |g - ref| / (1e-5 + 1e-3 max|ref|), and where."""
    return max(((g[k] - ref[k]).abs().max().item() / (1e-5 + 1e-3 * ref[k].abs().max().item()),
                k) for k in ref)


def _vit_variant_path(task_dir, plans, shapes, vit, work, pre, results, dev) -> dict:
    """Phase 15: the ViT-U-Net V2 (LSA + SPT), V3 and V4 and the task-specific
    LayerNorms through their entry points, and one U-Net step with and
    without rematerialization (see the module docstring).  Returns the
    launch counts of the paths ``vit_var_train``, ``vit_var_serve``,
    ``vit_ln_train``, ``vit_ln_serve`` and ``remat_train``."""
    cfg = plans.config("3d_fullres")
    patch, b2, classes = tuple(cfg.patch_size), TRAIN_BATCH, plans.num_classes + 1
    vit_b = max(1, b2 // 2)
    raw_root = os.path.dirname(task_dir)
    tasks = [os.path.basename(task_dir), "Task098_SynthB"]
    task = tasks[0]
    images = {t: os.path.join(raw_root, t, "imagesTr") for t in tasks}
    labels = {t: os.path.join(raw_root, t, "labelsTr") for t in tasks}
    stages, splits = _task_stages(pre, tasks)
    ds_factors = tuple(ds_scale_factors(cfg.pool_op_kernel_sizes))
    one = os.path.join(work, "vit_variant_case")
    os.makedirs(one)
    case0, files0 = case_files(images[task])[0]
    for f in files0:
        shutil.copy(f, one)
    one_batches = _serve_batches(one, plans, patch)
    sampler = PatchSampler(stages[task], splits[task]["train"], patch, vit_b, seed=SEED)
    batches = [{k: torch.from_numpy(b[k]).to(dev) for k in ("data", "seg")}
               for b in (sampler.next_batch() for _ in range(3))]
    step_cfg = StepConfig(ds_factors=ds_factors, batch_dice=True, num_classes=classes,
                          augment=AugmentConfig())

    def variant(version, lsa=False, spt=False):
        def make(dtype, use_kernels=True):
            return vit_unet_from_plans(plans, "3d_fullres", patch, dtype=dtype,
                                       use_kernels=use_kernels, vit_version=version, lsa=lsa,
                                       spt=spt, generator=torch.Generator().manual_seed(SEED))
        return make

    def dice_of(out, images_dir, labels_dir):
        per_case = []
        for case, _ in case_files(images_dir):
            seg = np.asarray(read_image(os.path.join(out, f"{case}.nii.gz")).data)
            label = np.asarray(read_image(os.path.join(labels_dir, f"{case}.nii.gz")).data)
            assert seg.shape == label.shape and int(seg.max()) < classes
            per_case.append(float(np.nanmean(subject_metrics(seg, label, classes)["Dice"])))
        return statistics.mean(per_case)

    # ---- V2 (LSA + SPT), V3, V4: train, serve one case, the f32 step check
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    var_train, var_serve, rec = [], [], {}
    for version, flags in VIT_VARIANTS.items():
        lsa, spt = "--do_LSA" in flags, "--do_SPT" in flags
        m = variant(version, lsa, spt)(torch.bfloat16).to(dev)
        v_shapes = _block_shapes(m, patch, dev)
        stages_v = [n for n, _ in m.vit.named_children() if n.startswith("patch_embed_")]
        tokens = [getattr(m.vit, f"pos_embed_{i}").shape[1] for i in range(len(stages_v))]
        # one flash forward per block and ViT call; LSA takes the plain route
        n_attn = 0 if lsa else m.vit.depth * len(stages_v)
        assert tokens == [FLASH_SHAPES["train"][2]] * len(stages_v), tokens
        assert v_shapes == shapes, (version, v_shapes)     # every block runs
        assert version != "V4" or n_attn == 48, n_attn
        spt_in = m.vit.patch_embed_0.embed.proj.in_channels if spt else None
        assert not spt or spt_in == 5 * m.stage_features(0), spt_in
        del m
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _SequenceProbe() as probe, _CheckpointBytes(keep=FINAL):
            run_training_vit(["3d_fullres", task, "0", "-v", version[1:], *flags,
                              "-num_epochs", "1", "-num_iters", str(VAR_ITERS), "-val_iters",
                              str(SEQ_VAL_ITERS), "--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = _counts()
        assert got == _train_expect(dev, shapes, vit_b, VAR_ITERS, SEQ_VAL_ITERS, [],
                                    attn=n_attn), (version, got)
        var_train.append(got)
        fold = os.path.join(results, "nnUNet_ext", "3d_fullres", task,
                            f"nnViTUNetTrainer__{plans.plans_name}",
                            arch_dir(vit=True, vit_version=version, spt=spt, lsa=lsa), "fold_0")
        with open(os.path.join(fold, "progress.json")) as f:
            losses = json.load(f)["step_losses"]
        first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        assert len(losses) == VAR_ITERS and all(map(math.isfinite, losses)) and last < first, \
            (version, losses)
        _reset_counts()
        out = os.path.join(work, f"vit_{version}_served")
        run_inference(["3d_fullres", "nnViTUNetTrainer", "-i", one, "-o", out, "-trained_on",
                       task, "--use_vit", "-v", version[1:], *flags, "--device", "cuda"])
        served = _counts()
        assert served == _forward_expect(dev, shapes, one_batches, n_attn), (version, served)
        var_serve.append(served)
        seg = np.asarray(read_image(os.path.join(out, f"{case0}.nii.gz")).data)
        label = np.asarray(read_image(os.path.join(labels[task], f"{case0}.nii.gz")).data)
        dice = subject_metrics(seg, label, classes)["Dice"]
        fma, step_text = _step_check(variant(version, lsa, spt), batches[0], ds_factors, dev,
                                     attention=n_attn)
        rec[version] = dict(flags=flags, n_attn=n_attn, train_s=train_s, peak=peak,
                            first=first, last=last, warm=probe.warm_step_s(task), dice=dice,
                            step=step_text, spt_in=spt_in, tokens=tokens)
        shutil.rmtree(fold)            # its ViT-base checkpoint: 1.3 GB of disk
        torch.cuda.empty_cache()
    # V1 and V4 steps in turns (V1, V4, V4, V1)
    turn_models = {"V1": variant("V1"), "V4": variant("V4")}
    turn_s, _ = _turns(lambda dtype, key: turn_models[key](dtype), batches, step_cfg, dev,
                       order=("V1", "V4", "V4", "V1"), profiled=())
    for version, r in rec.items():
        print(f"[phase 15] nnUNet_torch_train_vit 3d_fullres {task} 0 -v {version[1:]}"
              + "".join(f" {f}" for f in r["flags"]) + f" --device cuda: ViT base, U-Net full "
              f"width, batch {vit_b}, 1 epoch x {VAR_ITERS} steps + {SEQ_VAL_ITERS} val "
              f"batches: {r['train_s']:.2f} s, warm s/step (median of steps 4-{VAR_ITERS}, "
              f"synchronized) {r['warm']:.4f}, peak {r['peak']:.2f} GB; loss first 5 "
              f"{r['first']:.4f} -> last 5 {r['last']:.4f}; launches == predicted per step "
              f"{{conv3d_in_lrelu: {sum(f for f, _, _ in shapes)}, flash_attention: "
              f"{r['n_attn']} ({len(r['tokens'])} ViT call(s) x depth, {r['tokens'][0]} tokens "
              f"each{', LSA: plain route' if not r['n_attn'] else ''}), flash_attention_bwd: "
              f"{r['n_attn']}, ...}}" + (f"; SPT patch-embed input {r['spt_in']} channels"
                                         if r["spt_in"] else "")
              + f"; served {case0} ({len(one_batches)} forward(s)), launches == predicted, "
              f"Dice {[round(d, 4) for d in r['dice']]}; {r['step']}", flush=True)
    print(f"[phase 15] V1 vs V4 train step (batch {vit_b}, augmentation on): "
          + _turns_text(turn_s).replace("route ", ""), flush=True)

    # ---- task-specific LayerNorms: Sequential and EWC-LN over A, B
    ln_arch = dict(VIT_ARCH, task_specific_ln=True)
    folder = _cl_folders(results, plans, ln_arch)
    val_b = {t: _val_batches(stages[t], splits[t], patch) for t in tasks}
    progress = [b for i in range(len(tasks)) for t in tasks[: i + 1] for b in val_b[t]]
    argv = _cl_argv(tasks, LN_ITERS) + ["--use_vit", "--task_specific_ln"]
    ln_train, ln_rec = [], {}
    for ext, fisher in (("ewc_ln", True), ("sequential", False)):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _RegularizerProbe() as probe, _CheckpointBytes(keep=FINAL):
            run_training(ext, argv)
        torch.cuda.synchronize()
        got = _counts()
        steps = len(tasks) * LN_ITERS
        assert got == _train_expect(dev, vit["shapes"], vit_b, steps,
                                    len(tasks) * SEQ_VAL_ITERS, progress,
                                    fisher=steps if fisher else 0, attn=vit["n_attn"]), (ext, got)
        ln_train.append(got)
        regs = [load_registry(os.path.join(folder(ext, tasks, i, True),
                                           "model_final_checkpoint"),
                              torch.device("cpu"), []) for i in range(len(tasks))]
        (mh_a, _, man_a), (mh_b, blob_b, man_b) = regs
        keys = list(mh_b.assemble())
        ln = {t: sorted(k for k in keys if f".ln.{t}." in k) for t in tasks}
        # a weight and a bias in each block's norm1 and norm2 and the final norm
        assert len(ln[tasks[0]]) == len(ln[tasks[1]]) == 2 * (2 * vit["n_attn"] + 1), ln
        assert (man_a["vit"]["ln_tasks"], man_a["vit"]["active_task_idx"]) == (tasks[:1], 0)
        assert (man_b["vit"]["ln_tasks"], man_b["vit"]["active_task_idx"]) == (tasks, 1)
        rec_ext = dict(s=time.perf_counter() - t0, peak=torch.cuda.max_memory_allocated() / 1e9,
                       warm=[probe.warm_step_s(t) for t in tasks], n_ln=len(ln[tasks[0]]) // 2)
        if fisher:
            anchors = {t: sorted(a["params"])
                       for t, a in blob_b["cl_state"]["ewc_tasks"].items()}
            assert anchors == {tasks[0]: ln[tasks[0]],
                               tasks[1]: sorted(ln[tasks[0]] + ln[tasks[1]])}, anchors
            rec_ext["fisher"] = [round(s, 3) for _, s in probe.fisher_s]
            for i in range(len(tasks)):
                _drop_blobs(folder(ext, tasks, i, True))
        else:
            # A's sets through B: no gradient, weight decay alone, within one
            # f32 rounding of the tensor's largest value per step
            worst, moved = 0.0, 0.0
            for k in ln[tasks[0]]:
                a = mh_a.body[k].double()
                want = _decay_only(a, LN_ITERS)
                scale = max(a.abs().max().item(), 1e-30)
                worst = max(worst, (mh_b.body[k].double() - want).abs().max().item()
                            / (LN_ITERS * 2.0 ** -23 * scale))
                moved = max(moved, (mh_b.body[k].double() - a).abs().max().item() / scale)
            assert worst <= 1.0, worst
            rec_ext.update(decay_units=worst, moved=moved)
        ln_rec[ext] = rec_ext
    # -c after B trains nothing
    _reset_counts()
    run_training("sequential", argv + ["-c"])
    assert _counts() == _expect(), _counts()
    # each head of the Sequential run served on its task's images
    _reset_counts()
    ln_dice, ln_batches = {}, []
    for head in tasks:
        out = os.path.join(work, f"ln_seq_{head}")
        run_inference(["3d_fullres", "sequential", "-i", images[head], "-o", out, "-trained_on"]
                      + tasks + ["-use_head", head, "--use_vit", "--task_specific_ln",
                                 "--device", "cuda"])
        ln_batches += _serve_batches(images[head], plans, patch)
        ln_dice[head] = dice_of(out, images[head], labels[head])
    ln_serve = _counts()
    assert ln_serve == _forward_expect(dev, vit["shapes"], ln_batches, vit["n_attn"]), ln_serve
    for i in range(len(tasks)):
        _drop_blobs(folder("sequential", tasks, i, True))
    for ext, r in ln_rec.items():
        print(f"[phase 15] nnUNet_torch_train_{ext} 3d_fullres -t {' '.join(tasks)} --use_vit "
              f"--task_specific_ln --device cuda (V1, ViT base, batch {vit_b}, 1 epoch x "
              f"{LN_ITERS} steps + {SEQ_VAL_ITERS} val batches per task, progress validation): "
              f"{r['s']:.2f} s, warm s/step {[round(w, 4) for w in r['warm']]}, peak "
              f"{r['peak']:.2f} GB, launches == predicted; ln_{tasks[0]} and ln_{tasks[1]} "
              f"({r['n_ln']} LayerNorm sets each) in the registry after {tasks[1]}, manifest "
              f"ln_tasks / active_task_idx {tasks} / 1"
              + (f"; anchors of {tasks[0]} on its {2 * r['n_ln']} ln_{tasks[0]} tensors only, of "
                 f"{tasks[1]} on both tasks' sets; fisher pass s {r['fisher']}"
                 if "fisher" in r else
                 f"; ln_{tasks[0]} through {tasks[1]}: moved by up to {r['moved']:.3e} of each "
                 f"tensor's largest value, equal to weight decay alone (f64 recurrence) within "
                 f"{r['decay_units']:.3f} of the bound ({LN_ITERS} f32 roundings of that value)"),
              flush=True)
    print(f"[phase 15] a -c run after {tasks[1]} trained nothing (all launch counts 0); "
          f"nnUNet_torch_inference sequential -use_head X --use_vit --task_specific_ln "
          f"(every head with the last task's LayerNorms, as the JAX CLI serves them): "
          f"{len(ln_batches)} forwards, launches == predicted, mean foreground Dice "
          + ", ".join(f"head {h} on {h} {d:.4f}" for h, d in ln_dice.items()), flush=True)

    # ---- rematerialization: a multi-head U-Net run with --remat, then one
    # step with and without from the same weights and batch
    n_fused = sum(f for f, _, _ in shapes)
    n_strided = len(shapes) - n_fused
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_training("multihead", ["3d_fullres", "-t", task, "-num_epochs", "1", "-num_iters",
                               str(REMAT_ITERS), "-val_iters", str(SEQ_VAL_ITERS), "--remat",
                               "--device", "cuda"])
    torch.cuda.synchronize()
    remat_s = time.perf_counter() - t0
    remat_peak = torch.cuda.max_memory_allocated() / 1e9
    remat_train = _counts()
    # each train step's forward runs twice (the recompute), validation once
    assert remat_train == _add_counts(
        _train_expect(dev, shapes, b2, REMAT_ITERS, SEQ_VAL_ITERS, []),
        _forward_expect(dev, shapes, [b2] * REMAT_ITERS)), remat_train
    sampler = PatchSampler(stages[task], splits[task]["train"], patch, b2, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in sampler.next_batch().items()
             if k in ("data", "seg")}
    step = {}
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        for remat in (False, True):
            m = unet_from_plans(plans, "3d_fullres", dtype=dtype, remat=remat,
                                generator=torch.Generator().manual_seed(SEED)).to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = _counts()
            loss = deep_supervision_loss(m(batch["data"]), batch["seg"].long(), ds_factors)
            loss.backward()
            torch.cuda.synchronize()
            after = _counts()
            step[(dtype, remat)] = dict(
                loss=loss.item(), peak=(torch.cuda.max_memory_allocated() - base) / 1e9,
                grads={k: torch.zeros_like(p, dtype=torch.float64) if p.grad is None
                       else p.grad.double() for k, p in m.named_parameters()},
                launched={k: after[k] - before[k] for k in (
                    "conv3d_in_lrelu", "instance_norm_leaky", "conv3d_dx",
                    "instance_norm_leaky_bwd")})
            del m, loss
            torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.bfloat16):
        plain, rem = step[(dtype, False)], step[(dtype, True)]
        units, where = _grad_units(rem["grads"], plain["grads"])
        assert abs(rem["loss"] - plain["loss"]) <= 1e-4 and units <= F32_GRAD_LIMIT, \
            (dtype, rem["loss"], plain["loss"], units, where)
        want = {"conv3d_in_lrelu": n_fused, "instance_norm_leaky": n_strided,
                "conv3d_dx": n_fused - 1, "instance_norm_leaky_bwd": n_fused + n_strided}
        assert plain["launched"] == want, plain["launched"]
        assert rem["launched"] == dict(want, conv3d_in_lrelu=2 * n_fused,
                                       instance_norm_leaky=2 * n_strided), rem["launched"]
        step[dtype] = (abs(rem["loss"] - plain["loss"]), units, where)
    f32, b16 = step[torch.float32], step[torch.bfloat16]
    print(f"[phase 15] nnUNet_torch_train_multihead 3d_fullres -t {task} --remat --device "
          f"cuda (full width, batch {b2}, 1 epoch x {REMAT_ITERS} steps + {SEQ_VAL_ITERS} val "
          f"batches): {remat_s:.2f} s, peak {remat_peak:.2f} GB, launches == predicted "
          f"(per step conv3d_in_lrelu {2 * n_fused} = 2 x {n_fused}, instance_norm_leaky "
          f"{2 * n_strided}: every stage's forward again in the backward; conv3d_dx "
          f"{n_fused - 1}, instance_norm_leaky_bwd {n_fused + n_strided} as without); one step "
          f"from the same weights and batch, remat vs not: f32 |loss diff| {f32[0]:.3e} (limit "
          f"1e-4), worst gradient |diff| / (1e-5 + 1e-3 max|g|) {f32[1]:.3f} (limit "
          f"{F32_GRAD_LIMIT}); bf16 {b16[0]:.3e} / {b16[1]:.3f}; peak memory of the step above "
          f"the weights, bf16: {step[(torch.bfloat16, False)]['peak']:.3f} GB without, "
          f"{step[(torch.bfloat16, True)]['peak']:.3f} GB with remat (f32: "
          f"{step[(torch.float32, False)]['peak']:.3f} / "
          f"{step[(torch.float32, True)]['peak']:.3f} GB)", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return {"vit_var_train": _add_counts(*var_train), "vit_var_serve": _add_counts(*var_serve),
            "vit_ln_train": _add_counts(*ln_train), "vit_ln_serve": ln_serve,
            "remat_train": remat_train}


def _orchestration_path(task_dir, plans, shapes, work, pre, results, dev) -> dict:
    """Phase 16: the parameter search, its resume, two workers on the card,
    the refused partition, and the planning and checkpoint-update scripts
    (see the module docstring).  Returns the launch counts of the search run
    in this process (``param_search``)."""
    cfg = plans.config("3d_fullres")
    patch, b2 = tuple(cfg.patch_size), TRAIN_BATCH
    tasks = [os.path.basename(task_dir), "Task098_SynthB"]
    stages, splits = _task_stages(pre, tasks)
    ps_root = os.path.join(work, "param_search")
    argv = ["3d_fullres", "ewc", "-t", *tasks, "-g", "ewc_lambda:0.1,0.4", "-num_epochs", "1",
            "-num_iters", str(SEARCH_ITERS), "--device", "cuda"]
    # per experiment: each task's steps, quick-validation batches and fisher
    # pass, then the evaluation-mode validation (8 mirrors, window batch 4)
    # of every task so far on its 80:20 split's validation cases
    ps_val = {t: _val_batches(stages[t], {"val": param_search_split(splits[t]["train"])[1]},
                              patch) for t in tasks}
    evals = [b * TTA for i in range(len(tasks)) for t in tasks[: i + 1] for b in ps_val[t]]
    val_iters = max(10, SEARCH_ITERS // 5)          # the CLI's
    per_exp = _train_expect(dev, shapes, b2, len(tasks) * SEARCH_ITERS, len(tasks) * val_iters,
                            evals, fisher=len(tasks) * SEARCH_ITERS)

    def search(sub, extra=()):
        os.environ["PARAM_SEARCH_FOLDER"] = os.path.join(ps_root, sub)
        out = os.path.join(ps_root, sub, "3d_fullres", "_".join(tasks), "ewc", "fold_0")
        t0 = time.perf_counter()
        with _CheckpointBytes():        # nothing reads them back
            res = run_param_search(argv + list(extra))
        torch.cuda.synchronize()
        _drop_blobs(os.path.join(ps_root, sub))     # the workers' (on disk)
        return res, out, time.perf_counter() - t0

    torch.backends.cudnn.allow_tf32 = True
    _reset_counts()
    res, out, search_s = search("one")
    ps_launches = _counts()
    assert ps_launches == _add_counts(per_exp, per_exp), ps_launches
    assert sorted(res) == ["exp_0", "exp_1"], sorted(res)
    assert sorted(r["settings"]["ewc_lambda"] for r in res.values()) == [0.1, 0.4]
    for exp_id in res:
        with open(os.path.join(out, exp_id, "experiment_results.csv")) as f:
            rows = f.read().splitlines()
        assert len(rows) == 1 + 3, rows            # after A: A; after B: A, B
    with open(os.path.join(out, "parameter_search_val_summary.csv")) as f:
        assert len(f.read().splitlines()) == 1 + 6
    with open(os.path.join(out, "best_setting.json")) as f:
        best = json.load(f)
    assert best["exp_id"] in res and math.isfinite(best["final_mean_dice"]), best
    dice = {e: r["final_mean_dice"] for e, r in res.items()}
    # the same command again: backup.json holds both, nothing trains
    _reset_counts()
    again, _, _ = search("one")
    assert again == {} and _counts() == _expect(), (again, _counts())
    # two workers sharing the card (spawned processes: their launches are
    # counted there, not here)
    _reset_counts()
    par, par_out, par_s = search("workers", ["-n_workers", "2"])
    assert _counts() == _expect(), _counts()
    assert sorted(par) == ["exp_0", "exp_1"], sorted(par)
    card = torch.cuda.get_device_name(0)
    for r in par.values():
        # no partition: each worker sees what this process sees
        assert (r["device"], r["n_devices"], r["device_name"], r["visible_devices"]) == (
            "cuda", 1, card, os.environ.get("CUDA_VISIBLE_DEVICES")), r
        assert r["device_slot"] in ("0", "1") and math.isfinite(r["final_mean_dice"]), r
    with open(os.path.join(par_out, "backup.json")) as f:
        assert json.load(f)["finished"] == ["exp_0", "exp_1"]
    # one card per worker for two workers: refused before any worker starts
    try:
        search("refused", ["-n_workers", "2", "-devices_per_exp", "1"])
    except RuntimeError as e:
        refusal = str(e)
    else:
        raise AssertionError("a partition over 2 cards ran on a host with 1")
    assert not os.path.exists(os.path.join(ps_root, "refused", "3d_fullres", "_".join(tasks),
                                           "ewc", "fold_0", "backup.json"))
    print(f"[phase 16] nnUNet_torch_parameter_search 3d_fullres ewc -t {' '.join(tasks)} -g "
          f"ewc_lambda:0.1,0.4 -num_epochs 1 -num_iters {SEARCH_ITERS} --device cuda: 2 "
          f"experiments in {search_s:.2f} s, launches == predicted (per experiment per task "
          f"{SEARCH_ITERS} steps + {val_iters} val batches + a {SEARCH_ITERS}-batch fisher pass, "
          f"then evaluation forwards {evals}), final mean Dice {dice}, best setting "
          f"{best['settings']} ({best['exp_id']}); experiment_results.csv per experiment, the "
          f"summary and best_setting.json written; the same command again trained nothing "
          f"(backup.json, all launch counts 0); -n_workers 2 on the one card: both experiments "
          f"in {par_s:.2f} s, each worker reporting {card} (1 device, slots "
          f"{sorted(r['device_slot'] for r in par.values())}), final mean Dice "
          f"{ {e: round(r['final_mean_dice'], 4) for e, r in par.items()} }; -n_workers 2 "
          f"-devices_per_exp 1 refused before any worker: {refusal}", flush=True)

    # nnUNet_torch_plan_and_preprocess on a copy of task A's raw data
    saved = {k: os.environ.get(k) for k in ("nnUNet_raw_data_base", "nnUNet_preprocessed",
                                            "RESULTS_FOLDER")}
    try:
        copy_raw = os.path.join(work, "pp_copy", "raw")
        shutil.copytree(task_dir, os.path.join(copy_raw, "nnUNet_raw_data", tasks[0]))
        os.environ.update(nnUNet_raw_data_base=copy_raw,
                          nnUNet_preprocessed=os.path.join(work, "pp_copy", "pre"))
        t0 = time.perf_counter()
        plan_and_preprocess_main(["-t", tasks[0], "-pl", "3d_fullres"])
        pp_s = time.perf_counter() - t0
        copy_plans = Plans.load(plans_path(os.path.join(work, "pp_copy", "pre", tasks[0])))
        assert copy_plans.config("3d_fullres") == cfg, copy_plans.config("3d_fullres")
        copy_stage = PreprocessedDataset(os.path.join(work, "pp_copy", "pre", tasks[0],
                                                      "nnUNetData_plans_v2.1_3d_fullres"))
        assert copy_stage.cases == stages[tasks[0]].cases
        # nnUNet_torch_update_checkpoints on a copy of phase 15's task-LN
        # results (its manifests: the .pt files hold no path), then back
        # with nnUNet_torch_update_checkpoints_all over the copy
        src = os.path.join(results, "nnUNet_ext", "3d_fullres", "_".join(tasks))
        copy_res = os.path.join(work, "results_copy")
        shutil.copytree(src, os.path.join(copy_res, "nnUNet_ext", "_".join(tasks)),
                        ignore=shutil.ignore_patterns("*.pt", "val_metrics*", "progress.json"))

        def json_text(root):
            out = {}
            for d, _, files in os.walk(root):
                for f in files:
                    if f.endswith(".json"):
                        with open(os.path.join(d, f)) as fh:
                            out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
            return out
        def naming(text, name):
            """Whether a string value (not a key) of the JSON ``text`` holds ``name``."""
            def strings(obj):
                if isinstance(obj, str):
                    yield obj
                elif isinstance(obj, (list, dict)):
                    for v in obj.values() if isinstance(obj, dict) else obj:
                        yield from strings(v)
            return any(name in v for v in strings(json.loads(text)))
        before = json_text(copy_res)
        holding = sum(naming(v, tasks[0]) for v in before.values())
        moved = tasks[0].replace("Synth", "Moved")
        update_checkpoints.main(["-path", copy_res, "-old", tasks[0], "-new", moved])
        after = json_text(copy_res)
        assert not any(naming(v, tasks[0]) for v in after.values()) and holding, holding
        assert sum(a != before[k] for k, a in after.items()) == holding
        os.environ["RESULTS_FOLDER"] = copy_res
        update_checkpoints.main_all(["-old", moved, "-new", tasks[0]])
        assert {k: json.dumps(json.loads(v), sort_keys=True)
                for k, v in json_text(copy_res).items()} == \
            {k: json.dumps(json.loads(v), sort_keys=True) for k, v in before.items()}
    finally:
        for k, v in saved.items():
            os.environ[k] = v
    print(f"[phase 16] nnUNet_torch_plan_and_preprocess -t {tasks[0]} -pl 3d_fullres on a copy "
          f"of its raw data: {pp_s:.2f} s, the same 3d_fullres plan and "
          f"{len(copy_stage.cases)} preprocessed cases; nnUNet_torch_update_checkpoints on a "
          f"copy of phase 15's task-LN results ({len(before)} JSON manifests): {holding} naming "
          f"{tasks[0]} rewritten to {moved}, none left; "
          f"nnUNet_torch_update_checkpoints_all back over the copy gives the original JSON; "
          f"the work folder now holds {_tree_gb(work):.1f} GB", flush=True)
    return {"param_search": ps_launches}


def _case_dice(folder, labels, classes) -> list:
    """Per case (in ``labels`` order) the foreground Dice of a folder of
    segmentations."""
    out = []
    for case, label in labels.items():
        seg = np.asarray(read_image(os.path.join(folder, f"{case}.nii.gz")).data)
        lab = np.asarray(read_image(label).data)
        assert seg.shape == lab.shape and int(seg.max()) < classes, (case, seg.shape)
        out.append([round(d, 4) for d in subject_metrics(seg, lab, classes)["Dice"]])
    return out


def _agreement(folder_a, folder_b, cases) -> float:
    """The smallest share of voxels on which two folders' segmentations agree."""
    return min(float((np.asarray(read_image(os.path.join(folder_a, f"{c}.nii.gz")).data)
                      == np.asarray(read_image(os.path.join(folder_b, f"{c}.nii.gz")).data))
                     .mean()) for c in cases)


def _2d_path(task_dir, images, labels, work, pre, results, dev, gen) -> tuple:
    """Phase 17 (a): the 2d configuration of phase 4's task through its entry
    points (see the module docstring).  Returns the launch counts of its
    training (``2d_train``) and of its serving and evaluation
    (``2d_serve``), and the InstanceNorm checks' largest errors ({"fwd" |
    "bwd": error})."""
    task = os.path.basename(task_dir)
    t0 = time.perf_counter()
    plan_and_preprocess([task_dir], pre, configs=("2d",), verbose=False)
    prep_s = time.perf_counter() - t0
    plans = Plans.load(plans_path(os.path.join(pre, task)))
    cfg = plans.config("2d")
    got = {"patch_size": list(cfg.patch_size), "batch_size": cfg.batch_size,
           "pool_op_kernel_sizes": [list(k) for k in cfg.pool_op_kernel_sizes]}
    assert got == PLAN_2D and (cfg.base_num_features, cfg.max_num_features) == (32, 512), got
    patch, batch, classes = tuple(cfg.patch_size), cfg.batch_size, plans.num_classes + 1
    model = unet_from_plans(plans, "2d", dtype=torch.bfloat16, deep_supervision=False,
                            generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
    blocks = _named_blocks(model, patch, dev)
    # every conv of the 2D U-Net is cuDNN's, each followed by the InstanceNorm
    assert {model_block.route((batch,) + i) for _, model_block, i, _ in blocks} == {"conv"}
    stage = PreprocessedDataset(os.path.join(pre, task, "nnUNetData_plans_v2.1_2d"))
    split = final_splits(os.path.join(pre, task), stage.cases)[0]

    def pairs(shape):
        """(slice, window) pairs of a [D, H, W] volume."""
        return shape[0] * len(window_grid(shape[1:], patch)[2])

    # the progress validation after the epoch: each val case's pairs in
    # batches of 4, no mirroring
    progress = [min(4, n - i) for n in (pairs(stage.load(c).shape[1:]) for c in split["val"])
                for i in range(0, n, 4)]

    torch.backends.cudnn.allow_tf32 = True
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _SequenceProbe() as probe:
        run_training("sequential", ["2d", "-t", task, "-num_epochs", "1", "-num_iters",
                                    str(CFG2D_ITERS), "-val_iters", str(SEQ_VAL_ITERS),
                                    "--use_progress_val", "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = _counts()
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    steps = CFG2D_ITERS
    expect = _path_expect(blocks, model, dev, [(batch, steps + SEQ_VAL_ITERS, steps)]
                          + [(b, 1, 0) for b in progress])
    assert train_launches == expect, (train_launches, expect)
    assert train_launches["conv3d_in_lrelu"] == train_launches["conv3d_dx"] == 0
    folder = build_output_folder(os.path.join(results, "nnUNet_ext"), "2d", [task], [task],
                                 trainer_name("sequential"), plans.plans_name, 0, True)
    with open(os.path.join(folder, "progress.json")) as f:
        losses = json.load(f)["step_losses"]
    assert len(losses) == steps and all(map(math.isfinite, losses)), losses
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    assert last5 < first5, (first5, last5)
    with open(os.path.join(folder, "val_metrics.json")) as f:
        val = json.load(f)[-1]["results"][task]["subjects"]
    assert sorted(val) == sorted(split["val"]), val
    val_dice = [[round(d, 4) for d in m["Dice"]] for m in val.values()]

    # serving phase 4's folder through the CLI (the stream; each volume
    # slice by slice, (slice, window) pairs in batches of 8 x 4 mirrors),
    # then the evaluation CLI (the val split, TTA, batches of 4 x 4)
    served = os.path.join(work, "seg_2d")
    volumes = [preprocess_for_inference(files, plans, "2d")[0]
               for _, files in case_files(images)]
    serve_b = _stream_batches(volumes, patch)
    assert set(serve_b) <= {4 * b for b in range(1, WINDOW_BATCH + 1)}, serve_b
    eval_b = [4 * min(4, n - i) for n in (pairs(stage.load(c).shape[1:]) for c in split["val"])
              for i in range(0, n, 4)]
    os.environ["EVALUATION_FOLDER"] = os.path.join(work, "evaluation")
    _reset_counts()
    t0 = time.perf_counter()
    run_inference(["2d", "nnUNetTrainerSequential", "-i", images, "-o", served, "-trained_on",
                   task, "--device", "cuda"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_evaluation(["2d", "nnUNetTrainerSequential", "-trained_on", task, "-evaluate_on", task,
                    "--device", "cuda"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    serve_launches = _counts()
    expect = _path_expect(blocks, model, dev, [(b, 1, 0) for b in serve_b + eval_b])
    assert serve_launches == expect, (serve_launches, expect)
    evaluated = os.path.join(work, "evaluation", "nnUNet_ext",
                             os.path.relpath(folder, os.path.join(results, "nnUNet_ext")))
    with open(os.path.join(evaluated, "val_metrics_eval.json")) as f:
        scored = json.load(f)[-1]["results"][task]["subjects"]
    eval_dice = [[round(d, 4) for d in m["Dice"]] for m in scored.values()]
    dice = _case_dice(served, labels, classes)

    # the kernel route's segmentations against the plain route's, same
    # weights, bf16 (the two round differently: voxels within bf16 roundoff
    # of a tie may go either way), and the largest case's f32 probabilities
    # of both routes (2D over 3D, TTA)
    ckpt = os.path.join(folder, "model_final_checkpoint")
    m, _, _ = restore_model(ckpt, dev, use_kernels=False)
    plain_dir = os.path.join(work, "seg_2d_plain")
    predict_from_folder([m], plans, "2d", images, plain_dir, device=dev,
                        window_batch=WINDOW_BATCH)
    del m
    agree = _agreement(served, plain_dir, labels)
    assert agree >= ROUTE_AGREE_2D, agree
    big = max(volumes, key=lambda v: v.size)
    probs = {}
    before = _counts()
    for use_kernels in (True, False):
        m, _, _ = restore_model(ckpt, dev, use_kernels=use_kernels)
        m.dtype = torch.float32
        probs[use_kernels] = predict_sliding_window(m, big, patch, classes, device=dev,
                                                    window_batch=WINDOW_BATCH)
        del m
    assert _counts()["instance_norm_leaky"] > before["instance_norm_leaky"]
    assert probs[True].shape == big.shape[:-1] + (classes,) and np.isfinite(probs[True]).all()
    prob_err = float(np.abs(probs[True] - probs[False]).max())
    assert prob_err <= 1e-3, prob_err
    # the InstanceNorm kernels against their plain versions at every (C,
    # H*W) of the 2D U-Net: the forward at the train batch and the serving
    # batch (8 pairs x 4 mirrors), the backward at the train batch, f32 and
    # bf16, each launch in the form the launch plan predicts
    in_err = _in_checks(_in_shapes(blocks, dict.fromkeys((n for n, *_ in blocks), "conv")),
                        (batch, 4 * WINDOW_BATCH), (batch,), dev, gen)
    in_shapes = sorted(set(_rows([o for *_, o in blocks])), key=lambda r: -r[1])
    print(f"[phase 17] 2d configuration of {task}: patch {patch}, batch {batch}, pools "
          f"{cfg.pool_op_kernel_sizes}, {cfg.base_num_features}->{cfg.max_num_features} "
          f"features, {len(blocks)} conv blocks (cuDNN conv + the InstanceNorm kernel at "
          f"(C, H*W) {in_shapes}); preprocessing {prep_s:.2f} s; nnUNet_torch_train_sequential "
          f"2d --use_progress_val, 1 epoch x {steps} steps + {SEQ_VAL_ITERS} val batches: "
          f"{train_s:.2f} s, warm s/step {probe.warm_step_s(task):.4f}, progress validation "
          f"{[round(v, 3) for v in probe.val_s]} s ({len(progress)} forwards of {set(progress)}"
          f"), peak {train_peak:.2f} GB; loss first 5 {first5:.4f} -> last 5 {last5:.4f}; "
          f"launches {train_launches} == predicted (per step {len(blocks)} IN forward, "
          f"{len(blocks)} IN backward, no fused conv, no data-gradient kernel); validation "
          f"Dice {val_dice}", flush=True)
    print(f"[phase 17] nnUNet_torch_inference 2d on {len(labels)} cases (the stream; each "
          f"volume slice by slice: {len(serve_b)} forwards, batches {sorted(set(serve_b))} = "
          f"pairs x 4 mirrors): {serve_s:.2f} s ({serve_s / len(labels):.3f} s/volume, first "
          f"run), Dice {dice}; nnUNet_torch_evaluate 2d: {eval_s:.2f} s ({len(eval_b)} "
          f"forwards), Dice {eval_dice}; launches {serve_launches} == predicted; kernel route "
          f"vs plain route segmentations (bf16) agree on {agree:.6f} of voxels (limit "
          f"{ROUTE_AGREE_2D}); the largest case {big.shape[:-1]} in f32, max |probs kernel - "
          f"plain| {prob_err:.3e} (limit 1e-3); the InstanceNorm kernels against their plain "
          f"versions at every (C, H*W) above, forward at B={batch} and "
          f"{4 * WINDOW_BATCH}, backward at B={batch}, f32 and bf16, every launch in "
          f"its planned form: max err forward {in_err['fwd']:.3e}, backward "
          f"{in_err['bwd']:.3e} (IN_TOL)", flush=True)
    return {"2d_train": train_launches, "2d_serve": serve_launches}, in_err


def _stream_path(images, labels, plans, shapes, base, dev) -> dict:
    """Phase 17 (b): phase 4's folder through ``predict_from_folder`` at its
    default (the volume stream) and case by case (``volume_batch=1``), in
    turns (stream, per case, per case, stream), from the checkpoint ``base``
    (phase 6's trained model: random weights leave many voxels within
    roundoff of a tie).  Returns the launch counts of the four runs
    (``stream_serve``)."""
    cfg = plans.config("3d_fullres")
    patch, classes = tuple(cfg.patch_size), plans.num_classes + 1
    m, _, _ = restore_model(base, dev)
    volumes = [preprocess_for_inference(files, plans, "3d_fullres")[0]
               for _, files in case_files(images)]
    runs = {8: _stream_batches(volumes, patch), 1: _stream_batches(volumes, patch,
                                                                  volume_batch=1)}
    out = {vb: os.path.join(os.path.dirname(images), f"seg_stream_vb{vb}") for vb in runs}
    secs = {vb: [] for vb in runs}
    _reset_counts()
    for vb in (8, 1, 1, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_from_folder([m], plans, "3d_fullres", images, out[vb], device=dev,
                            window_batch=WINDOW_BATCH, volume_batch=vb)
        torch.cuda.synchronize()
        secs[vb].append((time.perf_counter() - t0) / len(volumes))
    launches = _counts()
    assert launches == _forward_expect(dev, shapes, 2 * (runs[8] + runs[1])), launches
    agree = _agreement(out[8], out[1], labels)
    assert agree >= STREAM_AGREE, agree
    stream = predict_sliding_window_multi(m, volumes, patch, classes, device=dev,
                                          window_batch=WINDOW_BATCH, output="probs_bf16",
                                          volume_batch=VOLUME_BATCH)
    diff = max(float(np.abs(p - predict_sliding_window(
        m, v, patch, classes, device=dev, window_batch=WINDOW_BATCH,
        output="probs_bf16")).max()) for p, v in zip(stream, volumes))
    del m
    print(f"[phase 17] the volume stream on phase 4's {len(volumes)} cases: "
          f"predict_from_folder at its default (volume_batch {VOLUME_BATCH}, {len(runs[8])} "
          f"forwards of {runs[8]}) vs volume_batch 1 ({len(runs[1])} forwards of {runs[1]}), "
          f"in turns: {statistics.median(secs[8]):.4f} vs {statistics.median(secs[1]):.4f} "
          f"s/volume, synchronized (runs {[round(t, 4) for t in secs[8]]} vs "
          f"{[round(t, 4) for t in secs[1]]}); launches {launches} == predicted; "
          f"segmentations agree on {agree:.6f} of voxels (limit {STREAM_AGREE}); largest "
          f"|stream - per case| of the bf16 probabilities {diff:.3e} (recorded)", flush=True)
    return {"stream_serve": launches}


def _cascade_path(work, pre, results, dev, gen) -> dict:
    """Phase 17 (c): the 3d_lowres -> cascade stage (see the module
    docstring).  Returns the launch counts of the lowres training
    (``lowres_train``), the stage's preparation (``cascade_prepare``) and
    the cascade's training with its validation (``cascade_train``), the
    FMA launches of the two stages' f32 step checks, and the largest errors
    of their kernel checks ({"fwd" | "bwd" | "conv" | "dx": error})."""
    secs, peak = {}, {}

    def stage_run(name, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        return out

    c_dir = stage_run("task", lambda: make_synthetic_task(
        os.path.join(work, "raw", "nnUNet_raw_data"), **CASCADE_TASK))
    task = os.path.basename(c_dir)
    stage_run("plan_and_preprocess", lambda: plan_and_preprocess(
        [c_dir], pre, configs=("3d_lowres", "3d_fullres"), verbose=False))
    plans = Plans.load(plans_path(os.path.join(pre, task)))
    got = {c: {"patch_size": list(plans.config(c).patch_size),
               "batch_size": plans.config(c).batch_size} for c in CASCADE_PLANS}
    assert got == CASCADE_PLANS, got
    low_cfg, full_cfg = plans.config("3d_lowres"), plans.config("3d_fullres")
    low_patch, full_patch = tuple(low_cfg.patch_size), tuple(full_cfg.patch_size)
    stages = {c: PreprocessedDataset(os.path.join(pre, task, f"nnUNetData_plans_v2.1_{c}"))
              for c in CASCADE_PLANS}
    split = final_splits(os.path.join(pre, task), stages["3d_fullres"].cases)[0]
    assert len(split["train"]) == len(split["val"]) == 1, split
    low_model = unet_from_plans(plans, "3d_lowres", dtype=torch.bfloat16,
                                deep_supervision=False, **CT_ROUTES).to(dev).eval()
    low_blocks = _named_blocks(low_model, low_patch, dev)
    low_routes = _ct_work(low_blocks, low_model, TRAIN_BATCH)["route"]
    b2, steps, vals = TRAIN_BATCH, CASCADE_ITERS, CASCADE_VAL_ITERS

    def windows(shape, patch):
        return len(window_grid(shape, patch)[2])

    def val_runs(stage, patch, batch=SEQ_WINDOW_BATCH):
        """The progress validation's forwards over the val case: (batch, 1, 0)."""
        n = windows(stage.load(split["val"][0]).shape[1:], patch)
        return [(min(batch, n - i), 1, 0) for i in range(0, n, batch)]

    # -- the lowres stage through the CLI, both CT switches on (phase 4)
    torch.backends.cudnn.allow_tf32 = True
    _reset_counts()
    with _SequenceProbe() as low_probe:
        stage_run("lowres_train", lambda: run_training(
            "sequential", ["3d_lowres", "-t", task, "-num_epochs", "1", "-num_iters", str(steps),
                           "-val_iters", str(vals), "--use_progress_val", "--device", "cuda"]))
    low_launches = _counts()
    expect = _path_expect(low_blocks, low_model, dev, [(b2, steps + vals, steps)]
                          + val_runs(stages["3d_lowres"], low_patch))
    assert low_launches == expect, (low_launches, expect)
    assert low_launches["pack_blocks.scalar"] == 0, low_launches
    assert min(low_launches[k] for k in CASCADE_KERNELS) > 0, low_launches
    low_folder = build_output_folder(os.path.join(results, "nnUNet_ext"), "3d_lowres", [task],
                                     [task], trainer_name("sequential"), plans.plans_name, 0,
                                     True)
    with open(os.path.join(low_folder, "progress.json")) as f:
        low_losses = json.load(f)["step_losses"]
    assert len(low_losses) == steps and all(map(math.isfinite, low_losses)), low_losses
    low_grid = {name: tuple(s // m.packed_bs((b2,) + i) for s in i[1:])
                for name, m, i, _ in low_blocks if low_routes[name] == "blocked"}
    assert CASCADE_GRID in low_grid.values(), low_grid

    # -- the cascade stage through nnUNet_torch_prepare_cascade: each lowres
    # case's windows in batches of 8, no mirroring
    low_ckpt = os.path.join(low_folder, "model_final_checkpoint")
    prep_b = [(min(8, n - i), 1, 0) for n in (windows(stages["3d_lowres"].load(c).shape[1:],
                                                      low_patch)
                                               for c in stages["3d_fullres"].cases)
              for i in range(0, n, 8)]
    _reset_counts()
    stage_run("cascade_prepare", lambda: prepare_cascade.main(
        ["-t", task, "-ckpt", low_ckpt, "--device", "cuda"]))
    prep_launches = _counts()
    expect = _path_expect(low_blocks, low_model, dev, prep_b)
    assert prep_launches == expect, (prep_launches, expect)
    low_checks = _stage_checks(low_blocks, low_model, low_routes, dev, gen)
    del low_model

    # the f32 step check of phase 6 on the lowres model, on the CT routes
    low_sampler = PatchSampler(stages["3d_lowres"], stages["3d_lowres"].cases, low_patch, b2,
                               seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in low_sampler.next_batch().items()
             if k in ("data", "seg")}

    def low_unet(dtype, use_kernels):
        return unet_from_plans(plans, "3d_lowres", dtype=dtype, use_kernels=use_kernels,
                               generator=torch.Generator().manual_seed(SEED),
                               **(CT_ROUTES if use_kernels else DIRECT_ROUTES))

    fma_low, low_step_text = _step_check(
        low_unet, batch, tuple(ds_scale_factors(low_cfg.pool_op_kernel_sizes)), dev)
    del batch
    torch.cuda.empty_cache()
    cascade_dir = prepare_cascade.cascade_stage_dir(pre, task)
    cascade = PreprocessedDataset(cascade_dir)
    assert cascade.cases == stages["3d_fullres"].cases, cascade.cases
    onehot_fg = []
    for case in cascade.cases:
        arr = cascade.load(case)
        full = stages["3d_fullres"].load(case)
        assert arr.shape == (plans.num_modalities + plans.num_classes + 1,) + full.shape[1:]
        oh = np.asarray(arr[1:1 + plans.num_classes])
        assert bool(((oh == 0) | (oh == 1)).all()) and not (oh.sum(0) > 1).any(), case
        onehot_fg.append(round(float(oh.mean(axis=(1, 2, 3)).sum()), 5))
        del arr, oh

    # -- the cascade's fullres stage through the trainer API
    casc_model = unet_from_plans(plans, "3d_fullres", dtype=torch.bfloat16,
                                 deep_supervision=False, in_channels=3,
                                 **CT_ROUTES).to(dev).eval()
    casc_blocks = _named_blocks(casc_model, full_patch, dev)
    casc_routes = _ct_work(casc_blocks, casc_model, b2)["route"]
    casc_out = os.path.join(results, "cascade", task)
    opts = TrainerOptions(num_epochs=1, iters_per_epoch=steps, val_iters=vals,
                          use_progress_val=True, device="cuda")
    torch.backends.cudnn.allow_tf32 = True   # as every main path (the checks above unset it)
    _reset_counts()
    def train_cascade():
        trainer = CascadeFullResTrainer(plans, "3d_fullres", casc_out, opts)
        trainer.train_task(task, cascade_dir)
        return trainer

    with _SequenceProbe() as casc_probe:
        trainer = stage_run("cascade_train", train_cascade)
    casc_launches = _counts()
    expect = _path_expect(casc_blocks, casc_model, dev, [(b2, steps + vals, steps)]
                          + val_runs(cascade, full_patch))
    assert casc_launches == expect, (casc_launches, expect)
    assert casc_launches["pack_blocks.scalar"] == 0, casc_launches
    assert min(casc_launches[k] for k in CASCADE_KERNELS) > 0, casc_launches
    assert trainer.in_channels == 3 and all(map(math.isfinite, trainer.step_losses))
    ((_, val),) = trainer._val_history[-1]["results"].items()
    casc_dice = [[round(d, 4) for d in m["Dice"]] for m in val["subjects"].values()]
    again = restore_trainer(os.path.join(casc_out, "model_final_checkpoint"),
                            TrainerOptions(device="cuda"))
    assert type(again) is CascadeFullResTrainer and again.in_channels == 3
    assert again.model.enc0.block0.conv.in_channels == 3 and again.mh.tasks == [task]
    del trainer, again
    torch.cuda.empty_cache()
    casc_checks = _stage_checks(casc_blocks, casc_model, casc_routes, dev, gen)
    del casc_model
    # the f32 step check of phase 6 on the cascade model, on the CT routes
    # (its first conv, Cin = 3, blocked)
    sampler = PatchSampler(cascade, cascade.cases, full_patch, b2, seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in sampler.next_batch().items()
             if k in ("data", "seg")}
    assert batch["data"].shape[1] == 3

    def casc_unet(dtype, use_kernels):
        return unet_from_plans(plans, "3d_fullres", dtype=dtype, use_kernels=use_kernels,
                               generator=torch.Generator().manual_seed(SEED), in_channels=3,
                               **(CT_ROUTES if use_kernels else DIRECT_ROUTES))

    fma_step, step_text = _step_check(
        casc_unet, batch, tuple(ds_scale_factors(full_cfg.pool_op_kernel_sizes)), dev)
    del batch
    torch.cuda.empty_cache()
    blocked = lambda routes: [n for n, r in routes.items() if r == "blocked"]  # noqa: E731
    print(f"[phase 17] cascade task {task}: {CASCADE_TASK['num_cases']} cases of "
          f"{CASCADE_TASK['shape']}, plans 3d_lowres patch {low_patch} (spacing "
          f"{[round(s, 3) for s in low_cfg.spacing]}, pools {low_cfg.pool_op_kernel_sizes}), "
          f"3d_fullres patch {full_patch}, batch {b2}; seconds "
          f"{ {k: round(v, 2) for k, v in secs.items()} }, peak GB "
          f"{ {k: round(v, 2) for k, v in peak.items() if k not in ('task',)} }", flush=True)
    print(f"[phase 17] nnUNet_torch_train_sequential 3d_lowres (LNN_BLOCKED_CONV=1 "
          f"LNN_UPT_MODE=pallas), 1 epoch x {steps} steps + {vals} val batches + progress "
          f"validation: warm s/step {low_probe.warm_step_s(task):.4f}, loss first 5 "
          f"{statistics.mean(low_losses[:5]):.4f} -> last 5 "
          f"{statistics.mean(low_losses[-5:]):.4f}; routes at B={b2}: blocked "
          f"{blocked(low_routes)} (block grids {low_grid}); launches {low_launches} == "
          f"predicted, every pack in the tma form; nnUNet_torch_prepare_cascade: "
          f"{len(prep_b)} forwards of {[b for b, _, _ in prep_b]}, launches {prep_launches} == "
          f"predicted; the stage's one-hot channels in {{0, 1}}, one class a voxel, "
          f"foreground share per case {onehot_fg}; {low_checks['text']}; {low_step_text}",
          flush=True)
    print(f"[phase 17] CascadeFullResTrainer(...).train_task ({plans.num_modalities} + "
          f"{plans.num_classes} input channels), 1 epoch x {steps} steps + {vals} val batches "
          f"+ sliding-window validation: warm s/step {casc_probe.warm_step_s(task):.4f}, "
          f"validation {[round(v, 2) for v in casc_probe.val_s]} s, Dice {casc_dice}; routes at "
          f"B={b2}: blocked {blocked(casc_routes)}; launches {casc_launches} == predicted; "
          f"restore_trainer gives CascadeFullResTrainer with in_channels 3; "
          f"{casc_checks['text']}; {step_text}", flush=True)
    errs = {k: max(low_checks[k], casc_checks[k]) for k in ("fwd", "bwd", "conv", "dx")}
    return ({"lowres_train": low_launches, "cascade_prepare": prep_launches,
             "cascade_train": casc_launches},
            {"lowres_train_f32_step": fma_low, "cascade_train_f32_step": fma_step}, errs)


def _stage_checks(blocks, model, routes, dev, gen) -> dict:
    """Phase 17: every kernel of a CT-routed stage against its plain version
    at the stage's shapes: the copy kernels (:func:`_ct_copy_phase`) bit
    for bit at the train batch and the serving batch of 8, every pack in
    the tma form; the fused conv at every stride-1 shape (the first at the
    stage's Cin) and its data gradient (:func:`_ct_conv_phase`) at the train
    batch; the InstanceNorm (:func:`_in_checks`) after every cuDNN and
    blocked conv at both batches and its backward at every conv output at
    the train batch.  Returns the largest errors and a line of text."""
    torch.backends.cudnn.allow_tf32 = False     # the plain versions in true f32
    copies = _ct_copy_phase(blocks, model, dev, gen, (TRAIN_BATCH, WINDOW_BATCH),
                            timed=False)
    conv = _ct_conv_phase(blocks, dev, gen, (TRAIN_BATCH,))
    in_err = _in_checks(_in_shapes(blocks, routes), (TRAIN_BATCH, WINDOW_BATCH),
                        (TRAIN_BATCH,), dev, gen)
    torch.cuda.empty_cache()
    shapes = {k: copies[k]["shapes"] for k in ("pack_blocks", "unpack_blocks",
                                               "interleave_up2", "deinterleave2")}
    text = (f"kernels against their plain versions at B={TRAIN_BATCH} and "
            f"{WINDOW_BATCH}: the copy kernels bit for bit at {shapes} (shape, dtype) "
            f"pairs, the octant upsample's max err "
            f"{ {str(d).replace('torch.', ''): f'{e:.3e}' for d, e in copies['up_err'].items()} }"
            f"; the fused conv at {conv['shapes']} stride-1 blocks (first Cin "
            f"{blocks[0][2][0]}) max err {conv['err']:.3e}, its data gradient at "
            f"{conv['dx_shapes']} max err {conv['dx_err']:.3e} (bf16, atol 5e-2 + rtol 1e-2); "
            f"the InstanceNorm forward max err {in_err['fwd']:.3e}, backward "
            f"{in_err['bwd']:.3e} (IN_TOL, f32 and bf16, every launch in its planned form)")
    return {**in_err, "conv": conv["err"], "dx": conv["dx_err"], "text": text}


def _multi_rank(device, plans, task, stage, runs, devices, tf32) -> list:
    """One rank of phase 18: the gloo / NCCL probe of the collectives the
    port uses on CUDA tensors, then for each of ``runs`` [(output folder,
    model_parallel, vit)] ``MULTI_STEPS`` train steps of the full-width
    U-Net (``vit``: the V1 ViT-U-Net, ViT-base) through the trainer at
    ``n_devices = len(devices)``, each with its launch counts.  Rank 0
    returns every rank's records, by run."""
    import torch.distributed as dist
    from lifelong_nnunet_tpu_torch.training.trainers.sequential import BaseUNetTrainer

    torch.backends.cudnn.allow_tf32 = tf32
    rank = dist.get_rank()
    probe = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((4,), float(rank + 1), device=device, dtype=dtype)
        for name, op in (("all_reduce", lambda t: dist.all_reduce(t)),
                         ("all_gather", lambda t: dist.all_gather(
                             [torch.empty_like(t) for _ in devices], t)),
                         ("broadcast", lambda t: dist.broadcast(t, 0))):
            try:
                op(x.clone())
                probe[f"{name}.{str(dtype)[6:]}"] = "ok"
            except (RuntimeError, ValueError) as e:
                probe[f"{name}.{str(dtype)[6:]}"] = f"{type(e).__name__}: {str(e)[:80]}"
    records = []
    for out, mp, vit in runs:
        opts = TrainerOptions(num_epochs=1, iters_per_epoch=MULTI_STEPS, val_iters=MULTI_VAL,
                              save_every=1, device=device, n_devices=len(devices),
                              model_parallel=mp, devices=tuple(devices), use_vit=vit)
        t0 = time.perf_counter()
        tr = BaseUNetTrainer(plans, "3d_fullres", out, opts)
        reduce_s = []
        if tr.dp is not None:
            inner = tr.dp.all_reduce_grads

            def timed(tensors, inner=inner, reduce_s=reduce_s):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                inner(tensors)
                torch.cuda.synchronize()
                reduce_s.append(time.perf_counter() - t1)
            tr.dp.all_reduce_grads = timed
        _reset_counts()
        with _CheckpointBytes(keep=MULTI_KEEP):
            tr.train_task(task, stage)
        torch.cuda.synchronize()
        lo, hi = tr._sampler_shard()["rows"]
        records.append({"rank": rank, "counts": _counts(), "probe": probe,
                        "param_bytes": param_bytes(tr.model), "local_batch": hi - lo,
                        "reduce_ms": [1e3 * t for t in reduce_s],
                        "seconds": time.perf_counter() - t0, "losses": tr.step_losses,
                        "backend": tr.mesh.backend})
        del tr
        torch.cuda.empty_cache()
    out_list = [None] * len(devices)
    dist.all_gather_object(out_list, records)
    return [[ranks[i] for ranks in out_list] for i in range(len(runs))]


def _update_rtol(base, ref, other) -> float:
    """|d_other - d_ref| / |d_ref| over every parameter, d the change from
    the ``before_training`` checkpoint ``base``."""
    def params(path):
        blob = torch.load(path + ".pt", map_location="cpu", weights_only=True)
        return {**blob["body"], **next(iter(blob["heads"].values()))}
    p0, p1, p2 = params(base), params(ref), params(other)
    num = sum(float(((p2[k] - p0[k]) - (p1[k] - p0[k])).float().square().sum()) for k in p0)
    den = sum(float((p1[k] - p0[k]).float().square().sum()) for k in p0)
    return math.sqrt(num / den)


def _multi_device_path(task_dir, plans, shapes, vit_shapes, images, trained, ct_stage, work,
                       pre, results, dev, gen) -> dict:
    """Phase 18: the port's multi-device paths on the card.  Data parallel 2
    and model parallel 2 (the full-width U-Net, ``MULTI_STEPS`` steps,
    augmentation on) through the trainer over two ranks: on ``cuda:0`` and
    ``cuda:1`` over NCCL when the host has two GPUs, else both on ``cuda:0``
    over gloo (NCCL refuses two ranks on one device); each rank's launches
    against the prediction, each run's parameter update against one
    device's within ``MULTI_UPDATE_RTOL`` (bf16), the per-rank parameter
    bytes; the V1 ViT-U-Net (ViT-base) at model parallel 2 likewise, its
    flash attention on every rank; the fused conv, its data gradient and the InstanceNorm kernels
    against their plain versions at each layout's shapes (a rank's batch,
    its half of the channels under model parallel).  Then the sharded
    serving of phase 4's cases over two device slots against the
    per-volume path, voxel for voxel, and the patch gather native vs numpy
    at the CT patch."""
    task = os.path.basename(task_dir)
    stage = os.path.join(pre, task, "nnUNetData_plans_v2.1_3d_fullres")
    devices = ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 else ["cuda:0"] * 2
    backend = backend_for(devices)
    native_gather.load()   # built here, before any rank starts
    tf32 = torch.backends.cudnn.allow_tf32
    base = os.path.join(work, "multi")
    single = {}
    for vit in (False, True):
        single[vit] = os.path.join(base, "world1_vit" if vit else "world1")
        tr1 = get_trainer("base_v2")(plans, "3d_fullres", single[vit], TrainerOptions(
            num_epochs=1, iters_per_epoch=MULTI_STEPS, val_iters=MULTI_VAL, save_every=1,
            device=str(dev), use_vit=vit))
        with _CheckpointBytes(keep=MULTI_KEEP):
            tr1.train_task(task, stage)
        single[f"bytes{vit}"] = param_bytes(tr1.model)
        del tr1
    paths, texts, bytes_ = {}, [], {}
    batch = plans.config("3d_fullres").batch_size
    layouts = (("dp2", 1, False), ("mp2", 2, False), ("vit_mp2", 2, True))
    t0 = time.perf_counter()
    by_run = spawn(_multi_rank, (plans, task, stage,
                                 [(os.path.join(base, n), mp, vit) for n, mp, vit in layouts],
                                 devices, tf32), devices, rdzv_dir=base, threads=4)
    wall = time.perf_counter() - t0
    for (name, mp, vit), records in zip(layouts, by_run):
        out = os.path.join(base, name)
        probe = records[0]["probe"]
        assert all(r["backend"] == backend for r in records), records[0]["backend"]
        # the trainer halves the ViT-U-Net's batch, as the JAX trainer does
        local = (batch // 2 if vit else batch) // (2 // mp)
        blocks = vit_shapes if vit else shapes
        local_shapes = blocks if mp == 1 else [(f, i, (o[0] // mp,) + tuple(o[1:]))
                                               for f, i, o in blocks]
        want = _train_expect(dev, local_shapes, local, MULTI_STEPS, MULTI_VAL, [],
                             attn=MULTI_VIT_ATTN if vit else 0)
        for r in records:
            assert r["local_batch"] == local, (name, r["local_batch"])
            assert r["counts"] == want, (name, r["rank"], r["counts"], want)
            paths[f"{name}_train.rank{r['rank']}"] = r["counts"]
        assert records[0]["losses"] == records[1]["losses"], [r["losses"] for r in records]
        rtol = _update_rtol(os.path.join(single[vit], "before_training"),
                            os.path.join(single[vit], "model_final_checkpoint"),
                            os.path.join(out, "model_final_checkpoint"))
        assert rtol <= MULTI_UPDATE_RTOL, (name, rtol)
        bytes_[name] = records[0]["param_bytes"]
        reduce = [t for r in records for t in r["reduce_ms"]]
        texts.append(
            f"{name} ({'ViT-U-Net V1, ViT-base, ' if vit else ''}"
            f"{'data 2 x model 1' if mp == 1 else 'data 1 x model 2'}, local batch "
            f"{local} of {batch // 2 if vit else batch}): {records[0]['seconds']:.1f} s on "
            f"rank 0 (set-up, {MULTI_STEPS} steps, {MULTI_VAL} val batch, checkpoints); "
            f"launches per rank == predicted (fused fwd {want['conv3d_in_lrelu']}, IN fwd "
            f"{want['instance_norm_leaky']}, conv dx {want['conv3d_dx']}, IN bwd "
            f"{want['instance_norm_leaky_bwd']}, flash fwd {want['flash_attention']}, "
            f"bwd {want['flash_attention_bwd']}); parameter bytes per rank "
            f"{records[0]['param_bytes']:,} of one device's "
            f"{single[f'bytes{vit}']:,}; losses equal on both ranks; update vs one "
            f"device |d2 - d1| / |d1| = {rtol:.3e} (limit {MULTI_UPDATE_RTOL})"
            + (f"; gradient all-reduce {statistics.median(reduce):.3f} ms/step "
               f"(median over ranks and steps, synchronized: {[round(t, 3) for t in reduce]})"
               if reduce else ""))
    ratio = bytes_["mp2"] / bytes_["dp2"]
    assert bytes_["dp2"] == single[f"bytes{False}"] and ratio < MP_BYTES_RATIO, (bytes_, single)
    print(f"[phase 18] {len(devices)} ranks on {devices} over {backend}, spawned once for "
          f"the three runs ({wall:.1f} s wall); collectives on CUDA tensors: {probe}",
          flush=True)
    for text in texts:
        print(f"[phase 18] {text}", flush=True)
    print(f"[phase 18] per-rank parameter bytes: model parallel 2 {bytes_['mp2']:,} vs data "
          f"parallel {bytes_['dp2']:,} (= one device's): ratio {ratio:.4f} (limit "
          f"{MP_BYTES_RATIO})", flush=True)

    # the kernels at the ranks' shapes, against their plain versions
    cfg = plans.config("3d_fullres")
    patch = tuple(cfg.patch_size)
    named = {}
    for vit, make in ((False, unet_from_plans), (True, vit_unet_from_plans)):
        model = make(plans, "3d_fullres", dtype=torch.bfloat16, deep_supervision=False,
                     generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
        named[vit] = _named_blocks(model, patch, dev)
        del model
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # the plain versions in true f32
    for name, mp, vit in (("dp2", 1, False), ("mp2", 2, False), ("vit_mp2", 2, True)):
        local = (batch // 2 if vit else batch) // (2 // mp)
        part = [(n, m, i, (o[0] // mp,) + tuple(o[1:])) for n, m, i, o in named[vit]]
        conv = _ct_conv_phase(part, dev, gen, (local,), dx_batch=local)
        in_err = _in_checks(_in_shapes(part, {n: "fused" if m.fused else "conv"
                                              for n, m, _, _ in part}),
                            (local,), (local,), dev, gen)
        print(f"[phase 18] {name}'s kernel shapes (batch {local}, Cout / {mp}): the fused "
              f"conv at {conv['shapes']} stride-1 blocks max err {conv['err']:.3e}, its data "
              f"gradient at {conv['dx_shapes']} max err {conv['dx_err']:.3e} (bf16, atol "
              f"5e-2 + rtol 1e-2); the InstanceNorm forward max err {in_err['fwd']:.3e}, "
              f"backward {in_err['bwd']:.3e} (IN_TOL, f32 and bf16, each launch in its "
              f"planned form)", flush=True)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()

    # the sharded serving: phase 4's cases that pad alike over two slots
    classes = plans.num_classes + 1
    m, _, _ = restore_model(os.path.join(trained, "model_final_checkpoint"), dev)
    volumes = [preprocess_for_inference(files, plans, "3d_fullres")[0]
               for _, files in case_files(images)]
    groups = {}
    for v in volumes:
        pads = window_grid(v.shape[:-1], patch)[0]
        groups.setdefault(tuple(s + a + b for s, (a, b) in zip(v.shape[:-1], pads)),
                          []).append(v)
    vols = max(groups.values(), key=len)
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = predict_sliding_window_sharded(m, vols, patch, classes, devices=devices,
                                             window_batch=WINDOW_BATCH, output="seg",
                                             volume_batch=VOLUME_BATCH)
    torch.cuda.synchronize()
    t_sharded = time.perf_counter() - t0
    paths["sharded_serve"] = _counts()
    # each slot's shard is the volume stream over its groups (the padding
    # of the JAX package's _shard_pad: copies of volume 0)
    g_size = min(VOLUME_BATCH, max(1, len(vols) // len(devices)))
    stack = vols + [vols[0]] * ((-len(vols)) % (len(devices) * g_size))
    per = len(stack) // len(devices)
    stream = [r for i in range(len(devices)) for r in predict_sliding_window_multi(
        m, stack[i * per:(i + 1) * per], patch, classes, device=dev,
        window_batch=WINDOW_BATCH, output="seg", volume_batch=g_size)][:len(vols)]
    assert all(np.array_equal(a, b) for a, b in zip(sharded, stream))
    agree = min(float((s == predict_sliding_window(
        m, v, patch, classes, device=dev, window_batch=WINDOW_BATCH, output="seg",
        input_bf16=True)).mean()) for s, v in zip(sharded, vols))
    assert agree >= SHARDED_AGREE, agree
    assert paths["sharded_serve"]["conv3d_in_lrelu"] > 0, paths["sharded_serve"]
    del m
    print(f"[phase 18] predict_sliding_window_sharded: {len(vols)} of phase 4's cases "
          f"(padded alike) over {devices}, {t_sharded:.3f} s; equal bit for bit to the "
          f"volume stream over the same groups of {g_size}; segmentations agree with "
          f"predict_sliding_window per volume on {agree:.6f} of voxels (limit "
          f"{SHARDED_AGREE}); launches {paths['sharded_serve']['conv3d_in_lrelu']} fused, "
          f"{paths['sharded_serve']['instance_norm_leaky']} IN", flush=True)

    # the patch gather at the CT patch: the same draws, native vs numpy
    ds = PreprocessedDataset(ct_stage)
    ct_patch, ct_batch = tuple(CT_PLAN["patch_size"]), CT_PLAN["batch_size"]
    samplers = {kind: PatchSampler(ds, ds.cases, ct_patch, ct_batch, seed=SEED,
                                   native=kind == "native") for kind in ("native", "numpy")}
    secs = {kind: [] for kind in samplers}
    for _ in range(GATHER_BATCHES):
        got = {}
        for kind in ("native", "numpy"):
            t0 = time.perf_counter()
            got[kind] = samplers[kind].next_batch()
            secs[kind].append(time.perf_counter() - t0)
        assert np.array_equal(got["native"]["data"], got["numpy"]["data"]) \
            and np.array_equal(got["native"]["seg"], got["numpy"]["seg"])
    ms = {k: 1e3 * statistics.median(v) for k, v in secs.items()}
    print(f"[phase 18] PatchSampler at the CT patch {ct_patch}, batch {ct_batch}: native "
          f"gather {ms['native']:.2f} ms/batch vs numpy {ms['numpy']:.2f} ms/batch (median of "
          f"{GATHER_BATCHES}, in turns), {GATHER_BATCHES} batches equal bit for bit; host "
          f"cores {os.cpu_count()}", flush=True)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: "
                         "torch.cuda.is_available() is false")
    # plain f32 references run in true f32 (cuDNN would use TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
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
    # seconds from the script's start to each phase's start (set-up steps
    # shared by later phases count to the phase before them)
    phase_start = {"0": 0.0}

    def lap(phase):
        phase_start[phase] = round(time.perf_counter() - t_start, 1)

    models = _ModelCache().__enter__()
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
        # the CLI serves them through the volume stream (the default): the
        # four one-window cases pad alike and share one batch of 4 x 8
        serve_b = _stream_batches(volumes, patch)
        assert sorted(serve_b) == [4 * TTA, 8 * TTA], serve_b
        forwards, batch = len(serve_b), max(batches)
        model_k = unet_from_plans(plans, "3d_fullres", dtype=torch.bfloat16,
                                  deep_supervision=False,
                                  generator=torch.Generator().manual_seed(SEED)).to(dev).eval()
        shapes = _block_shapes(model_k, patch, dev)
        n_fused = sum(f for f, _, _ in shapes)
        n_strided = len(shapes) - n_fused

        lap("1")
        # ---- phase 1: IN + LeakyReLU kernel at the post-stride maps
        # checked at the serving path's largest batch in f32 and bf16, timed
        # (bf16, device time) at that batch and the train step's
        strided = _rows([o for f, _, o in shapes if not f])
        assert tuple((c, n, 1) for c, n in strided) == in_probe.HIPPO_FWD, strided
        # phase 2's batches: the per-case path's, the stream's, the train step's
        timed = sorted(set(batches) | set(serve_b) | {TRAIN_BATCH})
        in_err = 0.0
        for c, n in strided:
            for dtype in (torch.float32, torch.bfloat16):
                args = in_probe.inputs("fwd", batch, c, n, gen, dtype)
                in_err = max(in_err, _in_check("fwd", args, dev))
                del args
        assert batch == 64, batches
        # in_probe.py's groups of phases 1, 5 and 9, from one process
        in_t = _in_probe("hippo_fwd_b2", "hippo_fwd_b64", "hippo_bwd_b2", *CT_IN_GROUPS)
        print(f"[phase 1] instance_norm_leaky: {n_strided} post-stride shapes ok (B={batch}: "
              f"f32 atol 1e-4; bf16 atol 3e-2 + rtol 1e-2), max err {in_err:.3e}, second "
              f"runs equal bit for bit, each launch in the form its plan gives; per forward, "
              f"bf16, device time (in_probe.py): " + "; ".join(
                  f"B={in_t[k]['batch']} {_in_text(in_t[k], dev)}"
                  for k in ("hippo_fwd_b2", "hippo_fwd_b64")), flush=True)

        lap("2")
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

        lap("3")
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

        lap("4")
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
                         **_in_forms(dev, fwd=_at(strided, [(b, 1) for b in serve_b])))
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
              f"{windows}; the volume stream: {forwards} forwards, batches {serve_b} = "
              f"windows x {TTA} mirrors): {main_s / n:.3f} s/volume (first run, "
              f"{main_s:.2f} s), peak "
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

        lap("5")
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
        inb_t = in_t["hippo_bwd_b2"]
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

        lap("6")
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
                         conv3d_dx=(n_fused - 1) * steps, conv3d_wgrad=n_fused * steps,
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
        elastic_launches, elastic_text = _elastic_check(unet, dev_batches, step_cfg, shapes,
                                                        dev)
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
        print(f"[phase 6] {elastic_text}", flush=True)
        _print_profile(6, "train step", profile)

        lap("7")
        # ---- phase 7: the flash-attention kernels at the ViT path's shapes
        flash = _flash_phase(randn)

        lap("8")
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
        with _CheckpointBytes(keep=FINAL):      # serving reads the final one
            run_training_vit(["3d_fullres", task, "0", "-num_epochs", str(TRAIN_EPOCHS),
                              "-num_iters", str(VIT_TRAIN_ITERS), "-val_iters",
                              str(VAL_ITERS), "--device", "cuda"])
        torch.cuda.synchronize()
        vit_train_s = time.perf_counter() - t0
        vit_train_launches = _counts()
        vit_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the ViT-U-Net trains at half the plan's batch
        vit_b = max(1, b2 // 2)
        steps = TRAIN_EPOCHS * VIT_TRAIN_ITERS
        v_rows = _rows([o for f, _, o in vit_shapes if not f])
        expect = _expect(conv3d_in_lrelu=v_fused * (steps + val_steps),
                         instance_norm_leaky=v_strided * (steps + val_steps),
                         conv3d_dx=(v_fused - 1) * steps, conv3d_wgrad=v_fused * steps,
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
        # the volume stream: the task's four one-window cases in one batch
        served_batches = _serve_batches(os.path.join(task_dir, "imagesTr"), plans, patch)
        assert served_batches == [4 * TTA], served_batches
        vit_forwards = len(served_batches)
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
              f"patch {patch}, batch 1, {TRAIN_EPOCHS} epochs x {VIT_TRAIN_ITERS} steps + "
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

        lap("9")
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

        wgrad = _ct_wgrad_phase(ct_blocks, dev, gen)
        print(f"[phase 9] weight-gradient kernel at the CT shapes: {wgrad['shapes']} fused "
              f"convs (B={TRAIN_BATCH}), bf16 x and dy, against the plain version in f32: "
              f"max |kernel - plain| / max |plain| {wgrad['err']:.3e} (limit 5e-4), second "
              f"runs equal bit for bit, every launch on the kernel; per CT train step, device "
              f"time ({os.path.relpath(WGRAD_PROBE, ROOT)}): kernel {wgrad['kernel_ms']:.3f} ms "
              f"({wgrad['share']:.3f} of the bound {wgrad['bound_ms']:.3f} ms, "
              f"{wgrad['bound_by']}), "
              f"plain {wgrad['plain_ms']:.3f} ms, library TF32 on f32 copies (the route it "
              f"replaced) {wgrad['library_tf32_ms']:.3f} ms, library on the bf16 tensors "
              f"{wgrad['library_bf16_ms']:.3f} ms", flush=True)

        ct_in_err, ct_in = _ct_in_phase(ct_blocks, model_ct, dev, gen, in_t)
        for name, g in ct_in.items():
            print(f"[phase 9]   IN {name}, bf16, device time (in_probe.py): {_in_text(g, dev)}",
                  flush=True)
        print(f"[phase 9] instance_norm_leaky / _bwd at the CT shapes (B={TRAIN_BATCH} forward "
              f"and backward, B={CT_SERVE_BATCH} forward; f32 and bf16) ok, max err forward "
              f"{ct_in_err['fwd']:.3e}, backward {ct_in_err['bwd']:.3e} (IN_TOL), second runs "
              f"equal bit for bit, each launch in the form its plan gives", flush=True)

        lap("10")
        # ---- phase 10: the CT path through its entry points
        ct_paths, fma_ct = _ct_path(ct_dir, ct_plans, ct_blocks, model_ct, work, pre,
                                    results, dev)

        lap("11")
        # ---- phase 11: a task sequence through the CL entry points
        cl_paths, seq_step_s = _sequence_path(task_dir, plans, shapes, work, pre, results, dev)

        lap("12")
        # ---- phase 12: the regularizing and freezing trainers
        vit = {"shapes": vit_shapes, "n_attn": n_attn}
        reg_paths, ewc_dice = _regularizer_path(task_dir, plans, shapes, vit, work, pre,
                                                results, dev, seq_step_s)

        lap("13")
        # ---- phase 13: the distilling trainers and the evaluation CLIs
        distill_paths = _distill_eval_path(task_dir, plans, shapes, vit, work, pre, results,
                                           dev, ewc_dice)

        lap("14")
        # ---- phase 14: the POD trainers (PLOP, POD, OwnM1-4)
        pod_paths = _pod_path(task_dir, plans, shapes, vit, work, pre, results, dev)

        lap("15")
        # ---- phase 15: ViT-U-Net V2-V4, task-specific LayerNorms, remat
        var_paths = _vit_variant_path(task_dir, plans, shapes, vit, work, pre, results, dev)

        lap("16")
        # ---- phase 16: the parameter search and the scripts
        search_paths = _orchestration_path(task_dir, plans, shapes, work, pre, results, dev)

        lap("17")
        # ---- phase 17: the 2d configuration, the volume stream, the cascade
        t17 = time.perf_counter()
        cfg_paths, in_err_2d = _2d_path(task_dir, images, labels, work, pre, results, dev,
                                        gen)
        cfg_paths.update(_stream_path(images, labels, plans, shapes,
                                      os.path.join(trained, "model_final_checkpoint"), dev))
        cascade_paths, fma_cascade, casc_err = _cascade_path(work, pre, results, dev, gen)
        cfg_paths.update(cascade_paths)
        print(f"[phase 17] {time.perf_counter() - t17:.1f} s for phase 17; "
              f"{time.perf_counter() - t_start:.1f} s since the script started; the kernels "
              f"against their plain versions at this phase's shapes, max err: InstanceNorm "
              f"forward {max(in_err_2d['fwd'], casc_err['fwd']):.3e}, backward "
              f"{max(in_err_2d['bwd'], casc_err['bwd']):.3e}, fused conv {casc_err['conv']:.3e}, "
              f"its data gradient {casc_err['dx']:.3e}, the copy kernels bit for bit",
              flush=True)

        lap("18")
        # ---- phase 18: multi-device training and serving, the patch gather
        t18 = time.perf_counter()
        multi_paths = _multi_device_path(
            task_dir, plans, shapes, vit_shapes, images, trained,
            os.path.join(pre, os.path.basename(ct_dir), "nnUNetData_plans_v2.1_3d_fullres"),
            work, pre, results, dev, gen)
        print(f"[phase 18] {time.perf_counter() - t18:.1f} s for phase 18; "
              f"{time.perf_counter() - t_start:.1f} s since the script started", flush=True)
        lap("end")
    finally:
        models.__exit__()
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
        ("conv3d_wgrad", "conv3d_wgrad.cu",
         f"none (XLA's weight gradient, {pallas}/conv3d.py:351)", wgrad["err"],
         wgrad["kernel_ms"], wgrad["plain_ms"], (wgrad["bound_ms"], wgrad["bound_by"]),
         wgrad["library_bf16_ms"],
         f"CT train step at B={TRAIN_BATCH} ({wgrad['shapes']} launches), bf16, device time"),
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
    paths = {"serve": launches, "train": train_launches, "elastic_train": elastic_launches,
             "vit_train": vit_train_launches,
             "vit_serve": vit_serve_launches, **ct_paths, **cl_paths, **reg_paths,
             **distill_paths, **pod_paths, **var_paths, **search_paths, **cfg_paths,
             **multi_paths}
    # the FMA kernel runs f32 input only, off the bf16 main paths (0
    # launches there, asserted above); its launches in the f32 checks of
    # phases 4, 6, 8, 10 and 17 are kept apart, under ``check_launches``
    f32_checks = {"serve_f32": fma_serve, "train_f32_step": fma_train,
                  "vit_train_f32_step": fma_vit, **fma_ct, **fma_cascade}
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
        if name == "conv3d_wgrad":
            # beside the library on the bf16 tensors, the route it replaced
            kernels[-1]["tf32_route_ms"] = wgrad["library_tf32_ms"]
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
    print(f"[timing] seconds from the script's start to each phase's start: {phase_start}; "
          f"models built {models.misses} times, copied from an earlier build "
          f"{models.hits} times", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
