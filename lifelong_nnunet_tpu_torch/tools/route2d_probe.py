"""Find where the ``2d`` configuration's kernel route and plain route part
(chip_smoke.py phase 17: their bf16 segmentations of the same checkpoint
agree on a smaller share of voxels than the 3D routes').  On the ``2d``
U-Net every conv is cuDNN's on both routes and the InstanceNorm differs:
the kernel route's kernel normalizes in f32 and rounds once, the plain
route's ``InstanceNorm`` module (the JAX module's math) takes one-pass
statistics and normalizes in bf16.  So either one kernel launch, at one
shape or in one form, errs by more than roundoff, or the voxels that flip
sit within bf16 roundoff of a tie between two classes.

    python3 lifelong_nnunet_tpu_torch/tools/route2d_probe.py [--work DIR]

Makes phase 17's checkpoint as chip_smoke.py does (phase 4's synthetic task
and its larger case, the ``2d`` plan, ``nnUNet_torch_train_sequential 2d``
for 1 epoch of ``CFG2D_ITERS`` steps with progress validation), then:

  * serves the same folder through ``predict_from_folder`` on both routes
    and on a third, ``plain_f32norm`` (the plain route with each
    ``InstanceNorm`` normalizing in f32, as the kernel does), and gives
    each case's share of voxels on which two routes agree (kernel vs
    plain is phase 17's number);
  * for each case, both routes' f32 probabilities (TTA, overlap-add, the
    stream's bf16 input) and, where their argmaxes differ, the plain
    route's margin: top-1 minus top-2 probability, in bf16 ulps of the
    top-1 probability and as the log ratio ln(p1 / p2) (the margin of the
    logits of the averaged softmax); a histogram over those voxels and
    over all voxels;
  * for each InstanceNorm launch of one serving forward (the largest
    case's first batch of window pairs x mirrors), with the launch's shape
    and form: the kernel's output against its plain version
    (``_plain_forward``) on the same input, in bf16 ulps of the output and
    in bf16 ulps of the scale of the affine map's terms (|x_hat * scale| +
    |bias|, times the slope where negative: an output near 0 after
    cancellation has a tiny ulp of its own); and the plain route's module
    (``F.leaky_relu(InstanceNorm(x))``) against the same plain version.

Prints a JSON line per part, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# histogram edges of a margin in bf16 ulps of the top-1 probability
ULP_EDGES = (0.0, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 64.0, 256.0, math.inf)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |v| (8 significant bits); 0 where v is 0."""
    a = v.abs().float()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                       torch.zeros_like(a))


def histogram(values: np.ndarray, edges=ULP_EDGES) -> dict:
    """{"[lo, hi)": count} of ``values`` over ``edges``."""
    counts, _ = np.histogram(values, bins=np.asarray(edges, np.float64))
    return {f"[{lo:g}, {hi:g})": int(n) for lo, hi, n in zip(edges, edges[1:], counts)}


def margins(probs: np.ndarray) -> tuple:
    """(top-1 minus top-2 probability in bf16 ulps of top-1, ln(p1 / p2))
    per voxel of ``probs [..., K]``."""
    top = torch.from_numpy(probs).topk(2, dim=-1).values
    p1, p2 = top[..., 0], top[..., 1]
    ulps = (p1 - p2) / bf16_ulp(p1)
    return ulps.numpy(), torch.log(p1.clamp_min(1e-30) / p2.clamp_min(1e-30)).numpy()


def f32_norm(self, x: torch.Tensor) -> torch.Tensor:
    """An ``InstanceNorm.forward`` that normalizes in f32 (two-pass
    statistics) and rounds once, as the kernel does."""
    axes = tuple(range(2, x.dim()))
    shape = (1, -1) + (1,) * len(axes)
    xc = x.float() - x.float().mean(dim=axes, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=axes, keepdim=True) + self.eps)
    return (xc * rstd * self.weight.float().view(shape)
            + self.bias.float().view(shape)).to(x.dtype)


def ulp_errors(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor | None = None,
               prefix: str = "") -> dict:
    """|got - ref| in bf16 ulps of the larger of the two (and of ``scale``
    where given): the largest, the share of elements that differ, the share
    beyond one ulp."""
    diff = (got.float() - ref.float()).abs()
    out = {f"{prefix}share_differ": (diff > 0).float().mean().item()}
    for name, mag in (("", torch.maximum(got.float().abs(), ref.float().abs())),
                      ("term_", scale)):
        if mag is None:
            continue
        ulp = bf16_ulp(mag)
        units = torch.where(ulp > 0, diff / ulp, torch.zeros_like(diff))
        out[f"{prefix}max_{name}ulps"] = units.max().item()
        out[f"{prefix}share_over_1_{name}ulp"] = (units > 1).float().mean().item()
    return out


def in_launch_errors(model, x: torch.Tensor) -> list:
    """Run ``model(x)`` once with every InstanceNorm launch also computed by
    its plain version on the same input and by the plain route's module;
    per launch, in call order: (B, C, H*W), the kernel's form, the kernel
    against the plain version (:func:`ulp_errors`, also in ulps of the
    affine terms' scale), the largest relative error of the saved rstd, and
    the plain route's module against the plain version (``module_``)."""
    from lifelong_nnunet_tpu_torch.models.unet import InstanceNorm
    from lifelong_nnunet_tpu_torch.ops.kernels import instance_norm as inorm

    kernel_forward, rows = inorm._forward, []

    def recording(xin, scale, bias, alpha, eps):
        before = dict(inorm.instance_norm_leaky_cf.forms)
        out, mean, rstd = kernel_forward(xin, scale, bias, alpha, eps)
        form = [f for f, n in inorm.instance_norm_leaky_cf.forms.items() if n > before[f]]
        ref, ref_mean, ref_rstd = inorm._plain_forward(xin, scale, bias, alpha, eps)
        B, C = xin.shape[:2]
        view = (1, C) + (1,) * (xin.dim() - 2)
        xhat = (xin.float() - inorm._bcast(ref_mean, xin)) * inorm._bcast(ref_rstd, xin)
        pre = xhat * scale.float().view(view) + bias.float().view(view)
        terms = (xhat * scale.float().view(view)).abs() + bias.float().abs().view(view)
        terms = torch.where(pre >= 0, terms, alpha * terms)
        module = InstanceNorm(C, eps).to(xin.device)
        with torch.no_grad():
            module.weight.copy_(scale)
            module.bias.copy_(bias)
        plain_route = torch.nn.functional.leaky_relu(module(xin), alpha)
        rows.append({"shape": [B, C, xin[0, 0].numel()], "form": form,
                     **ulp_errors(out, ref, terms),
                     "rstd_rel_err": ((rstd - ref_rstd).abs() / ref_rstd).max().item(),
                     **ulp_errors(plain_route, ref, terms, prefix="module_")})
        return out, mean, rstd

    inorm._forward = recording
    try:
        with torch.inference_mode():
            model(x)
    finally:
        inorm._forward = kernel_forward
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "route2d_probe"),
                    help="scratch directory (a fresh one inside it)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("route2d_probe needs an NVIDIA GPU")
    # run as a script, the package and chip_smoke.py import from ROOT
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from lifelong_nnunet_tpu_torch.inference.predict import (
        case_files, predict_from_folder, preprocess_for_inference)
    from lifelong_nnunet_tpu_torch.inference.sliding_window import (
        mirror_combos, predict_sliding_window, window_grid)
    from lifelong_nnunet_tpu_torch.models.unet import InstanceNorm
    from lifelong_nnunet_tpu_torch.planning.plans import Plans, plans_path
    from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
    from lifelong_nnunet_tpu_torch.run.run_training import run_training, trainer_name
    from lifelong_nnunet_tpu_torch.training.output_paths import build_output_folder
    from lifelong_nnunet_tpu_torch.training.restore import restore_model
    from lifelong_nnunet_tpu_torch.utilities.synthetic import make_synthetic_task

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    os.makedirs(args.work, exist_ok=True)
    work = tempfile.mkdtemp(dir=args.work)
    try:
        # phase 4's cases and phase 17's training, as chip_smoke.py makes them
        raw = os.path.join(work, "raw", "nnUNet_raw_data")
        pre, results = os.path.join(work, "pre"), os.path.join(work, "results")
        os.environ.update({"nnUNet_raw_data_base": os.path.join(work, "raw"),
                           "nnUNet_preprocessed": pre, "RESULTS_FOLDER": results,
                           "LNN_BLOCKED_CONV": "1", "LNN_UPT_MODE": "pallas"})
        task_dir = make_synthetic_task(raw, shape=cs.SMALL_SHAPE, num_cases=4, seed=cs.SEED)
        task = os.path.basename(task_dir)
        images = os.path.join(work, "images")
        shutil.copytree(os.path.join(task_dir, "imagesTr"), images)
        large_dir = make_synthetic_task(os.path.join(work, "raw_large"),
                                        task_name="Task098_Large", shape=cs.LARGE_SHAPE,
                                        num_cases=1, seed=cs.SEED + 1)
        shutil.copy(os.path.join(large_dir, "imagesTr", "synth_000_0000.nii.gz"),
                    os.path.join(images, "large_000_0000.nii.gz"))
        plan_and_preprocess([task_dir], pre, configs=("2d",), verbose=False)
        plans = Plans.load(plans_path(os.path.join(pre, task)))
        cfg = plans.config("2d")
        got = {"patch_size": list(cfg.patch_size), "batch_size": cfg.batch_size,
               "pool_op_kernel_sizes": [list(k) for k in cfg.pool_op_kernel_sizes]}
        assert got == cs.PLAN_2D, got
        torch.backends.cudnn.allow_tf32 = True
        run_training("sequential", ["2d", "-t", task, "-num_epochs", "1", "-num_iters",
                                    str(cs.CFG2D_ITERS), "-val_iters", str(cs.SEQ_VAL_ITERS),
                                    "--use_progress_val", "--device", "cuda"])
        folder = build_output_folder(os.path.join(results, "nnUNet_ext"), "2d", [task],
                                     [task], trainer_name("sequential"), plans.plans_name, 0,
                                     True)
        ckpt = os.path.join(folder, "model_final_checkpoint")
        patch, classes = tuple(cfg.patch_size), plans.num_classes + 1
        models = {route: restore_model(ckpt, dev, use_kernels=route == "kernel")[0]
                  for route in ("kernel", "plain", "plain_f32norm")}
        for mod in models["plain_f32norm"].modules():
            if isinstance(mod, InstanceNorm):
                mod.forward = types.MethodType(f32_norm, mod)
        assert all(m.dtype == torch.bfloat16 for m in models.values())

        # phase 17's comparison: the routes served through predict_from_folder
        served = {}
        for route, m in models.items():
            served[route] = os.path.join(work, f"seg_{route}")
            predict_from_folder([m], plans, "2d", images, served[route], device=dev,
                                window_batch=cs.WINDOW_BATCH)
        cases = [c for c, _ in case_files(images)]
        agree = {f"{a} vs {b}": {c: cs._agreement(served[a], served[b], [c]) for c in cases}
                 for a, b in (("kernel", "plain"), ("kernel", "plain_f32norm"),
                              ("plain", "plain_f32norm"))}
        print(json.dumps({"part": "served", "card": card, "checkpoint_steps": cs.CFG2D_ITERS,
                          "agreement": agree,
                          "min": {k: min(v.values()) for k, v in agree.items()}}), flush=True)

        # each case's probabilities on the routes; margins where two part
        flips_ulps, flips_log, all_ulps, per_case = [], [], [], {}
        for case, files in case_files(images):
            vol = preprocess_for_inference(files, plans, "2d")[0]
            probs = {route: predict_sliding_window(m, vol, patch, classes, device=dev,
                                                   window_batch=cs.WINDOW_BATCH,
                                                   input_bf16=True)
                     for route, m in models.items()}
            seg = {r: p.argmax(-1) for r, p in probs.items()}
            ulps, logr = margins(probs["plain"])
            flip = seg["kernel"] != seg["plain"]
            flips_ulps.append(ulps[flip])
            flips_log.append(logr[flip])
            all_ulps.append(ulps.ravel())
            per_case[case] = {
                "voxels": int(flip.size), "flips": int(flip.sum()),
                "flips_kernel_vs_plain_f32norm": int((seg["kernel"]
                                                      != seg["plain_f32norm"]).sum()),
                "max_abs_prob_diff": float(np.abs(probs["kernel"] - probs["plain"]).max()),
                "max_abs_prob_diff_f32norm": float(np.abs(probs["kernel"]
                                                          - probs["plain_f32norm"]).max())}
        flips_ulps, flips_log = np.concatenate(flips_ulps), np.concatenate(flips_log)
        all_ulps = np.concatenate(all_ulps)
        print(json.dumps({
            "part": "margins", "card": card, "per_case": per_case,
            "flips": int(flips_ulps.size),
            "flip_margin_ulps_max": float(flips_ulps.max()) if flips_ulps.size else None,
            "flip_log_ratio_max": float(flips_log.max()) if flips_log.size else None,
            "flip_histogram_ulps": histogram(flips_ulps),
            "all_histogram_ulps": histogram(all_ulps)}), flush=True)

        # every InstanceNorm launch of one serving forward on the kernel route
        big = max((preprocess_for_inference(f, plans, "2d")[0] for _, f in case_files(images)),
                  key=lambda v: v.size)
        pads, _, origins = window_grid(big.shape[1:-1], patch)
        big = np.pad(big, [(0, 0)] + [tuple(p) for p in pads] + [(0, 0)])
        pairs = [(d, o) for d in range(big.shape[0]) for o in origins][:cs.WINDOW_BATCH]
        x = torch.from_numpy(np.stack([big[d, o[0]:o[0] + patch[0], o[1]:o[1] + patch[1]]
                                       for d, o in pairs])).movedim(-1, 1)
        x = x.to(torch.bfloat16).to(dev)
        combos = mirror_combos((0, 1))
        x = torch.cat([x.flip([a + 2 for a in c]) if c else x for c in combos])
        launches = in_launch_errors(models["kernel"], x)
        print(json.dumps({"part": "instance_norm", "card": card, "batch": list(x.shape),
                          "launches": launches,
                          **{k: max(r[k] for r in launches)
                             for k in launches[0] if k.startswith(("max_", "module_max_"))}}),
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
