"""The serve cells: ``inference/predict.py:predict_from_folder`` as
``nnUNet_torch_inference`` calls it, with its defaults (window batch 8,
mirroring over every subset of the axes, the volume stream with
``volume_batch`` 8, two I/O threads, two cases of lookahead), on a U-Net
built on the device with the benchmark's weights, over a folder of raw CT
images written at set-up; each call writes its NIfTI segmentations to a
folder of its own.

Set-up ends with one call on a small volume made from the seed, of two
windows an axis: the model sees nothing but windows of the patch, in
batches of ``window_batch`` windows, so it warms every shape that the
traffic's volumes (whole batches of windows each) use.  The window is whole
calls on the folder: it closes at the end of the first call that ends after
``--seconds``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from lifelong_nnunet_tpu_torch.device import compute_dtype
from lifelong_nnunet_tpu_torch.inference.predict import predict_from_folder
from lifelong_nnunet_tpu_torch.models.unet import unet_from_plans
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import conv3d_in_lrelu_cf
from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import instance_norm_leaky_cf
from lifelong_nnunet_tpu_torch.training.restore import route_switches

from .. import arithmetic, data
from ..reference import model, serve
from . import common
from .train import _plans

# the traced window: whole calls
TRACE_CALLS = 1
# the check: every volume of one call of the window, drawn from the seed, in
# cells of the window grid drawn from the seed that hold this many voxels
# (four cells of a 128^3 patch), or in whole
CHECK_VOXELS = 4 * 64 ** 3


def setup(run):
    t = run.traffic
    cname = run.config["config_name"]
    s = {"in": os.path.join(run.tmp, "in"), "forwards": []}
    s["cases"] = data.write_raw_cases(s["in"], run.config, t["case_shapes"], run.seed,
                                      run.device)
    s["plans"] = _plans(run)
    with torch.device("meta"):
        net = unet_from_plans(s["plans"], cname, dtype=compute_dtype(run.device),
                              deep_supervision=False, use_kernels=True, **route_switches())
    net = net.to_empty(device=run.device)
    s["params0"] = model.init_params(model.layers_for(run.config, True), run.seed, run.device)
    with model.no_tf32():
        serve.calibrate_background(s["params0"], model.layers_for(run.config, False),
                                   _image(run, s["cases"][0][1])[None], t["foreground_share"])
    common.load_params(net, s["params0"])
    net.eval()
    net.register_forward_pre_hook(lambda mod, args: s["forwards"].append(args[0].shape[0]))
    s["net"] = net
    return s


def warm(run, s):
    patch = run.config["plans"]["configurations"][run.config["config_name"]]["patch_size"]
    folder = os.path.join(run.tmp, "warm_in")
    data.write_raw_cases(folder, run.config, [[p + p // 2 for p in patch]], run.seed + 1,
                         run.device)
    call(run, s, "warm", folder)


def call(run, s, tag: str, folder=None) -> list:
    t = run.traffic
    return predict_from_folder(
        [s["net"]], s["plans"], run.config["config_name"], folder or s["in"],
        os.path.join(run.tmp, "out", tag), device=run.device, do_tta=t["do_tta"],
        window_batch=t["window_batch"], io_workers=t["io_workers"], lookahead=t["lookahead"],
        volume_batch=t["volume_batch"])


def window(run, s):
    s["forwards"].clear()
    s["calls"] = []
    t0 = time.perf_counter()
    while True:
        written = call(run, s, f"call{len(s['calls'])}")
        s["calls"].append(written)
        if time.perf_counter() - t0 >= run.seconds:
            break
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    elapsed = time.perf_counter() - t0
    n = sum(len(w) for w in s["calls"])
    run.attempted = len(s["calls"]) * len(s["cases"])
    run.failed = run.attempted - sum(os.path.isfile(f) for w in s["calls"] for f in w)
    run.e2e["serve_volumes_per_s"] = n / elapsed
    run.stats.update(window_s=elapsed, volumes=n, forwards=list(s["forwards"]), train=False)


COUNTERS = {"conv3d_fused": (conv3d_in_lrelu_cf,), "instance_norm": (instance_norm_leaky_cf,)}


def traced(run, s):
    s["forwards"].clear()
    before = common.launches(COUNTERS)
    run.stats["trace"] = common.profile(
        lambda: [call(run, s, f"trace{i}") for i in range(TRACE_CALLS)], run.device)
    run.stats["trace"]["forwards"] = list(s["forwards"])
    got = {n: v - before[n] for n, v in common.launches(COUNTERS).items()}
    want = {"conv3d_fused": sum(len(arithmetic.conv3d_fused_launches(run.config, b, False))
                                for b in s["forwards"]),
            "instance_norm": sum(len(arithmetic.instance_norm_launches(run.config, b, False))
                                 for b in s["forwards"])}
    common.require_launches(got, want, run.device)


def sample(run, s) -> list:
    """(call, case, boxes) to check, drawn from the seed: every case of one
    call of the window, each in cells of the window grid."""
    rng = np.random.default_rng([int(run.seed), 99])
    patch = run.config["plans"]["configurations"][run.config["config_name"]]["patch_size"]
    c = int(rng.integers(len(s["calls"])))
    return [(c, i, serve.grid_cells(hu.shape, patch, CHECK_VOXELS, rng))
            for i, (_, hu) in enumerate(s["cases"])]


def _image(run, hu) -> torch.Tensor:
    props = run.config["plans"]["intensity_properties"]["0"]
    return data.ct_normalize(torch.from_numpy(hu).to(run.device), props)[None]


def check(run, s):
    del s["net"]
    common.free(run.device)
    patch = run.config["plans"]["configurations"][run.config["config_name"]]["patch_size"]
    layers = model.layers_for(run.config, False)
    gap, s["checked"] = 0.0, []
    for c, i, boxes in sample(run, s):
        name, hu = s["cases"][i]
        served = data.read_nifti(os.path.join(run.tmp, "out", f"call{c}", f"{name}.nii.gz"))
        if served.shape != hu.shape:
            raise RuntimeError(f"{name}: served {served.shape}, image {hu.shape}")
        image = _image(run, hu)
        for box in boxes:
            with model.no_tf32():
                probs = serve.probabilities(s["params0"], layers, image, patch, box)
            gap = max(gap, serve.served_gap(probs, served[tuple(slice(a, b) for a, b in box)]))
            del probs
        s["checked"].append((i, boxes))
        del image
    run.check("missing", run.failed)
    run.check("seg_gap", gap)


def control(run, s) -> dict:
    """The control's reading (the upper end of ``seg_gap``'s limit): the
    reference in float8 put in the program's place on the checked boxes,
    its labels judged by the float32 reference."""
    patch = run.config["plans"]["configurations"][run.config["config_name"]]["patch_size"]
    layers = model.layers_for(run.config, False)
    gap = 0.0
    for i, boxes in s["checked"]:
        image = _image(run, s["cases"][i][1])
        for box in boxes:
            with model.no_tf32():
                probs = serve.probabilities(s["params0"], layers, image, patch, box)
                low = serve.probabilities(s["params0"], layers, image, patch, box, quant=True)
            gap = max(gap, serve.served_gap(probs, low.argmax(0).to(torch.uint8).cpu().numpy()))
            del probs, low
        del image
    return {"control_fp8": {"seg_gap": gap}}
