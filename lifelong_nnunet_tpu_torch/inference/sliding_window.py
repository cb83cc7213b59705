"""Gaussian-weighted sliding-window inference with mirror TTA, in PyTorch:
the port of ``lifelong_nnunet_tpu/inference/sliding_window.py``.

The grid arithmetic (``compute_steps``, ``gaussian_importance_map``,
``_center_pads``/``pad_to_min``, ``bucket_shape`` and the bucket-padded
regular grid of ``_prepare_meta``) is copied with identical numerics.  The
device side has ONE accumulation path (``_overlap_add``): a stack of
volumes padded alike is windowed at the same origins, every model batch
runs up to ``window_batch`` (volume, window) pairs on all 2^n mirror
variants, the mean softmax is weighted by the Gaussian and slice-added into
a class-major ``[K, V, *padded]`` float32 buffer beside the summed weights,
and the normalization divides by those weights.  One volume is a stack of
one; a 2D patch over a 3D volume is the stack of its slices (the JAX
package's ``_predict_2d_over_3d``); the volume stream
(``predict_sliding_window_multi``) stacks the volumes that share a padded
shape; ``predict_sliding_window_sharded`` splits a stack over devices, one
thread, stream and model replica per device.  The JAX package's scatter, overlap-add and slab cores, its vmapped
stream with its program caps and compile-shape padding exist for TPU
dispatch limits and are not ported; the card's memory holds the
accumulator of any volume or group the slice serves.

The volume stream's groups are spans (``tracing.py``): ``sw.pad_stack``
(the host's pad and stack), ``sw.upload``, ``sw.overlap_add`` (the window
loop, timed on the device too) and ``sw.download``.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import torch

from .. import tracing


def compute_steps(image_size, patch_size, step_fraction: float = 0.5) -> list:
    """Window origins per axis: evenly spaced, spacing <= patch*step_fraction,
    first at 0 and last flush with the volume end (nnU-Net grid)."""
    steps = []
    for ims, ps in zip(image_size, patch_size):
        if ims <= ps:
            steps.append([0])
            continue
        max_step = ps * step_fraction
        num = int(np.ceil((ims - ps) / max_step)) + 1
        actual = (ims - ps) / max(num - 1, 1)
        steps.append([int(np.round(actual * i)) for i in range(num)])
    return steps


@lru_cache(maxsize=16)
def gaussian_importance_map(patch_size, sigma_scale: float = 1 / 8) -> np.ndarray:
    """Gaussian centered in the patch, normalized to max 1, zero-floor lifted
    to the smallest positive value (so every voxel gets weight)."""
    patch_size = tuple(int(p) for p in patch_size)
    tmp = np.zeros(patch_size, dtype=np.float64)
    center = tuple(s // 2 for s in patch_size)
    tmp[center] = 1.0
    from scipy.ndimage import gaussian_filter
    sigmas = [s * sigma_scale for s in patch_size]
    g = gaussian_filter(tmp, sigmas, mode="constant")
    g = g / g.max()
    g[g == 0] = g[g > 0].min()
    return g.astype(np.float32)


def _center_pads(spatial, patch_size):
    """Centered pad-to-at-least-patch config for spatial dims.  Returns
    ([[lo, hi], ...], [undo slice, ...])."""
    pads, sl = [], []
    for s, p in zip(spatial, patch_size):
        need = max(0, p - s)
        lo = need // 2
        pads.append([lo, need - lo])
        sl.append(slice(lo, lo + s))
    return pads, sl


def pad_to_min(data: np.ndarray, patch_size):
    """Pad spatial dims of [*, C]-last array up to at least patch size
    (centered, zero padding). Returns (padded, slicer-to-undo)."""
    pads, sl = _center_pads(data.shape[:-1], patch_size)
    return np.pad(data, [tuple(p) for p in pads] + [(0, 0)]), tuple(sl)


def bucket_shape(shape, patch_size, step_fraction: float = 0.5):
    """Round spatial shape up to the next window-grid-equivalent size
    (grid spacing = patch*step)."""
    out = []
    for s, p in zip(shape, patch_size):
        step = max(1, int(p * step_fraction))
        out.append(p + step * int(np.ceil(max(0, s - p) / step)))
    return tuple(out)


def _regular(patch_size, step_fraction: float) -> bool:
    """An even patch at step 0.5: the bucket-padded grid is the regular one
    (origins ``i * patch // 2``), where volumes that pad alike group and
    ``seg`` sums bfloat16 windows (the JAX package's overlap-add cores)."""
    return step_fraction == 0.5 and all(int(p) % 2 == 0 for p in patch_size)


def window_grid(spatial_shape, patch_size, step_fraction: float = 0.5):
    """Padding and window origins for one volume (``_prepare_meta``).

    The centered pad-to-patch and, for an even patch at step 0.5, the
    high-side bucket pad combine into one pad config; the bucket pad makes
    the grid regular (origins ``i * patch // 2``).  Otherwise the origins
    are ``compute_steps`` on the centered-padded shape.  Returns
    (pads [(lo, hi)] per spatial axis, undo slices, origins)."""
    patch_size = tuple(int(p) for p in patch_size)
    pads, undo = _center_pads(spatial_shape, patch_size)
    padded = tuple(s + lo + hi for s, (lo, hi) in zip(spatial_shape, pads))
    if _regular(patch_size, step_fraction):
        bshape = bucket_shape(padded, patch_size, step_fraction)
        for a in range(len(pads)):
            pads[a][1] += bshape[a] - padded[a]
        grid = [range(0, b - p + 1, p // 2) for b, p in zip(bshape, patch_size)]
    else:
        grid = compute_steps(padded, patch_size, step_fraction)
    return (tuple((lo, hi) for lo, hi in pads), tuple(undo),
            list(itertools.product(*grid)))


def mirror_combos(mirror_axes) -> list:
    """Every subset of ``mirror_axes``, in the JAX package's order."""
    return [c for r in range(len(mirror_axes) + 1)
            for c in itertools.combinations(mirror_axes, r)]


def tta_softmax(model, x: torch.Tensor, mirror_axes) -> torch.Tensor:
    """x [B, C, *patch] -> mean softmax over the mirror variants,
    [B, K, *patch] float32.  All variants run as ONE model batch."""
    combos = mirror_combos(mirror_axes)
    flips = [[a + 2 for a in c] for c in combos]
    big = torch.cat([x.flip(f) if f else x for f in flips], dim=0)
    parts = model(big)[0].float().split(x.shape[0], dim=0)
    acc = 0.0
    for f, part in zip(flips, parts):
        acc = acc + torch.softmax(part.flip(f) if f else part, dim=1)
    return acc / len(combos)


OUTPUTS = ("probs", "probs_bf16", "seg")


def _check_output(output: str) -> None:
    if output not in OUTPUTS:
        raise ValueError(f"output must be probs, probs_bf16 or seg: {output!r}")


def _upload(host: np.ndarray, device: torch.device, input_bf16: bool) -> torch.Tensor:
    """``host [V, *padded, C]`` (a padded copy) -> ``[V, C, *padded]`` on
    ``device``, rounded to bfloat16 with ``input_bf16`` (the model casts it
    back to its own dtype)."""
    x = torch.from_numpy(np.ascontiguousarray(host, dtype=np.float32))
    if input_bf16:
        x = x.to(torch.bfloat16)
    return x.movedim(-1, 1).contiguous().to(device)


def _overlap_add(model, vols: torch.Tensor, origins, patch_size, num_classes: int,
                 mirror_axes, window_batch: int, use_gaussian: bool,
                 output: str, regular: bool) -> np.ndarray:
    """The accumulation path of a stack of volumes padded alike, ``vols [V,
    C, *padded]`` on the model's device, windowed at the same ``origins``:
    the (volume, window) pairs run in order, ``window_batch`` to a model
    batch (times the mirror variants), so one batch may carry windows of
    several volumes.  Each volume keeps its own f32 accumulator (slices of
    one ``[K, V, *padded]`` buffer); the Gaussian weights are the same for
    all of them.  Returns ``[V, *padded, K]`` float32 (rounded through
    bfloat16 for ``probs_bf16``) or ``[V, *padded]`` uint8 (``seg``), on the
    device.  For ``seg`` on the ``regular`` grid each window's weighted
    probabilities are rounded to bfloat16 before the f32 sum, as the JAX
    package's overlap-add cores keep their window buffer; its irregular
    grid sums them in f32."""
    device = vols.device
    padded = tuple(vols.shape[2:])
    g = torch.from_numpy(gaussian_importance_map(patch_size) if use_gaussian
                         else np.ones(patch_size, np.float32)).to(device)
    acc = torch.zeros((num_classes, vols.shape[0]) + padded, dtype=torch.float32,
                      device=device)
    weight = torch.zeros(padded, dtype=torch.float32, device=device)
    windows = [tuple(slice(o, o + p) for o, p in zip(origin, patch_size))
               for origin in origins]
    pairs = [(v, w) for v in range(vols.shape[0]) for w in windows]
    with torch.inference_mode():
        for w in windows:
            weight[w] += g
        for i in range(0, len(pairs), window_batch):
            batch = pairs[i:i + window_batch]
            x = torch.stack([vols[(v, slice(None)) + w] for v, w in batch])
            probs = tta_softmax(model, x, mirror_axes) * g
            if output == "seg" and regular:
                probs = probs.to(torch.bfloat16).float()
            for (v, w), p in zip(batch, probs):
                acc[(slice(None), v) + w] += p
        if output == "seg":
            # the positive per-voxel normalization cannot change the argmax
            out = acc.argmax(dim=0).to(torch.uint8)
        else:
            out = (acc * (1.0 / weight)).movedim(0, -1)
            if output == "probs_bf16":
                out = out.to(torch.bfloat16).float()
        return out


def predict_sliding_window(model, data: np.ndarray, patch_size,
                           num_classes: int, *, device: torch.device,
                           mirror_axes=(0, 1, 2), step_fraction: float = 0.5,
                           window_batch: int = 4, use_gaussian: bool = True,
                           output: str = "probs", input_bf16: bool = False) -> np.ndarray:
    """``data`` [*spatial, C] (channels-last, preprocessed, as in the JAX
    package).  Returns softmax probabilities ``[*spatial, num_classes]``
    float32, the same rounded through bfloat16 with ``output='probs_bf16'``,
    or the argmax segmentation ``[*spatial]`` uint8 with ``output='seg'``.
    ``input_bf16`` rounds the input through bfloat16 (the JAX package's
    halved upload; on the card the model computes in bfloat16 anyway).

    A 2D ``patch_size`` over a 3D ``data [D, H, W, C]`` predicts every
    slice on its own (the JAX package's ``_predict_2d_over_3d``, upstream
    nnU-Net's ``_internal_predict_3D_2Dconv_tiled``): the 2D window grid of
    ``(H, W)`` on each slice, the mirror axes cut to the two in-plane ones,
    and a model batch carrying up to ``window_batch`` (slice, window) pairs.

    ``model(x [B, C, *patch])`` returns the U-Net's output list, highest
    resolution first; it must already live on ``device``."""
    _check_output(output)
    patch_size = tuple(int(p) for p in patch_size)
    data = np.asarray(data)
    over_3d = data.ndim - 1 == len(patch_size) + 1
    if data.ndim - 1 != len(patch_size) and not over_3d:
        raise ValueError(f"data {data.shape} does not match a {len(patch_size)}D patch")
    stack = data if over_3d else data[None]
    mirror_axes = tuple(a for a in mirror_axes if a < len(patch_size))
    pads, undo, origins = window_grid(stack.shape[1:-1], patch_size, step_fraction)
    host = np.pad(stack, ((0, 0),) + pads + ((0, 0),))
    out = _overlap_add(model, _upload(host, device, input_bf16), origins, patch_size,
                       num_classes, mirror_axes, window_batch, use_gaussian, output,
                       _regular(patch_size, step_fraction)).cpu().numpy()
    out = out[(slice(None),) + undo]
    return out if over_3d else out[0]


def _padded(v: np.ndarray, pads) -> tuple:
    """The spatial shape of ``v [*spatial, C]`` padded by ``pads``."""
    return tuple(s + lo + hi for s, (lo, hi) in zip(v.shape[:-1], pads))


def predict_sliding_window_multi(model, volumes: list, patch_size, num_classes: int, *,
                                 device: torch.device, mirror_axes=(0, 1, 2),
                                 step_fraction: float = 0.5, window_batch: int = 4,
                                 output: str = "seg", input_bf16: bool = True,
                                 volume_batch: int = 1) -> list:
    """Sliding-window prediction over a stream of volumes (the JAX
    package's ``predict_sliding_window_multi``): a list of ``[*spatial, C]``
    arrays in, the list of their results (as
    :func:`predict_sliding_window` gives them) out, in input order.

    Consecutive volumes whose padded shape is the same (different raw shapes
    that bucket-pad alike included) form groups of up to ``volume_batch``
    when the window grid is the regular one (an even patch at step 0.5);
    a group's (volume, window) pairs share model batches of ``window_batch``
    windows (times the mirror variants), so the largest forward is the one
    volume's.  Other volumes, and a 2D patch over a 3D volume, run one by
    one."""
    _check_output(output)
    patch_size = tuple(int(p) for p in patch_size)
    regular = _regular(patch_size, step_fraction)
    limit = max(1, volume_batch) if regular else 1
    kw = dict(device=device, mirror_axes=mirror_axes, step_fraction=step_fraction,
              window_batch=window_batch, output=output, input_bf16=input_bf16)
    results: list = [None] * len(volumes)
    group: list = []          # [(index, volume, pads, undo, origins)]

    def flush():
        if not group:
            return
        with tracing.span("sw.pad_stack"):
            host = np.stack([np.pad(v, pads + ((0, 0),)) for _, v, pads, _, _ in group])
        with tracing.span("sw.upload"):
            vols = _upload(host, device, input_bf16)
        with tracing.span("sw.overlap_add", device=True):
            out = _overlap_add(model, vols, group[0][4], patch_size, num_classes, mirror_axes,
                               window_batch, True, output, regular)
        with tracing.span("sw.download"):
            out = out.cpu().numpy()
        for (i, _, _, undo, _), r in zip(group, out):
            results[i] = r[undo]
        group.clear()

    for i, v in enumerate(volumes):
        v = np.asarray(v)
        if v.ndim - 1 == len(patch_size) + 1:       # a 2D net on a 3D volume
            flush()
            results[i] = predict_sliding_window(model, v, patch_size, num_classes, **kw)
            continue
        pads, undo, origins = window_grid(v.shape[:-1], patch_size, step_fraction)
        if group and _padded(group[0][1], group[0][2]) != _padded(v, pads):
            flush()
        group.append((i, v, pads, undo, origins))
        if len(group) >= limit:
            flush()
    flush()
    return results


def _shard_pad(n_volumes: int, n_dev: int, g_size: int) -> int:
    """The number of copies of volume 0 appended so the stack splits into
    equal per-device shards of whole volume groups: the least pad to a
    multiple of ``n_dev * max(1, g_size)`` (the JAX package's)."""
    return (-n_volumes) % (n_dev * max(1, g_size))


def predict_sliding_window_sharded(model, volumes: list, patch_size, num_classes: int, *,
                                   devices=None, mirror_axes=(0, 1, 2),
                                   step_fraction: float = 0.5, window_batch: int = 8,
                                   output: str = "seg", input_bf16: bool = True,
                                   volume_batch: int = 1) -> list:
    """Multi-device serving (the JAX package's ``predict_sliding_window_sharded``):
    the volumes, which must share their padded shape, are split one shard
    per device; each device runs :func:`predict_sliding_window_multi` on its
    shard with its own replica of ``model`` (the parameters replicated), on
    a thread of its own and, on a GPU, a CUDA stream of its own.  The stack
    is padded with copies of volume 0 (:func:`_shard_pad`) so every device
    gets an equal shard of whole groups of ``volume_batch``; each volume is
    cut back by its own undo.  ``devices``: the devices (default every
    visible GPU); a device named twice gets two replicas.  Needs no process
    group.  Returns the results in input order."""
    _check_output(output)
    patch_size = tuple(int(p) for p in patch_size)
    devices = [torch.device(d) for d in (devices if devices is not None else
               [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    if not devices:
        raise ValueError("no devices to shard over")
    vols = [np.asarray(v) for v in volumes]
    shapes = {_padded(v, window_grid(v.shape[:-1], patch_size, step_fraction)[0])
              for v in vols}
    if len(shapes) != 1:
        raise ValueError(f"volumes must share their padded shape, got {sorted(shapes)}")
    n_dev = len(devices)
    regular = _regular(patch_size, step_fraction)
    g_size = min(max(1, volume_batch) if regular else 1, max(1, len(vols) // n_dev)) \
        if volume_batch > 1 else 1
    stack = vols + [vols[0]] * _shard_pad(len(vols), n_dev, g_size)
    per = len(stack) // n_dev
    replicas = [model if torch.device(next(model.parameters()).device) == d and i == 0
                else copy.deepcopy(model).to(d) for i, d in enumerate(devices)]

    def run(i):
        dev = devices[i]
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            out = predict_sliding_window_multi(
                replicas[i], stack[i * per:(i + 1) * per], patch_size, num_classes,
                device=dev, mirror_axes=mirror_axes, step_fraction=step_fraction,
                window_batch=window_batch, output=output, input_bf16=input_bf16,
                volume_batch=g_size)
        return out

    with ThreadPoolExecutor(max_workers=n_dev) as pool:
        shards = [f.result() for f in [pool.submit(run, i) for i in range(n_dev)]]
    return [r for shard in shards for r in shard][:len(vols)]
