"""Time the halo'd block pack (``pack_blocks``, bf16) by device time per
launch (torch.profiler; a call of 1 ms or more by CUDA events, by the rule
of ``flash_probe.device_kernels``) at the shapes the CT routes give it, summed with
their launches per CT train step (B=2) and per CT serving forward (B=64),
each beside its bytes bound, the library chain and the plain version; with
``--copies``, the other three copy kernels (unpack, interleave,
de-interleave) per CT train step the same way; with ``--sweep``, this
tree's TMA-form pack under other layouts than its launch plan's.

    python3 lifelong_nnunet_tpu_torch/tools/pack_probe.py [--root DIR] [--groups G ...]
        [--copies] [--sweep]

``--root`` imports the package from another checkout (an earlier commit
unpacked by ``git archive``, say), so that two versions can be timed in
turns on one card, each in its own process; chip_smoke.py runs it in a
process of its own (a profiler started late in a long process loses
device events).  The library chain is ``F.pad`` + ``Tensor.unfold``
materialized (the pack), the inverse permute (unpack) and
``F.conv_transpose3d`` forward and backward (the whole upsample, beside
the interleaves); the port never calls them.  The bound counts each input
read once and each output written once, at 3.35 TB/s.  Prints a JSON line
per group (or per swept shape), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys

# the serving shapes allocate and free tens of GB at a time
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

try:  # the running tree's timing, also where --root imports another package
    from .flash_probe import device_ms
except ImportError:  # run as a script
    from flash_probe import device_ms

PEAK_BYTES = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
BS = 32
# the CT U-Net (patch 128^3, five pools, 32 -> 320 features) on the blocked
# route: (x shape without the batch, launches) of the pack at bs 32 per
# train step (its forward at the 7 blocked convs' inputs, its backward at
# the outputs of the 5 stride-1 blocked convs after the first) and per
# serving forward (the 7); chip_smoke.py holds them to the model's routes
PACK_TRAIN = (((1, 128, 128, 128), 1), ((32, 128, 128, 128), 6), ((64, 64, 64, 64), 4),
              ((64, 128, 128, 128), 1))
PACK_SERVE = (((1, 128, 128, 128), 1), ((32, 128, 128, 128), 3), ((64, 64, 64, 64), 2),
              ((64, 128, 128, 128), 1))
GROUPS = {"ct_train": (2, PACK_TRAIN), "ct_serve": (64, PACK_SERVE)}
# per train step (B=2): (y shape [nb, C, s, s, s], grid, launches) of the
# unpack, and (upsample input shape, weight shape, launches) of the
# interleave (forward) and the de-interleave (backward)
UNPACK_TRAIN = (((128, 32, 32, 32, 32), (4, 4, 4), 6), ((128, 64, 16, 16, 16), (4, 4, 4), 1),
                ((16, 64, 32, 32, 32), (2, 2, 2), 4), ((128, 64, 32, 32, 32), (4, 4, 4), 1))
ILEAVE_TRAIN = (((2, 128, 32, 32, 32), (128, 64, 2, 2, 2), 1),
                ((2, 64, 64, 64, 64), (64, 32, 2, 2, 2), 1))
# plain versions are timed where x takes at most this many bytes (their
# temporaries are several such copies)
PLAIN_BYTES = 20e9


def nbytes(x_shape, bs: int = BS, size: int = 2) -> int:
    """Bytes one pack launch must move: x read once, the windows written once."""
    B, C, D, H, W = x_shape
    return size * (B * C * D * H * W + B * C * (D // bs) * (H // bs) * (W // bs) * (bs + 2) ** 3)


def library_pack(x, bs: int = BS):
    """The halo'd windows through F.pad and Tensor.unfold, materialized."""
    S, C = bs + 2, x.shape[1]
    u = F.pad(x, (1,) * 6).unfold(2, S, bs).unfold(3, S, bs).unfold(4, S, bs)
    return u.permute(0, 2, 3, 4, 1, 5, 6, 7).reshape(-1, C, S, S, S)


def library_unpack(y, batch, grid):
    """The inverse permute of the unfold chain, materialized."""
    nd, nh, nw = grid
    C, s = y.shape[1], y.shape[2]
    return y.view(batch, nd, nh, nw, C, s, s, s).permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(
        batch, C, nd * s, nh * s, nw * s)


def octants(x, w):
    """The upsample's eight octant products [N, 8, Co D, H, W]: the
    interleave kernel's input on the main path."""
    N, Ci, D, H, W = x.shape
    Co = w.shape[1]
    w8 = w.to(x.dtype).permute(2, 3, 4, 1, 0).reshape(8 * Co, Ci)
    return torch.bmm(w8.expand(N, -1, -1), x.reshape(N, Ci, -1)).view(N, 8, Co * D, H, W)


def _reps(n: int) -> int:
    """Calls per reading of a launch that moves ``n`` bytes: 50 where its
    bound is under a millisecond (profiled: the more calls a window has,
    the less one event lost at its edge weighs), else 10 (timed by CUDA
    events)."""
    return 50 if n < PEAK_BYTES * 1e-3 else 10


def _row(what, count, n, kernel, library, plain, fits):
    """Device ms of one launch of ``kernel`` and ``library`` in turns
    (kernel, library, library, kernel), ``plain``'s where ``fits``."""
    reps = _reps(n)
    turns = [device_ms(fn, reps) for fn in (kernel, library, library, kernel)]
    return {**what, "count": count, "ms": (turns[0] + turns[3]) / 2,
            "library_ms": (turns[1] + turns[2]) / 2,
            "plain_ms": device_ms(plain, reps) if fits else None,
            "bound_ms": n / PEAK_BYTES * 1e3, "turns": [round(t, 5) for t in turns]}


def _sums(rows) -> dict:
    tot = {}
    for k in ("ms", "library_ms", "plain_ms", "bound_ms"):
        vals = [r[k] for r in rows]
        tot[k] = None if None in vals else sum(r["count"] * v for r, v in zip(rows, vals))
    return {**tot, "share": tot["bound_ms"] / tot["ms"]}


def time_group(name: str, gen) -> dict:
    """Device ms of the pack per train step or serving forward of group
    ``name``: per shape one launch of the kernel and the library chain in
    turns, the plain version where it fits PLAIN_BYTES, the bound; sums
    weighted by the launches; the kernel's launches by form, where the
    package counts them; and the card's streaming ceiling for a kernel:
    PyTorch's elementwise kernel on x (``torch.mul(x, 1, out=y)``, which
    moves a copy's bytes; not the same function), its share of its own
    bytes bound (x read and written once) over the group."""
    from lifelong_nnunet_tpu_torch.ops.kernels import block_pack
    B, shapes = GROUPS[name]
    forms = getattr(block_pack.pack_blocks, "forms", None)
    before = dict(forms) if forms is not None else None
    rows, copy_ms, copy_bound = [], 0.0, 0.0
    for shape, count in shapes:
        x_shape = (B,) + shape
        x = torch.randn(x_shape, generator=gen, device=gen.device, dtype=torch.bfloat16)
        rows.append(_row({"x": list(x_shape)}, count, nbytes(x_shape),
                         lambda: block_pack.pack_blocks(x, BS), lambda: library_pack(x),
                         lambda: block_pack.plain_pack_blocks(x, BS),
                         2 * x.numel() <= PLAIN_BYTES))
        y = torch.empty_like(x)
        copy_ms += count * device_ms(lambda: torch.mul(x, 1, out=y), _reps(4 * x.numel()))
        copy_bound += count * 4 * x.numel() / PEAK_BYTES * 1e3
        del x, y
        torch.cuda.empty_cache()
    used = None if forms is None else [f for f in forms if forms[f] > before[f]]
    return {"group": name, "batch": B, **_sums(rows), "forms_used": used,
            "copy_share": copy_bound / copy_ms, "shapes": rows}


def time_copies(gen) -> dict:
    """Device ms per CT train step (B=2) of the unpack, the interleave and
    the de-interleave, each beside its bound, its library call and its
    plain version, as :func:`time_group` gives the pack's."""
    from lifelong_nnunet_tpu_torch.ops.kernels import block_pack, interleave
    dev = gen.device
    out = {}
    rows = []
    for y_shape, grid, count in UNPACK_TRAIN:
        y = torch.randn(y_shape, generator=gen, device=dev, dtype=torch.bfloat16)
        B = y_shape[0] // math.prod(grid)
        rows.append(_row({"y": list(y_shape), "grid": list(grid)}, count, 4 * y.numel(),
                         lambda: block_pack.unpack_blocks(y, B, grid),
                         lambda: library_unpack(y, B, grid),
                         lambda: block_pack.plain_unpack_blocks(y, B, grid), True))
    out["unpack_blocks"] = {**_sums(rows), "shapes": rows}
    up, down = [], []
    for h_shape, w_shape, count in ILEAVE_TRAIN:
        x = torch.randn(h_shape, generator=gen, device=dev, dtype=torch.bfloat16)
        w = torch.randn(w_shape, generator=gen, device=dev) * math.sqrt(1.0 / w_shape[0])
        wb = w.to(torch.bfloat16)
        parts = octants(x, w).unbind(1)
        dense = interleave._interleave(parts)
        n = 2 * 2 * dense.numel()
        up.append(_row({"x": list(h_shape)}, count, n, lambda: interleave._interleave(parts),
                       lambda: F.conv_transpose3d(x, wb, stride=2),
                       lambda: interleave.plain_interleave(parts), True))
        xs, ws = x.detach().requires_grad_(), wb.detach().requires_grad_()
        y = F.conv_transpose3d(xs, ws, stride=2)
        g = torch.randn(y.shape, generator=gen, device=dev, dtype=torch.bfloat16)
        down.append(_row({"x": list(h_shape)}, count, n,
                         lambda: interleave._deinterleave(dense, 2),
                         lambda: torch.autograd.grad(y, (xs, ws), g, retain_graph=True),
                         lambda: torch.stack(interleave.plain_deinterleave(dense, 2), 1),
                         True))
    out["interleave_up2"] = {**_sums(up), "shapes": up}
    out["deinterleave2"] = {**_sums(down), "shapes": down}
    return {"group": "ct_copies", "batch": 2, "kernels": out}


def _key(p) -> str:
    return f"gw{p.gw}/sz{p.sz}/st{p.stages}/{p.blocks}b"


def sweep(gen) -> list:
    """This tree's TMA-form pack at the CT train step's shapes and the
    largest serving shape under other layouts than the plan's: boxes of one
    window or of the plan's row of windows x 2-12 planes x 2-6 stages x 1-2
    blocks an SM, device ms per launch of each."""
    from lifelong_nnunet_tpu_torch.ops.kernels import block_pack as bp
    from lifelong_nnunet_tpu_torch.ops.kernels import build
    ext = build.load_extension()
    dev = gen.device
    sms = bp.card_sms(dev)
    res = []
    for B, (shape, _) in [(2, s) for s in PACK_TRAIN] + [(64, PACK_SERVE[-1])]:
        x_shape = (B,) + shape
        x = torch.randn(x_shape, generator=gen, device=dev, dtype=torch.bfloat16)
        plan = bp.launch_plan(x_shape, BS, x.dtype, x.data_ptr(), sms)
        nb = x_shape[0] * math.prod(s // BS for s in shape[1:])
        out = torch.empty((nb, shape[0]) + (BS + 2,) * 3, dtype=x.dtype, device=dev)
        ref = bp.plain_pack_blocks(x[:1], BS)
        per = nb // B
        times, seen = {}, set()
        for gw, sz, stages, per_sm in itertools.product(
                sorted({1, plan.gw}), (2, 4, 12), (2, 3, 4, 6), (1, 2)):
            p = bp.tma_plan(x_shape, BS, x.dtype, sz, stages, per_sm, sms, gw)
            if p.smem > bp.SMEM_BLOCK or p.args() in seen:
                continue
            seen.add(p.args())
            ext.pack_blocks(x, out, BS, *p.args())
            torch.cuda.synchronize()
            assert torch.equal(out[:per], ref), p
            times[_key(p)] = round(device_ms(
                lambda: ext.pack_blocks(x, out, BS, *p.args()),
                _reps(nbytes(x_shape))), 5)
        best = min(times, key=times.get)
        mine = _key(plan)
        res.append({"x": list(x_shape), "plan": mine, "plan_ms": times.get(mine),
                    "best": best, "best_ms": times[best],
                    "bound_ms": nbytes(x_shape) / PEAK_BYTES * 1e3, "times": times})
        del x, out, ref
        torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose package is timed")
    ap.add_argument("--groups", nargs="*", default=list(GROUPS), choices=list(GROUPS))
    ap.add_argument("--copies", action="store_true",
                    help="time the unpack and the interleaves per CT train step too")
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's TMA-form pack under other layouts instead")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise SystemExit("pack_probe needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    root = os.path.abspath(args.root)
    if args.sweep:
        for row in sweep(gen):
            print(json.dumps({"card": card, **row}), flush=True)
        return 0
    for name in args.groups:
        print(json.dumps({"root": root, "card": card, **time_group(name, gen)}), flush=True)
    if args.copies:
        print(json.dumps({"root": root, "card": card, **time_copies(gen)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
