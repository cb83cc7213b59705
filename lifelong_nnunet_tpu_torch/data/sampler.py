"""Foreground-oversampled patch sampling on the host: the port of
``lifelong_nnunet_tpu/data/sampler.py`` (its numpy path).

Each batch draws random cases; the last ``round(B * oversample)`` samples
(nnU-Net: 1/3) are forced to contain a random foreground class by centring
the patch on a sampled location of that class.  Out-of-volume regions are
padded (data 0, seg -1).  The random stream is the JAX sampler's, draw for
draw (``np.random.RandomState(seed)``), so one seed gives the same batches
in both packages; the output is channels-first, PyTorch's layout:
``data [B, C, *patch]`` float32, ``seg [B, *patch]`` int8.

``shard=(i, n)`` is the JAX package's multi-host input split: node ``i``
of ``n`` samples the contiguous rows ``[i B / n, (i + 1) B / n)`` of the
global batch ``B``, with the forced-foreground rule evaluated at global
positions and the random stream ``seed + 7919 i``.  ``rows=(lo, hi)``
splits the node's rows between its ranks: every rank draws the node's
whole random sequence (cases, slices, origins), so the draws stay the
JAX sampler's, and reads and gathers only its own rows.  On one host,
``-n_devices N`` thus trains on exactly the batch that the JAX trainer
draws with ``n_devices=N``.

A 3D sampler gathers with the C++ engine (``data/native.py``, the JAX
package's ``_next_batch_native``): the same draws, the patches copied on
threads outside the interpreter lock; ``native=False`` keeps the numpy
path, which the tests hold it to bit for bit.

``next_batch`` is the span ``sampler.next_batch`` (``tracing.py``): the
draws and the gather, carrying the batch's number, its place in the
sampler's stream counted from 0 (a ``Prefetcher`` over a new sampler gives
its batches the same numbers).
"""

from __future__ import annotations

import numpy as np

from .. import tracing
from . import native as native_gather
from .dataset import PreprocessedDataset


class PatchSampler:
    def __init__(self, dataset: PreprocessedDataset | None, cases: list, patch_size,
                 batch_size: int, oversample_foreground_percent: float = 0.33,
                 seed: int = 0, shard: tuple = (0, 1), rows: tuple | None = None,
                 native: bool = True):
        """``cases`` entries are case-name strings (resolved against
        ``dataset``) or explicit ``(PreprocessedDataset, case)`` pairs;
        ``batch_size`` is the global batch, ``shard`` and ``rows`` this
        sampler's part of it (module docstring)."""
        if not cases:
            raise ValueError("empty case list")
        self.items = [(dataset, c) if isinstance(c, str) else tuple(c) for c in cases]
        self.patch_size = tuple(int(p) for p in patch_size)
        self.dim = len(self.patch_size)
        self.global_batch_size = int(batch_size)
        self.shard_index, self.shard_count = int(shard[0]), int(shard[1])
        if not 0 <= self.shard_index < self.shard_count:
            raise ValueError(f"shard {shard}: index outside [0, count)")
        if batch_size % self.shard_count:
            raise ValueError(f"global batch {batch_size} must divide evenly over "
                             f"{self.shard_count} input shards (hosts)")
        self.node_batch = self.global_batch_size // self.shard_count
        self.rows = tuple(rows) if rows is not None else (0, self.node_batch)
        if not 0 <= self.rows[0] < self.rows[1] <= self.node_batch:
            raise ValueError(f"rows {self.rows} outside the node's {self.node_batch}")
        self.batch_size = self.rows[1] - self.rows[0]
        self.oversample = oversample_foreground_percent
        self.native = bool(native) and self.dim == 3
        self.rng = np.random.RandomState(seed + 7919 * self.shard_index)
        self.batches = 0            # batches drawn so far

    def _needs_fg(self, sample_idx: int) -> bool:
        """The nnU-Net rule at the global position of the node's sample
        ``sample_idx``: the last round(B * oversample) are forced-fg."""
        global_idx = self.shard_index * self.node_batch + sample_idx
        return global_idx >= round(self.global_batch_size * (1 - self.oversample))

    def _draw(self, i: int):
        """The draws of the node's sample ``i``: (case key, the array the
        patch is cut from, its origin)."""
        ds, case = self.items[self.rng.randint(len(self.items))]
        arr = ds.load(case)                           # [C+1, X, Y, Z] memmap
        force_fg = self._needs_fg(i)
        if self.dim == 2:
            # 2D config: a random slice along the leading (coarsest) axis
            z = self.rng.randint(arr.shape[1])
            arr = arr[:, z]
            return case, arr, self._sample_origin(arr, ds, case, force_fg, slice_z=z)
        return case, arr, self._sample_origin(arr, ds, case, force_fg)

    def _random_origin(self, spatial) -> list:
        patch = self.patch_size
        return [self.rng.randint(min(0, spatial[a] - patch[a]),
                                 max(1, spatial[a] - patch[a] + 1))
                for a in range(len(patch))]

    def _sample_origin(self, arr, ds, case: str, force_fg: bool, slice_z=None):
        """Random (possibly out-of-volume) patch origin, force-fg aware."""
        spatial = arr.shape[1:]
        patch = self.patch_size
        if not force_fg:
            return self._random_origin(spatial)
        locs = ds.class_locations(case)
        classes = [c for c, v in locs.items() if len(v) > 0]
        if not classes:
            return self._random_origin(spatial)
        pts = locs[classes[self.rng.randint(len(classes))]]
        if slice_z is not None:
            on_slice = pts[pts[:, 0] == slice_z]
            pts = on_slice if len(on_slice) else pts
        center = pts[self.rng.randint(len(pts))]
        if slice_z is not None:
            center = center[-len(patch):]
        return [int(center[a]) - patch[a] // 2 for a in range(len(patch))]

    def _crop(self, arr, lo):
        """The padded patch at origin ``lo``: (data [C, *patch], seg [*patch])."""
        spatial = arr.shape[1:]
        patch = self.patch_size
        pads, sl = [(0, 0)], []
        for a in range(len(patch)):
            start, stop = lo[a], lo[a] + patch[a]
            pads.append((max(0, -start), max(0, stop - spatial[a])))
            sl.append(slice(max(0, start), min(spatial[a], stop)))
        crop = np.asarray(arr[(slice(None),) + tuple(sl)])
        data = np.pad(crop[:-1], pads, mode="constant", constant_values=0.0)
        seg = np.pad(crop[-1:], pads, mode="constant", constant_values=-1.0)
        return data, seg[0]

    def next_batch(self) -> dict:
        """This sampler's rows of the next global batch."""
        with tracing.span("sampler.next_batch", batch=self.batches):
            self.batches += 1
            draws = [self._draw(i) for i in range(self.node_batch)][self.rows[0]:self.rows[1]]
            keys = [case for case, _, _ in draws]
            if self.native:
                data, seg = native_gather.gather_patches(
                    [arr for _, arr, _ in draws], [lo for _, _, lo in draws], self.patch_size)
                return {"data": data, "seg": seg, "keys": keys}
            crops = [self._crop(arr, lo) for _, arr, lo in draws]
            return {"data": np.stack([d for d, _ in crops]).astype(np.float32),
                    "seg": np.stack([s for _, s in crops]).astype(np.int8), "keys": keys}

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()
