"""Foreground-oversampled patch sampling on the host: the port of
``lifelong_nnunet_tpu/data/sampler.py`` (its numpy path).

Each batch draws random cases; the last ``round(B * oversample)`` samples
(nnU-Net: 1/3) are forced to contain a random foreground class by centring
the patch on a sampled location of that class.  Out-of-volume regions are
padded (data 0, seg -1).  The random stream is the JAX sampler's, draw for
draw (``np.random.RandomState(seed)``), so one seed gives the same batches
in both packages; the output is channels-first, PyTorch's layout:
``data [B, C, *patch]`` float32, ``seg [B, *patch]`` int8.

One process feeds one device, so the JAX package's multi-host input shard
is always (0, 1) here.  Its C++ gather engine (``csrc/patch_gather.cpp``)
is host code and waits for a later part of the port.
"""

from __future__ import annotations

import numpy as np

from .dataset import PreprocessedDataset


class PatchSampler:
    def __init__(self, dataset: PreprocessedDataset | None, cases: list, patch_size,
                 batch_size: int, oversample_foreground_percent: float = 0.33,
                 seed: int = 0):
        """``cases`` entries are case-name strings (resolved against
        ``dataset``) or explicit ``(PreprocessedDataset, case)`` pairs."""
        assert len(cases) > 0, "empty case list"
        self.items = [(dataset, c) if isinstance(c, str) else tuple(c) for c in cases]
        self.patch_size = tuple(int(p) for p in patch_size)
        self.dim = len(self.patch_size)
        self.batch_size = int(batch_size)
        self.oversample = oversample_foreground_percent
        self.rng = np.random.RandomState(seed)

    def _needs_fg(self, sample_idx: int) -> bool:
        return sample_idx >= round(self.batch_size * (1 - self.oversample))

    def _extract(self, ds: PreprocessedDataset, case: str, force_fg: bool):
        arr = ds.load(case)                           # [C+1, X, Y, Z] memmap
        if self.dim == 2:
            # 2D config: a random slice along the leading (coarsest) axis
            z = self.rng.randint(arr.shape[1])
            return self._extract_nd(arr[:, z], ds, case, force_fg, slice_z=z)
        return self._extract_nd(arr, ds, case, force_fg)

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

    def _extract_nd(self, arr, ds, case: str, force_fg: bool, slice_z=None):
        spatial = arr.shape[1:]
        patch = self.patch_size
        lo = self._sample_origin(arr, ds, case, force_fg, slice_z)
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
        datas, segs, keys = [], [], []
        for i in range(self.batch_size):
            ds, case = self.items[self.rng.randint(len(self.items))]
            data, seg = self._extract(ds, case, self._needs_fg(i))
            datas.append(data)
            segs.append(seg)
            keys.append(case)
        return {"data": np.stack(datas).astype(np.float32),
                "seg": np.stack(segs).astype(np.int8), "keys": keys}

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()
