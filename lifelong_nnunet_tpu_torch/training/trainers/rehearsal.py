"""Rehearsal trainer (experience replay): the port of
``lifelong_nnunet_tpu/training/trainers/rehearsal.py``.

The training pool of a task holds its own train cases and, for every
earlier task registered with the trainer, in registration order,
``max(1, round(samples_in_perc * n))`` of its ``n`` train cases, drawn
without replacement by one ``np.random.RandomState(3299)`` (the
reference's ``nnUNetTrainerRehearsal.py:65-173``).  Validation uses the
current task only.  Heads transfer, as in the Sequential trainer.  The
pool's sampler takes the rank's shard and rows, as the trainer's do.
"""

from __future__ import annotations

import numpy as np

from ...data.sampler import PatchSampler
from ..trainer import OVERSAMPLE_FOREGROUND, SEED, MultiHeadTrainer

REHEARSAL_SEED = 3299  # reference run_training.py:164


class RehearsalTrainer(MultiHeadTrainer):
    EXTENSION = "rehearsal"
    TRANSFER_HEADS = True
    HYPERPARAMS = {"samples_in_perc": float}

    def __init__(self, *args, samples_in_perc: float = 0.25, **kw):
        super().__init__(*args, samples_in_perc=samples_in_perc, **kw)
        self.samples_in_perc = float(samples_in_perc)

    def rehearsal_pool(self, task: str) -> list:
        """[(dataset, case)]: ``task``'s train cases, then each earlier
        task's rehearsed cases."""
        ds, tr, _ = self._datasets[task]
        pool = [(ds, c) for c in tr]
        rng = np.random.RandomState(REHEARSAL_SEED)
        for prev, (pds, ptr, _pval) in self._datasets.items():
            if prev == task:
                continue
            n = max(1, int(round(self.samples_in_perc * len(ptr))))
            chosen = rng.choice(len(ptr), size=min(n, len(ptr)), replace=False)
            pool += [(pds, ptr[i]) for i in chosen]
        return pool

    def _make_sampler(self, task: str, train: bool = True, seed_offset: int = 0):
        if not train:
            return super()._make_sampler(task, train, seed_offset)
        return PatchSampler(None, self.rehearsal_pool(task), self.patch_size,
                            self.batch_size,
                            oversample_foreground_percent=OVERSAMPLE_FOREGROUND,
                            seed=SEED + seed_offset, **self._sampler_shard())
