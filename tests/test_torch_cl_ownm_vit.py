"""The port's OwnM1 and OwnM3 trainers with the ViT-U-Net (V1, depth-1 ViT,
embed 16, 2 heads) against the JAX package's on the CPU, at the widths of
``test_torch_cl_pod_trainers.py`` (the JAX POD repaired in the same way), 1
epoch of 3 steps a task over A, B: every step's loss and its KD / POD / EWC
terms and every parameter to 1e-4; OwnM1's EWC anchors on the ViT's
parameters only, OwnM3's on every parameter; OwnM3 with ``USE_SPT`` and no
SPT in its ViT (nothing reads the flag), its POD over the decoder taps
only."""

import pytest
import torch

from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu_torch.training.trainers.own import OwnM1Trainer, OwnM3Trainer
from tests.test_torch_cl_pod_trainers import (A, B, KW, assert_same_params, assert_same_steps,
                                              env, train_pair)

torch.set_num_threads(4)

__all__ = ["env"]   # the module-scoped fixture, shared

KW_VIT = dict(KW, num_epochs=1)
VIT = dict(use_vit=True, vit_depth_override=1)
PAIRS = {"ownm1": (jtrainers.OwnM1Trainer, OwnM1Trainer),
         "ownm3": (jtrainers.OwnM3Trainer, OwnM3Trainer)}


@pytest.fixture(scope="module")
def runs(env):
    return {ext: train_pair(env, ext, jcls, pcls, (A, B), KW_VIT, vit=VIT)
            for ext, (jcls, pcls) in PAIRS.items()}


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_vit_runs_give_the_jax_trainers_losses_and_parameters(runs, ext):
    jtr, ptr, _ = runs[ext]
    assert ptr.global_step == jtr.global_step == 6
    assert_same_steps(ptr, jtr)
    assert_same_params(jtr, ptr)
    keys = {t: sorted(d) for t, _, d in ptr.terms}
    assert keys[A] == [] and keys[B] == ["ewc_penalty", "mib_kd", "pod"]
    anchored = set(ptr.cl_state["ewc_tasks"][A]["params"])
    names = set(dict(ptr.model.named_parameters()))
    if ext == "ownm1":
        assert anchored == {k for k in names if "vit" in k.lower()} and anchored
    else:
        assert anchored == names


def test_ownm3_reads_no_spt_flag(runs):
    _, ptr, _ = runs["ownm3"]
    assert type(ptr).USE_SPT and not ptr.opts.vit_spt and not ptr.model.spt
    _, taps = ptr.model(torch.zeros((1, 1) + ptr.patch_size), capture_taps=True)
    assert {"bottleneck", "vit"} <= set(taps)
    assert sorted(k for k in taps if k.startswith("dec")) == \
        [f"dec{d}" for d in range(ptr.model.num_pool)]
