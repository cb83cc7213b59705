"""The kernels' build and binding, checked without a compiler: one
``cpp_extension.load`` of every source, PyTorch's headers in the binding
alone, every launcher defined once and bound, the build directory in the
checkout, and no quiet fallback for a tensor the kernels cannot take."""

import re

import pytest
import torch

from lifelong_nnunet_tpu_torch.ops.kernels import build
from lifelong_nnunet_tpu_torch.ops.kernels.attention import flash_attention, flash_attention_bwd
from lifelong_nnunet_tpu_torch.ops.kernels.block_pack import pack_blocks, unpack_blocks
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import conv3d_dx_cf, conv3d_in_lrelu_cf
from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (
    instance_norm_leaky_bwd_cf, instance_norm_leaky_cf)
from lifelong_nnunet_tpu_torch.ops.kernels.interleave import (
    conv_transpose3d_interleave, deinterleave2, interleave_up2)

TORCH_INCLUDE = re.compile(r'#include\s*[<"](torch|ATen|c10|pybind11)/')
CSRC_FILES = sorted(p.name for p in build.CSRC.iterdir())


def _launchers() -> list:
    header = (build.CSRC / "lnn_kernels.h").read_text()
    return re.findall(r"^\S.*?\b(lnn_\w+)\(", header, re.M)


def test_one_load_builds_every_source_for_sm_90a():
    names = [p.name for p in build.sources()]
    assert names == ["binding.cpp", "block_pack.cu", "conv3d_in_lrelu.cu", "conv3d_wgrad.cu",
                     "flash_attention.cu", "instance_norm.cu", "interleave.cu"]
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.CUDA_FLAGS


@pytest.mark.parametrize("name", CSRC_FILES)
def test_only_the_binding_includes_torch_headers(name):
    text = (build.CSRC / name).read_text()
    if name == "binding.cpp":
        assert "#include <torch/extension.h>" in text
        assert '#include "lnn_kernels.h"' in text
    else:
        assert not TORCH_INCLUDE.search(text), name


def test_the_header_declares_the_launchers():
    assert _launchers() == ["lnn_instance_norm_limits", "lnn_instance_norm_leaky_fwd",
                            "lnn_instance_norm_leaky_bwd",
                            "lnn_conv3d_partials_len", "lnn_conv3d_in_lrelu_fwd",
                            "lnn_conv3d_in_lrelu_train_fwd", "lnn_conv3d_fwd",
                            "lnn_conv3d_tc_weight_len", "lnn_conv3d_tc_partials_len",
                            "lnn_conv3d_tc_workspace_len", "lnn_conv3d_tc",
                            "lnn_conv3d_wgrad_workspace_len", "lnn_conv3d_wgrad_tc",
                            "lnn_flash_attention_fwd", "lnn_flash_attention_bwd",
                            "lnn_flash_attention_tc_fwd", "lnn_flash_attention_tc_bwd",
                            "lnn_pack_tma_layout", "lnn_pack_blocks", "lnn_unpack_blocks",
                            "lnn_interleave_up2", "lnn_deinterleave2"]


@pytest.mark.parametrize("launcher", _launchers())
def test_every_launcher_is_defined_once_and_bound(launcher):
    defined = [p.name for p in build.CSRC.glob("*.cu")
               if re.search(rf"^\S.*\b{launcher}\(", p.read_text(), re.M)]
    assert len(defined) == 1, defined
    assert '#include "lnn_common.cuh"' in (build.CSRC / defined[0]).read_text()
    assert f"{launcher}(" in (build.CSRC / "binding.cpp").read_text()


def test_library_lands_in_the_checkouts_build_directory():
    root = build.CSRC.parents[2]
    assert (root / "setup.py").is_file()
    assert build.build_dir() == root / "build" / "kernels"


def test_installed_copy_builds_under_the_user_cache(tmp_path, monkeypatch):
    fake = tmp_path / "site-packages" / "lifelong_nnunet_tpu_torch" / "ops" / "kernels"
    fake.mkdir(parents=True)
    monkeypatch.setattr(build, "__file__", str(fake / "build.py"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir() == tmp_path / "cache" / "lifelong_nnunet_tpu_torch" / "kernels"


@pytest.mark.parametrize("call", [
    lambda x: conv3d_in_lrelu_cf(x, torch.ones(2, 2, 3, 3, 3, device="meta"),
                                 torch.ones(2, device="meta"),
                                 torch.zeros(2, device="meta")),
    lambda x: instance_norm_leaky_cf(x, torch.ones(2, device="meta"),
                                     torch.zeros(2, device="meta")),
    lambda x: conv3d_in_lrelu_cf(x.requires_grad_(),
                                 torch.ones(2, 2, 3, 3, 3, device="meta"),
                                 torch.ones(2, device="meta"),
                                 torch.zeros(2, device="meta")),
    lambda x: instance_norm_leaky_cf(x.requires_grad_(), torch.ones(2, device="meta"),
                                     torch.zeros(2, device="meta")),
    lambda x: conv3d_dx_cf(x, torch.ones(2, 2, 3, 3, 3, device="meta")),
    lambda x: instance_norm_leaky_bwd_cf(
        x, torch.ones(2, device="meta"), torch.zeros(2, device="meta"),
        torch.zeros(1, 2, device="meta"), torch.ones(1, 2, device="meta"), x),
    lambda x: flash_attention(x[0], x[0], x[0]),
    lambda x: flash_attention(x[0].requires_grad_(), x[0], x[0]),
    lambda x: flash_attention_bwd(x[0], x[0], x[0], x[0], x[0, :, :, :, 0], x[0]),
    lambda x: pack_blocks(x, 4),
    lambda x: unpack_blocks(x, 1, (1, 1, 1)),
    lambda x: interleave_up2(*[x[0, 0]] * 4),
    lambda x: deinterleave2(x.view(4, 2, 4, 4)),
    lambda x: conv_transpose3d_interleave(x.requires_grad_(),
                                          torch.ones(2, 3, 2, 2, 2, device="meta")),
], ids=["conv3d_in_lrelu", "instance_norm_leaky", "conv3d_in_lrelu_train",
        "instance_norm_leaky_train", "conv3d_dx", "instance_norm_leaky_bwd",
        "flash_attention", "flash_attention_train", "flash_attention_bwd", "pack_blocks",
        "unpack_blocks", "interleave_up2", "deinterleave2", "conv_transpose3d_interleave"])
def test_wrappers_take_the_plain_version_only_for_cpu_tensors(call, monkeypatch):
    """A tensor off the CPU goes to the kernel or raises, forward or
    backward, with autograd recording or not: here (a meta tensor) it
    raises before any build, and the launch counts stay."""
    monkeypatch.setattr(build, "load_extension", lambda: pytest.fail("built"))
    counted = (conv3d_in_lrelu_cf, instance_norm_leaky_cf, conv3d_dx_cf,
               instance_norm_leaky_bwd_cf, flash_attention, flash_attention_bwd,
               pack_blocks, unpack_blocks, interleave_up2, deinterleave2)
    split = (conv3d_in_lrelu_cf, conv3d_dx_cf, flash_attention, flash_attention_bwd)
    before = [f.launches for f in counted] + [f.tc_launches for f in split]
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.ones(1, 2, 4, 4, 4, device="meta"))
    assert [f.launches for f in counted] + [f.tc_launches for f in split] == before
