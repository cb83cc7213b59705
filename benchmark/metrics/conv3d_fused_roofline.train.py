"""Kernels: the fused 3x3x3 stride-1 conv + InstanceNorm + LeakyReLU
(``ops/kernels/conv3d.py`` -> ``ops/csrc/conv3d_in_lrelu.cu``), forward and
data gradient, in the traced train window: the least time of its work
(``arithmetic.conv3d_fused_launches``, from the layer shapes) over the
device time of the kernels below, in %."""

from benchmark import arithmetic

KERNELS = ("conv3d_tc_kernel", "conv3d_tc_reduce_kernel", "conv3d_stats_kernel",
           "in_stats_kernel", "in_lrelu_finalize_kernel")


def read(run):
    tr = run.stats.get("trace")
    if not run.stats.get("train") or not tr:
        return None
    launches = arithmetic.conv3d_fused_launches(run.config, run.stats["batch"], train=True)
    secs = arithmetic.kernel_seconds(tr["by_name"], KERNELS)
    if not launches or secs <= 0:
        return None
    return 100.0 * tr["steps"] * arithmetic.work_bound_s(launches) / secs
