"""Kernels: the fused 3x3x3 stride-1 conv + InstanceNorm + LeakyReLU
(``ops/kernels/conv3d.py`` -> ``ops/csrc/conv3d_in_lrelu.cu``), forward
only, in the traced serving window: the least time of its work for every
model batch served (``arithmetic.conv3d_fused_launches``, from the layer
shapes) over the device time of the kernels below, in %."""

from benchmark import arithmetic

KERNELS = ("conv3d_tc_kernel", "conv3d_tc_reduce_kernel", "conv3d_stats_kernel",
           "in_stats_kernel", "in_lrelu_finalize_kernel")


def read(run):
    tr = run.stats.get("trace")
    if run.stats.get("train", True) or not tr or not tr.get("forwards"):
        return None
    work = sum(arithmetic.work_bound_s(arithmetic.conv3d_fused_launches(run.config, b, False))
               for b in tr["forwards"])
    secs = arithmetic.kernel_seconds(tr["by_name"], KERNELS)
    if work <= 0 or secs <= 0:
        return None
    return 100.0 * work / secs
