"""Kernels: InstanceNorm + LeakyReLU (``ops/kernels/instance_norm.py`` ->
``ops/csrc/instance_norm.cu``): every forward outside the fused conv and
every backward (the fused conv's too), in the traced train window: the
least time of its work (``arithmetic.instance_norm_launches``, bytes-bound)
over the device time of the kernels below, in %."""

from benchmark import arithmetic

KERNELS = ("in_fwd_warp_kernel", "in_fwd_cluster_kernel", "in_bwd_warp_kernel",
           "in_bwd_cluster_kernel", "sum_over_batch_kernel")


def read(run):
    tr = run.stats.get("trace")
    if not run.stats.get("train") or not tr:
        return None
    launches = arithmetic.instance_norm_launches(run.config, run.stats["batch"], train=True)
    secs = arithmetic.kernel_seconds(tr["by_name"], KERNELS)
    if not launches or secs <= 0:
        return None
    return 100.0 * tr["steps"] * arithmetic.work_bound_s(launches) / secs
