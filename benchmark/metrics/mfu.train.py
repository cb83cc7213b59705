"""The whole train step (``training/train_step.py`` on ``models/unet.py``):
its model FLOPs (three times the forward's convs, transposed convs and
heads, from the configuration's layer shapes) over the measured window's
seconds per step times the bf16 peak, in %."""

from benchmark import arithmetic


def read(run):
    st = run.stats
    if not st.get("train") or not st.get("steps"):
        return None
    flops = arithmetic.model_flops(run.config, st["batch"], train=True)
    return 100.0 * flops / (st["step_s"] * arithmetic.PEAK_BF16_FLOPS)
