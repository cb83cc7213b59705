"""The whole serving forward (``inference/sliding_window.py`` on
``models/unet.py``): the forward FLOPs of every model batch (windows x
mirrors) served in the measured window, from the configuration's layer
shapes, over the window's seconds times the bf16 peak, in %."""

from benchmark import arithmetic


def read(run):
    st = run.stats
    if st.get("train", True) or not st.get("forwards"):
        return None
    flops = sum(arithmetic.model_flops(run.config, b, train=False) for b in st["forwards"])
    return 100.0 * flops / (st["window_s"] * arithmetic.PEAK_BF16_FLOPS)
