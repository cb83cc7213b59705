"""The device: the share (%) of the traced serving window (whole calls of
``predict_from_folder``) in which no operation ran on the card (the union
of the profiler's device intervals)."""


def read(run):
    tr = run.stats.get("trace")
    if run.stats.get("train", True) or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
