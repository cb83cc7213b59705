"""The device: the share (%) of the traced train window in which no
operation ran on the card (the union of the profiler's device intervals)."""


def read(run):
    tr = run.stats.get("trace")
    if not run.stats.get("train") or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
