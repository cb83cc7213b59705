"""Host input: the mean milliseconds a train step waited in
``Prefetcher.next()`` (``data/pipeline.py`` over ``data/sampler.py`` and
``data/native.py``), timed by the benchmark's own span around each call in
the measured window."""


def read(run):
    st = run.stats
    if not st.get("train") or not st.get("steps"):
        return None
    return 1e3 * st["input_wait_s"] / st["steps"]
