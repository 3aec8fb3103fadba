"""Percent of its roofline that the probe kernels reach in the traced
window: the least time of their launches by the frozen byte rule
(``zbench/roofline.py``, the mean over the first recorded calls times the
launches in the trace) over their time in the trace, by kernel name."""


def read(run):
    ts = run.trace_summary
    bound = getattr(run, "probe_bound_ms", None)
    if ts is None or bound is None or not ts["probe_n"] or ts["probe_s"] <= 0:
        return None
    return 100.0 * bound * 1e-3 * ts["probe_n"] / ts["probe_s"]
