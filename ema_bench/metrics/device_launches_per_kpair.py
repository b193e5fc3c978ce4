"""Kernels, copies and memsets on the device in the profiled window per
1,000 pairs emitted."""


def read(run):
    ds = run.device_summary
    if ds is None or not ds["n_events"] or not run.pairs:
        return None
    return ds["n_events"] / (run.pairs / 1000.0)
