"""100 x (1 - the union of the device's activity over the profiled
window's length)."""


def read(run):
    ds = run.device_summary
    if ds is None or not ds["n_events"]:
        return None
    return 100.0 * (1.0 - ds["busy_s"] / ds["window_s"])
