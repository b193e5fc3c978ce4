"""Least time of the window's SW launches at the card's peak rates
(yardstick.bound_s over the cells each call hands to LAUNCH_OBSERVERS)
over those kernels' device time in the profiler's trace, in %."""

from ema_bench.yardstick import PEAKS


def read(run):
    ds = run.device_summary
    peak = PEAKS.get(run.device_kind)
    if ds is None or peak is None:
        return None
    bounds = run.sw.bounds(peak)
    t = sum(ds["kernel_s"].get(k, 0.0) for k in bounds)
    return 100.0 * sum(bounds.values()) / t if t > 0 else None
