"""Peak resident memory of the process in the window, VmRSS of
/proc/self/status sampled every 50 ms, in GiB."""


def read(run):
    return run.rss.peak / 2 ** 30 if run.rss.peak else None
