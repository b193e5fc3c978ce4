"""Read pairs whose two SAM records were emitted in the window, over the
window's wall time (host clock): all the work and all the time."""


def read(run):
    return run.pairs / run.wall if run.wall > 0 else None
