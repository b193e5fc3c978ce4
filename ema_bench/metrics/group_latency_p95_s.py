"""95th percentile, over every barcode group completed in the window, of
the time from when align_stream pulled the group's last pair to when the
list holding its last SAM line came back (host clock)."""

import numpy as np


def read(run):
    lat = getattr(run.driver, "latencies", None)
    return float(np.percentile(lat, 95)) if lat else None
