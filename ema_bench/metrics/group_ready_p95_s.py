"""95th percentile, over the barcode groups whose lines were handed on in
the window, of the program's ``stream.group`` spans: from align_stream's
pull of the group's last pair to when the pipeline hands its SAM lines
on (the program's own twin of group_latency_p95_s)."""

import numpy as np

from ema_bench import program_spans as ps


def read(run):
    d = ps.span_seconds(run, "stream.group")
    return float(np.percentile(d, 95)) if d else None
