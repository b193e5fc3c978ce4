"""Seconds the main thread spends reading pairs per 1,000 pairs emitted:
the fill of each flush batch from the group iterator (``stream.read``
spans) in the stream, each bucket file's read (``bucket.read``) in x."""

from ema_bench import program_spans as ps


def read(run):
    for name in ("stream.read", "bucket.read"):
        s = ps.stage_s(run, name)
        if s is not None:
            return ps.per_kpair(run, s)
    return None
