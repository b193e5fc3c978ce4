"""Seconds the main thread waits on the chunk pool for a chunk's
candidates (``pool.wait`` spans) per 1,000 pairs emitted: near 0 where
the main thread sets the pace, large where the chunk workers (seeding,
SW) do."""

from ema_bench import program_spans as ps


def read(run):
    return ps.per_kpair(run, ps.stage_s(run, "pool.wait"))
