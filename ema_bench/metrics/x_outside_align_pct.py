"""Share of each ``align -x`` call's wall time outside its ``align``
stage (index load, Aligner set-up, bucket reads, part writes and the
final concatenation), summed over the window's calls, from the stage
table of the CLI's own Metrics."""


def read(run):
    calls = getattr(run.driver, "calls", None)
    if not calls:
        return None
    wall = sum(c[2] for c in calls)
    align = sum(c[3].get("align", 0.0) for c in calls)
    return 100.0 * (wall - align) / wall if wall > 0 else None
