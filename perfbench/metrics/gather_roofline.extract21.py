"""gather_roofline.extract21 (%, higher; device trace; layer kernels; moves
extract_points_per_s): the least time of the profiled extractions' position
gathers from the bf16 table (K1 bf16 D=3, one a batch: the float32 points
in, the float32 features out, and of the table at each level at most 8 rows
of 4 bytes a point and at most the level's rows; ``perfbench/
work_table.py``) over K1's device time (``hash_gather_``)."""

from perfbench.work_table import GATHER_KERNEL, gather_least_seconds_of


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    t = run.trace.kernel_seconds(GATHER_KERNEL)
    if not t:
        return None
    return 100.0 * gather_least_seconds_of(run.config["pipeline"], run.traced) / t
