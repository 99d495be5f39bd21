"""table_prep_roofline.extract21 (%, higher; device trace; layer kernels;
moves extract_points_per_s): the least time of the profiled extractions'
table preparations (one a batch, each the 169.1 MB float32 master table
read once over 3.35 TB/s; ``perfbench/work_table.py``) over the device time
of ``round_bf16_kernel``. The 84.6 MB bfloat16 write is not counted: up to
50 MB of it can still sit in the L2 when the kernel ends, and the share
must not pass 100%. None where the trace has no such kernel."""

from perfbench.work_table import PREP_KERNEL, prep_least_seconds, preparations


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    t = run.trace.kernel_seconds(PREP_KERNEL)
    if not t:
        return None
    return 100.0 * preparations(run.traced) * prep_least_seconds(run.config["pipeline"]) / t
