"""table_prep_ms.extract21 (ms, lower; device trace; layer kernels; moves
extract_points_per_s): device milliseconds an extraction of the position
table's bf16 preparation, the kernel ``round_bf16_kernel`` (K1p's bf16
instance, ``csrc/quantize.cu``), which no other kernel of the query is
named like. None where the trace has no such kernel."""

from perfbench.work_table import PREP_KERNEL


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    t = run.trace.kernel_seconds(PREP_KERNEL)
    return 1e3 * t / run.traced["extractions"] if t else None
