"""peak_mem_mb (MB, lower; the CUDA allocator's peak read by the harness on
the host; every cell): ``torch.cuda.max_memory_allocated`` over set-up and
window, after ``reset_peak_memory_stats`` at the start, in 10^6 bytes."""


def read(run):
    return run.peak_bytes / 1e6 if run.peak_bytes else None
