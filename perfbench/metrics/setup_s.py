"""setup_s (s, lower; host clock; every cell): process start to the first
timed step or query: imports, the kernels' loading (built in the
checkout's first run), the granule, the dataset, the pipeline, the
parameters, the warm-up. Copies taken for the comparison are left out."""


def read(run):
    return run.setup_s
