"""grid_build_ms.extract (ms, lower; host clock; layer extraction; moves
extract_points_per_s): host milliseconds of ``get_extract_dataset``, the
mean over the window's extractions."""


def read(run):
    s = run.spans.get("grid_build_s")
    return 1e3 * sum(s) / len(s) if s else None
