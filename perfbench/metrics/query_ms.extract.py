"""query_ms.extract (ms, lower; host clock; layer extraction; moves
extract_points_per_s): host milliseconds of ``run_extraction``, ending with
sigma on the host, the mean over the window's extractions."""


def read(run):
    s = run.spans.get("query_s")
    return 1e3 * sum(s) / len(s) if s else None
