"""extract_points_per_s (points/s, higher; host clock; extraction cells):
every point of every whole extraction in the window (grid built on the
host, the query, sigma back on the host) over the window's seconds."""


def read(run):
    return run.work["points"] / run.window_s
