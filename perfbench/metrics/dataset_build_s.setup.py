"""dataset_build_s.setup (s, lower; host clock; layer data; moves setup_s):
the program's ``HARP2Dataset`` build of the cell's granule: the ray build,
the filter and the normalization."""


def read(run):
    spans = run.spans.get("dataset_build_s")
    return spans[0] if spans else None
