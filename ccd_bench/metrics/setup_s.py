"""``setup_s``: seconds from the harness's first line to the first timed
call: imports, the frames, the kernels' build or load, one warm cycle."""


def read(run):
    return run.setup_s
