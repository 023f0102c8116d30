"""``call_ms``: the window's seconds x 1000 over the calls completed in it,
one closed-loop caller (host clock); the mean time a simulator waits per
call."""


def read(run):
    return 1000.0 * run.window_s / len(run.call_s)
