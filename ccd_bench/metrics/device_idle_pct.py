"""``device_idle_pct``: 100 x (1 - the device's busy time per call over the
call's untraced time), the share of a call in which the card runs nothing.
The busy time is the union of the device events of a pass that traces the
device alone; the time is the host clock's over the same cycles run just
before it untraced, since tracing stretches the host's side of a call.
Layer: device."""


def read(run):
    if not run.trace.device or not run.untraced_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.untraced_s)
