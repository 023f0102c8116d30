"""``solver_device_ms``: device ms per call of kernel B, both forms (the
shared form of the unbounded passes and the one-thread form of the
round-limited ones, ``csrc/solver.cu``).  Layer: solver."""

KERNELS = (r"\bsolve_kernel\b", r"\bsolve_lane_kernel\b")


def read(run):
    if not run.device_events(KERNELS) or not run.calls:
        return None
    return 1000.0 * run.device_s(KERNELS) / run.calls
