"""``torch_device_ms``: device ms per call of PyTorch's own kernels, copies
and fills: every device event that is none of the port's kernels named
below.  Layer: PyTorch glue (box build, sort, candidate streams, escalation
bookkeeping)."""

#: the port's hand-written kernels (csrc/*.cu), by function name
PORT_KERNELS = (
    r"\btile_units_kernel\b", r"\bunit_prefix_kernel\b", r"\bsweep_units_kernel\b",
    r"\brecord_units_kernel\b", r"\bsweep_records_kernel\b",
    r"\bgather_pack_kernel\b",
    r"\bsolve_kernel\b", r"\bsolve_lane_kernel\b",
)


def read(run):
    if not run.trace.device or not run.calls:
        return None
    return 1000.0 * run.device_s(PORT_KERNELS, exclude=True) / run.calls
