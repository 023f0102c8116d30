"""``torch_ops_per_call``: device events per call of PyTorch's own kernels,
copies and fills (every event that is none of the port's kernels named
below); each is one enqueue the host makes.  Layer: PyTorch glue."""

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
    return len(run.device_events(PORT_KERNELS, exclude=True)) / run.calls
