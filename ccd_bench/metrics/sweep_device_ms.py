"""``sweep_device_ms``: device ms per call of kernels A and A' (the
sort-and-sweep of both phases, ``csrc/sweep_ap.cu``,
``csrc/sweep_records.cu``).  Layer: sweep."""

#: kernel A's and kernel A''s launches, by function name
KERNELS = (r"\btile_units_kernel\b", r"\bunit_prefix_kernel\b", r"\bsweep_units_kernel\b",
           r"\brecord_units_kernel\b", r"\bsweep_records_kernel\b")


def read(run):
    if not run.device_events(KERNELS) or not run.calls:
        return None
    return 1000.0 * run.device_s(KERNELS) / run.calls
