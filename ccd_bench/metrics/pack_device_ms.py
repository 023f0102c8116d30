"""``pack_device_ms``: device ms per call of kernel C (gather, tolerances,
error filter and pack into kernel B's columns, ``csrc/gather_pack.cu``).
Layer: gather and pack."""

KERNELS = (r"\bgather_pack_kernel\b",)


def read(run):
    if not run.device_events(KERNELS) or not run.calls:
        return None
    return 1000.0 * run.device_s(KERNELS) / run.calls
