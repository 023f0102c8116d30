"""``host_syncs_per_call``: synchronizing CUDA calls per call (the warnings
of ``torch.cuda.set_sync_debug_mode("warn")``), over whole cycles; the
caller's own two reads (TOI and overflow flag) included.  Layer: API and
host syncs."""


def read(run):
    if run.syncs is None or not run.sync_calls:
        return None
    return run.syncs / run.sync_calls
