"""``peak_mem_mib``: ``torch.cuda.max_memory_allocated()`` over the window,
reset at its start, in MiB: the card's memory the program takes from the
simulator that shares it."""


def read(run):
    return run.peak_window_bytes / 2**20 if run.peak_window_bytes else None
