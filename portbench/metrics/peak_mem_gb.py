"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over set-up
and window, in GB (1e9 bytes), read before the reference runs."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
