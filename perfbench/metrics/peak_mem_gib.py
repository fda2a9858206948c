"""``torch.cuda.max_memory_allocated`` over set-up and window, read
before the reference runs, in GiB."""


def read(rec):
    if rec.memory_peak_bytes is None:
        return None
    return rec.memory_peak_bytes / 2**30
