"""``torch.cuda.max_memory_allocated()`` over the port's build, the
warm-up and the window, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
