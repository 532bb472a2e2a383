"""The most device memory the program held during the window, from
``torch.cuda.max_memory_allocated`` reset at the window's start."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
