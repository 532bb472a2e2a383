"""Process start to the end of the warm-up step (host clock): imports,
kernel builds where none is cached, the inputs, the warm-up."""


def read(ctx):
    return ctx.setup_s
