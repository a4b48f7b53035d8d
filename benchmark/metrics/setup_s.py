"""``setup_s``: the host seconds from the process's start to the window's:
imports, the kernels' build (the first run in a checkout only), the
constructors, the seeded weights and batches, the checked updates and the
warm-up of every batch shape."""


def read(ctx):
    return ctx.setup_s
