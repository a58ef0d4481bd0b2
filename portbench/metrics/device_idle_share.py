"""Share of the traced stretch's wall time in which rank 0's card runs no
kernel, memcpy or memset, in %."""


def read(ctx):
    if not ctx.window_s or not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
