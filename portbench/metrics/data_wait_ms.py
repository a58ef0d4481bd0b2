"""Host ms a call of the loop waits for its placed batches: the harness's
``data_wait`` span around the prefetch's hand-over, over the traced calls.
Layer: the harness's loop (a copy of ``train.py``'s, so a change to the
trainer's own loop does not show here) and ``data/`` (loader, native
assembler, prefetch, which are the trainer's own functions)."""


def read(ctx):
    return 1e3 * ctx.data_wait_s / ctx.calls if ctx.calls else None
