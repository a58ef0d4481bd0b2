"""Each match's Sinkhorn bound (costs read once, P written once, 8 float32
operations and 2 expf a cell and iteration; this rank's rows), over the
device time of the Sinkhorn kernels a match, in %."""


def read(ctx):
    sk = ctx.class_s["sinkhorn"]
    if ctx.least is None or not sk:
        return None
    return 100.0 * ctx.least["sinkhorn"] / sk
