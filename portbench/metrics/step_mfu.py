"""The traced steps' least time over their wall time, in %. The least time
adds the bf16 model FLOPs at the tensor cores' peak, the matcher's float32
GEMM FLOPs at the float32 peak, and each match's Sinkhorn bound, all
counted from shapes (``counts.py``); on K ranks, one rank's share."""


def read(ctx):
    if ctx.least is None or not ctx.wall_s:
        return None
    return 100.0 * (ctx.least["model"] + ctx.least["gemm"] + ctx.least["sinkhorn"]) / ctx.wall_s
