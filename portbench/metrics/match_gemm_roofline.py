"""The matcher's float32 GEMM FLOPs a match (6 cost matrices, 12
matched-feature products; this rank's rows) at the float32 peak, over the
device time of the float32 GEMM kernels a match, in %."""


def read(ctx):
    gemm_s = ctx.class_s["gemm_f32"]
    if ctx.least is None or not gemm_s:
        return None
    return 100.0 * ctx.least["gemm"] / gemm_s
