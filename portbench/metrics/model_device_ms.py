"""Device ms a step of every kernel that ``kernels.py`` classes as neither
Sinkhorn, float32 GEMM nor NCCL: the models' bf16 convs and products, their
casts and layout copies, elementwise work, Adam and the EMA."""


def read(ctx):
    model = ctx.class_s["model"]
    return 1e3 * model / ctx.steps if model and ctx.steps else None
