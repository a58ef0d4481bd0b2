"""Device ms a step of engine.py's ``match`` phase (the matcher whole: cost
matrices, Sinkhorn kernels, matched features, the distance), counted on the
card by the program's own marks over the traced calls."""

from portbench.phases import per_step


def read(ctx):
    return per_step("match")
