"""Device ms a step of engine.py's ``loss_backward`` phase (the MED losses,
autograd through both nets, the gradient sum on K ranks), counted on the
card by the program's own marks over the traced calls."""

from portbench.phases import per_step


def read(ctx):
    return per_step("loss_backward")
