"""Device ms a step of a whole step of engine.py, from its first mark to its
last (its four phases, the latent draw and the ``--debug_nans`` checks),
counted on the card by the program's own marks over the traced calls."""

from portbench.phases import per_step


def read(ctx):
    return per_step("step")
