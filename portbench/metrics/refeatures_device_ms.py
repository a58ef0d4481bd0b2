"""Device ms a step of engine.py's ``refeatures`` slot under ``--grad_accum``:
each microbatch's forward again, under autograd, inside the ``loss_backward``
phase (so a part of ``backward_device_ms``), counted on the card by the
program's own marks over the traced calls. None where the program's tally
has no such slot."""

from portbench.phases import per_step


def read(ctx):
    try:
        return per_step("refeatures")
    except KeyError:  # a program whose marks have no refeatures slot
        return None
