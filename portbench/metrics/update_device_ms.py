"""Device ms a step of engine.py's ``update`` phase (Adam, and the EMA after a
generator step), counted on the card by the program's own marks over the
traced calls."""

from portbench.phases import per_step


def read(ctx):
    return per_step("update")
