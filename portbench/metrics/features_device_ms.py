"""Device ms a step of engine.py's ``features`` phase (the batch's ingest cast,
the generator and critic forwards), counted on the card by the program's own
marks over the traced calls."""

from portbench.phases import per_step


def read(ctx):
    return per_step("features")
