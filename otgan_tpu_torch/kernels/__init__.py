"""Builds the CUDA sources in ``csrc/`` (see ``build.py``)."""
