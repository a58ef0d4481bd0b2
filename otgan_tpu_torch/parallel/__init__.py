"""Data-parallel training over several GPUs: process groups, and the
row-sharded and matrix-parallel matchers."""
