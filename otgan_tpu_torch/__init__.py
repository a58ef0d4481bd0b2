"""PyTorch/CUDA port of otgan_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``nn/``, ``models/``, ``data/``,
``utils/``, ``config.py``, ``engine.py``, ``train.py``); ``convert.py``
carries weights between the two and ``csrc/`` holds the hand-written CUDA
kernels, built by ``kernels/build.py`` at first use. It imports neither JAX
nor ``otgan_tpu``.
"""
