"""End-to-end 8-Gaussians MED-GAN convergence on the port (the slow twin of
tests/test_toy_e2e.py, with its schedule, calibration and thresholds): the
notebook's D-then-G iterations at batch 512, lam 50, 10 Sinkhorn
iterations, both learning rates scaled 3x, the critic frozen after
``OTGAN_TOY_E2E_FREEZE`` iterations; success is all 8 modes holding at
least 2% of 1000 samples, a falling matching entropy, and EMA samples in
the data's range. On the CPU (the engine's plain Sinkhorn); latents from
the state's generator, so the run is the port's own, not the JAX one's.
"""

import os

import numpy as np
import pytest
import torch

from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.data.toy import mode_coverage, sample_8gaussians
from otgan_tpu_torch.engine import Engine

N_STEPS = int(os.environ.get("OTGAN_TOY_E2E_STEPS", "1000"))
FREEZE_AT = int(os.environ.get("OTGAN_TOY_E2E_FREEZE", "600"))
MIN_MODES = 8


@pytest.mark.slow
def test_toy_medgan_covers_modes():
    cfg = TrainConfig(model="toy_mlp", batch_size=512, sinkhorn_lambda=50.0,
                      nr_sinkhorn_iter=10, learning_rate_gen=3e-4, learning_rate_disc=6e-5,
                      use_pallas=False)
    eng = Engine(cfg, "cpu")
    rng = np.random.default_rng(0)
    state, nf = eng.init_state(1, sample_8gaussians(rng, 512))
    assert nf == 16
    entropies = []
    for it in range(1, N_STEPS + 1):
        x = sample_8gaussians(rng, 512)
        # the notebook's schedule: D then G every iteration, D frozen after
        # FREEZE_AT (med_gan_toy_example2.ipynb cell 1)
        if it <= FREEZE_AT:
            state, _ = eng.disc_step(state, x)
        state, met = eng.gen_step(state, x)
        if it % 100 == 0:
            entropies.append(float(met.entropy))
    samples = eng.sample(state, eng.latents(1000, torch.Generator().manual_seed(99))).numpy()
    cov = mode_coverage(samples)
    assert cov >= MIN_MODES, f"only {cov}/8 modes covered after {N_STEPS} steps"
    assert entropies[-1] < entropies[0]
    ema = eng.sample(state, eng.latents(500, torch.Generator().manual_seed(98)), ema=True)
    assert np.abs(ema.numpy()).max() < 8.0
