"""8-Gaussians toy baselines: vanilla GAN, DAN-S, batch-energy DAN, MED-GAN
(counterpart of ``examples/toy_baselines.py``, after the reference's
``toy_example/med_gan_toy_example1.ipynb``): the MED-GAN covers all 8 modes
where the baselines collapse.

Run:  python -m otgan_tpu_torch.examples.toy_baselines --model med_gan --steps 6000
      [--device cpu]
Writes ``<model>_<step>.npy`` sample snapshots every 500 steps with a
``mode_coverage`` print, and ``<model>_kde.png`` at the end.

The objectives, MLP sizes, Xavier scale, Adam (0.5, 0.999), the critic's
ascent by a negative learning rate and the generator's 5x learning rate are
the JAX script's. JAX PRNG keys cannot be reproduced in torch, so the
initial weights and the latents come from ``torch.Generator``s seeded by
``--seed``; the data are the same numpy draws. ``med_gan`` matches 6 x
256^2 cost matrices at lam 50: the resident Sinkhorn kernel on the card.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from otgan_tpu_torch.data.toy import mode_coverage, sample_8gaussians
from otgan_tpu_torch.engine import resolve_device
from otgan_tpu_torch.nn.optim import AdamState, adam_init, adam_update
from otgan_tpu_torch.ops import (
    calc_distance,
    match_two_batch,
    med_discriminator_loss,
    med_generator_loss,
)
from otgan_tpu_torch.ops.costs import scaled_sqeuclidean_cost

Z_DIM = 256
GEN_SIZES = [Z_DIM, 128, 128, 128, 2]
DISC_SIZES = [2, 32, 32, 32, 16]
MODELS = ("med_gan", "gan", "dan_s", "dan_energy")
Mlp = List[Dict[str, torch.Tensor]]


def xavier(n: int) -> float:
    """The notebook's ``xavier_init``: std = 1 / sqrt(in / 2)."""
    return float(np.sqrt(2.0 / n))


def init_mlp(gen: torch.Generator, sizes, scale: Callable[[int], float], device) -> Mlp:
    """Layers ``{"w": (in, out), "b": (out,)}``, ``w`` normal times
    ``scale(in)``, ``b`` zero; trainable."""
    return [{"w": (scale(a) * torch.randn((a, b), generator=gen)).to(device).requires_grad_(),
             "b": torch.zeros((b,), device=device, requires_grad=True)}
            for a, b in zip(sizes, sizes[1:])]


def mlp(ps: Mlp, x: torch.Tensor) -> torch.Tensor:
    for i, p in enumerate(ps):
        x = x @ p["w"] + p["b"]
        if i < len(ps) - 1:
            x = torch.relu(x)
    return x


def flat(ps: Mlp) -> Dict[str, torch.Tensor]:
    """The layers' tensors keyed ``<layer>.<name>`` (the optimizer's view;
    the same tensors, so its in-place update moves the MLP)."""
    return {f"{i}.{k}": t for i, p in enumerate(ps) for k, t in p.items()}


def make_losses(model: str):
    """``(gen_loss, disc_loss, ascent)``: ``gen_loss(gp, dp, z, x) -> (loss,
    aux)``, ``disc_loss(dp, gp, z, x) -> loss``; ``ascent`` when the critic
    maximises its loss through a negative learning rate."""
    gen = lambda gp, z: mlp(gp, z)  # noqa: E731
    feat = lambda dp, x: mlp(dp, x / 4.0)  # noqa: E731  16-d features (med) / logits

    if model == "med_gan":
        def match(fg, fd):
            return match_two_batch(fg, fd, 50.0, 10, cost_fn=scaled_sqeuclidean_cost,
                                   use_pallas=True)

        def g_loss(gp, dp, z, x):
            fg, fd = feat(dp, gen(gp, z)), feat(dp, x)
            m = match(fg, fd)
            return med_generator_loss(fg, m), calc_distance(fg.detach(), fd.detach(), m)

        def d_loss(dp, gp, z, x):
            fg, fd = feat(dp, gen(gp, z)), feat(dp, x)
            return med_discriminator_loss(fg, fd, match(fg, fd))  # maximised via -lr

        return g_loss, d_loss, True

    def logit(dp, x):  # scalar critic head for the GAN baselines
        return mlp(dp, x / 4.0)[:, :1]

    if model == "gan":  # vanilla non-saturating GAN (notebook 1)
        def g_loss(gp, dp, z, x):
            lg = logit(dp, gen(gp, z))
            return -torch.mean(F.logsigmoid(lg)), torch.mean(lg)

        def d_loss(dp, gp, z, x):
            lg, lr_ = logit(dp, gen(gp, z)), logit(dp, x)
            return -(torch.mean(F.logsigmoid(lr_))
                     + torch.mean(torch.log1p(-torch.sigmoid(lg) + 1e-8)))

        return g_loss, d_loss, False

    if model == "dan_s":  # batch-mean "sample classifier" critic
        def g_loss(gp, dp, z, x):
            lg = torch.mean(logit(dp, gen(gp, z)))
            return -F.logsigmoid(lg), lg

        def d_loss(dp, gp, z, x):
            lg = torch.mean(logit(dp, gen(gp, z)))
            lr_ = torch.mean(logit(dp, x))
            return -(F.logsigmoid(lr_) + torch.log1p(-torch.sigmoid(lg) + 1e-8))

        return g_loss, d_loss, False

    if model == "dan_energy":  # batch-statistic energy: -(D01 + D10 - D00 - D11)
        def pair_energy(fa, fb):
            n = fa.shape[1]
            d = (0.5 * torch.mean(fa.square(), 1)[:, None]
                 + 0.5 * torch.mean(fb.square(), 1)[None, :] - fa @ fb.T / n)
            return torch.mean(d)

        def energy(dp, xg, x):
            fg, fd = feat(dp, xg), feat(dp, x)
            return 2 * pair_energy(fg, fd) - pair_energy(fg, fg) - pair_energy(fd, fd)

        def g_loss(gp, dp, z, x):
            e = energy(dp, gen(gp, z), x)
            return e, e

        def d_loss(dp, gp, z, x):
            return energy(dp, gen(gp, z), x)  # maximised via -lr

        return g_loss, d_loss, True

    raise ValueError(f"unknown toy model {model!r}")


def train_step(losses, gp: Mlp, dp: Mlp, gs: AdamState, ds: AdamState, z1, z2, x,
               lr: float) -> torch.Tensor:
    """One iteration of the JAX script's ``step``: a critic update on
    ``z1`` (ascent where the objective says so), then a generator update
    at ``5 lr`` on ``z2`` against the new critic. Returns the generator's
    aux value."""
    g_loss, d_loss, ascent = losses
    dflat, gflat = flat(dp), flat(gp)
    dg = torch.autograd.grad(d_loss(dp, gp, z1, x), list(dflat.values()))
    adam_update(dflat, dict(zip(dflat, dg)), ds, -lr if ascent else lr, mom1=0.5, mom2=0.999)
    loss, aux = g_loss(gp, dp, z2, x)
    gg = torch.autograd.grad(loss, list(gflat.values()))
    adam_update(gflat, dict(zip(gflat, gg)), gs, 5 * lr, mom1=0.5, mom2=0.999)
    return aux.detach()


def main(argv=None) -> Tuple[Mlp, Mlp]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="med_gan", choices=list(MODELS))
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--save_dir", default="/tmp/otgan_toy_baselines")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no silent fallback")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    losses = make_losses(args.model)
    gp = init_mlp(torch.Generator().manual_seed(args.seed), GEN_SIZES, xavier, device)
    dp = init_mlp(torch.Generator().manual_seed(args.seed + 1), DISC_SIZES, xavier, device)
    gs, ds = adam_init(flat(gp)), adam_init(flat(dp))
    zgen = torch.Generator(device=device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    snapshots = []
    for it in range(1, args.steps + 1):
        z1 = torch.randn((args.batch_size, Z_DIM), generator=zgen, device=device)
        z2 = torch.randn((args.batch_size, Z_DIM), generator=zgen, device=device)
        x = torch.from_numpy(sample_8gaussians(rng, args.batch_size)).to(device)
        aux = train_step(losses, gp, dp, gs, ds, z1, z2, x, args.lr)
        if it % 500 == 0:
            zs = torch.Generator(device=device).manual_seed(999999 + it)
            with torch.no_grad():
                s = mlp(gp, torch.randn((1000, Z_DIM), generator=zs, device=device))
            s = s.cpu().numpy()
            np.save(os.path.join(args.save_dir, f"{args.model}_{it}.npy"), s)
            snapshots.append((it, s))
            print(f"[{args.model}] step {it}: modes={mode_coverage(s)}/8 aux={float(aux):.4f}",
                  flush=True)
    if snapshots:
        # the notebooks' final artifact (med_gan_toy_example2.ipynb cell 2)
        from otgan_tpu_torch.utils.plotting import kde_evolution_plot

        kde_evolution_plot(snapshots, os.path.join(args.save_dir, f"{args.model}_kde.png"))
    return gp, dp


if __name__ == "__main__":
    main()
