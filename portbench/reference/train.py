"""One cycle of OT-GAN training in plain PyTorch (openai/ot-gan ``train.py``
and ``utils/matching.py``, arXiv:1803.05573), from the seed and the
batches alone.

* Matching: 6 cosine-cost matrices ``1 - f f'^T`` of the two batch halves
  (a1a2, b2b1, a1b1, a1b2, a2b1, a2b2), log-domain Sinkhorn at ``lam`` for
  ``iters`` iterations carrying only the potentials, the column update
  REPLACING v (``v <- -colLSE(x + u)``), the row softmax as the assignment
  and its mean row entropy, then 12 matched-feature products. float32 with
  TF32 off. On K ranks each rank splits its own rows into the two halves,
  so the halves are the ranks' first and second halves, in rank order
  (``halves_order``).
* Losses with the reference's injected cotangents: generator ``sum f_gen
  sg(f_aa - f_ab)``; critic ``sum f_data sg(f_bb - f_ba) + sum f_fake
  sg(f_aa - f_ab)`` (the cross term with weight 1). Gradients are sums.
* Adam as ``utils/nn.py:50-73``: eps inside the sqrt, one step count from
  1, mom1 0.5, mom2 0.999; the critic ascends through ``-lr``. EMA 0.999 of
  the generator after each of its steps.
* The 5:1 (or n:1) schedule: step s is a critic step when ``s % (n + 1) ==
  0``. Each step draws ``U(-1, 1)^100`` latents at the global batch from a
  CUDA generator seeded ``seed + 1``.

:func:`follow` runs the first steps from the seed, :func:`resume` the
steps of a later call from a state at its step, and each returns what the
check compares. Nothing here imports the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference import dcgan

Params = Dict[str, torch.Tensor]


def cosine_cost(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.matmul(fa, fb.T)


def lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = torch.amax(x, dim=dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))


def sinkhorn(cost: torch.Tensor, lam: float, iters: int):
    """(b, N, M) costs -> (assignment, mean row entropy of each matrix)."""
    x = -lam * cost
    u = x.new_zeros(x.shape[:-1])
    v = x.new_zeros(x.shape[:-2] + x.shape[-1:])
    for _ in range(iters):
        u = -lse(x + v.unsqueeze(-2), -1)
        v = -lse(x + u.unsqueeze(-1), -2)
    log_a = x + u.unsqueeze(-1) + v.unsqueeze(-2)
    del x
    p = torch.softmax(log_a, dim=-1)
    ent = -torch.sum(p * torch.log_softmax(log_a, dim=-1), dim=-1)
    return p, torch.mean(ent, dim=-1)


def halves_order(batch: int, ranks: int) -> Optional[torch.Tensor]:
    """Row order that puts the two-batch halves of ``ranks`` data-parallel
    ranks (each splitting its own contiguous rows) at ``[:B/2]`` and
    ``[B/2:]``; None for one rank."""
    if ranks == 1:
        return None
    loc = batch // ranks
    first = [k * loc + i for k in range(ranks) for i in range(loc // 2)]
    second = [k * loc + loc // 2 + i for k in range(ranks) for i in range(loc // 2)]
    return torch.tensor(first + second)


@torch.no_grad()
def match(fa: torch.Tensor, fb: torch.Tensor, lam: float, iters: int):
    """Two-batch matching: ``(a_a, b_b, a_b, b_a, entropy)``."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        n = fa.shape[0] // 2
        fa, fb = fa.detach().float(), fb.detach().float()
        fa1, fa2, fb1, fb2 = fa[:n], fa[n:], fb[:n], fb[n:]
        costs = torch.stack([cosine_cost(fa1, fa2), cosine_cost(fb2, fb1), cosine_cost(fa1, fb1),
                             cosine_cost(fa1, fb2), cosine_cost(fa2, fb1), cosine_cost(fa2, fb2)])
        p, ent = sinkhorn(costs, lam, iters)
        del costs
        p11, p21, pab11, pab12, pab21, pab22 = p
        mm = torch.matmul
        a_a = torch.cat([mm(p11, fa2), mm(p11.T, fa1)])
        b_b = torch.cat([mm(p21.T, fb2), mm(p21, fb1)])
        a_b = 0.5 * torch.cat([mm(pab11, fb1) + mm(pab12, fb2), mm(pab21, fb1) + mm(pab22, fb2)])
        b_a = 0.5 * torch.cat([mm(pab11.T, fa1) + mm(pab21.T, fa2),
                               mm(pab12.T, fa1) + mm(pab22.T, fa2)])
        return a_a, b_b, a_b, b_a, torch.mean(ent)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def distance(fa, fb, a_a, b_b, a_b) -> torch.Tensor:
    return (torch.sum(fb * b_b) + torch.sum(fa * a_a) - 2.0 * torch.sum(fa * a_b)) / (
        2.0 * fa.shape[0])


@torch.no_grad()
def distance_scale(fa, fb, a_a, b_b, a_b) -> float:
    """The size of the terms that :func:`distance` takes the difference of:
    a distance far under it is their cancellation, and its relative
    rounding grows by their ratio."""
    terms = (torch.sum(fb * b_b), torch.sum(fa * a_a), 2.0 * torch.sum(fa * a_b))
    return float(sum(torch.abs(t) for t in terms) / (2.0 * fa.shape[0]))


class Adam:
    """``utils/nn.py:50-73``, the step count a float32 tensor from 1."""

    def __init__(self, params: Params, mom1: float, mom2: float):
        dev = next(iter(params.values())).device
        self.t = torch.tensor(1.0, device=dev)
        self.mom1, self.mom2 = mom1, mom2
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.mg = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, lr: float) -> None:
        one_m1 = 1.0 - torch.pow(self.mom1, self.t)
        one_m2 = 1.0 - torch.pow(self.mom2, self.t)
        for k, p in params.items():
            g, v, mg = grads[k], self.v[k], self.mg[k]
            v.mul_(self.mom1).add_((1.0 - self.mom1) * g)
            mg.mul_(self.mom2).add_((1.0 - self.mom2) * g.square())
            p.sub_(lr * (v / one_m1) / torch.sqrt(mg / one_m2 + 1e-8))
        self.t.add_(1.0)


class Trainer:
    """The reference's state: both nets, their Adam states, the EMA."""

    def __init__(self, cfg: dict, seed: int, device: torch.device, ranks: int = 1):
        self.cfg, self.device, self.ranks = cfg, device, ranks
        self.compute = getattr(torch, cfg["compute_dtype"])
        self.rng = torch.Generator(device=device).manual_seed(seed + 1)
        self.order = halves_order(cfg["batch_size"], ranks)
        self.step = 0

    def init(self, seed: int, x_init: torch.Tensor) -> None:
        """V from the seed, then the data-dependent init on ``x_init``."""
        cfg, device = self.cfg, self.device
        disc, gen, cpu_rng = dcgan.draw(seed)
        self.disc = {k: t.to(device) for k, t in disc.items()}
        self.gen = {k: t.to(device) for k, t in gen.items()}
        dcgan.critic(self.disc, dcgan.images(x_init.to(device), self.compute), self.compute,
                     init=True)
        z = torch.rand((x_init.shape[0], dcgan.LATENT), generator=cpu_rng) * 2.0 - 1.0
        dcgan.generator(self.gen, z.to(device), self.compute, init=True)
        self.ema = {k: t.clone() for k, t in self.gen.items()}
        self.gen_opt = Adam(self.gen, cfg["adam_mom1"], cfg["adam_mom2"])
        self.disc_opt = Adam(self.disc, cfg["adam_mom1"], cfg["adam_mom2"])

    def load(self, state: dict) -> None:
        """Starts at step ``state["step"]`` from a state in
        :func:`snapshot`'s layout (``disc``, ``gen``, ``ema``, and
        ``disc_opt`` / ``gen_opt`` with ``t``, ``v``, ``mg``); the latent
        generator skips the draws of the steps before."""
        cfg, device = self.cfg, self.device
        for net in ("disc", "gen", "ema"):
            setattr(self, net, {k: t.to(device).clone() for k, t in state[net].items()})
        for name, params in (("disc_opt", self.disc), ("gen_opt", self.gen)):
            opt = Adam(params, cfg["adam_mom1"], cfg["adam_mom2"])
            opt.t.fill_(state[name]["t"])
            for k in params:
                opt.v[k].copy_(state[name]["v"][k])
                opt.mg[k].copy_(state[name]["mg"][k])
            setattr(self, name, opt)
        for _ in range(state["step"]):
            self.latents()
        self.step = state["step"]

    def latents(self) -> torch.Tensor:
        """One step's ``U(-1, 1)^100`` latents at the global batch."""
        return torch.rand((self.cfg["batch_size"], dcgan.LATENT), generator=self.rng,
                          device=self.device) * 2.0 - 1.0

    def _match(self, fa, fb):
        if self.order is not None:
            order = self.order.to(fa.device)
            fa, fb = fa[order], fb[order]
        m = match(fa, fb, self.cfg["sinkhorn_lambda"], self.cfg["nr_sinkhorn_iter"])
        return fa, fb, m

    def train_step(self, x_uint8: torch.Tensor) -> dict:
        """One step on a uint8 NHWC batch: ``{"disc", "dist", "entropy",
        "grads"}`` (the gradient the optimizer got, by leaf)."""
        cfg, cd = self.cfg, self.compute
        is_disc = self.step % (cfg["nr_gen_per_disc"] + 1) == 0
        z = self.latents()
        x = dcgan.images(x_uint8.to(self.device), cd)
        if is_disc:
            params = [p.requires_grad_(True) for p in self.disc.values()]
            with torch.no_grad():
                fake = dcgan.generator(self.gen, z, cd)
            f_fake = dcgan.critic(self.disc, fake, cd)
            f_dat = dcgan.critic(self.disc, x, cd)
            fa, fb, (a_a, b_b, a_b, b_a, ent) = self._match(f_fake, f_dat)
            dist = distance(fa.detach(), fb.detach(), a_a, b_b, a_b)
            scale = distance_scale(fa, fb, a_a, b_b, a_b)
            loss = torch.sum(fb * (b_b - b_a)) + torch.sum(fa * (a_a - a_b))
            grads = torch.autograd.grad(loss, params)
            for p in params:
                p.requires_grad_(False)
            grads = dict(zip(self.disc, grads))
            self.disc_opt.step(self.disc, grads, -cfg["learning_rate_disc"])
        else:
            params = [p.requires_grad_(True) for p in self.gen.values()]
            with torch.no_grad():
                f_dat = dcgan.critic(self.disc, x, cd)
            f_gen = dcgan.critic(self.disc, dcgan.generator(self.gen, z, cd), cd)
            fa, fb, (a_a, b_b, a_b, b_a, ent) = self._match(f_gen, f_dat)
            dist = distance(fa.detach(), fb, a_a, b_b, a_b)
            scale = distance_scale(fa, fb, a_a, b_b, a_b)
            loss = torch.sum(fa * (a_a - a_b))
            grads = torch.autograd.grad(loss, params)
            for p in params:
                p.requires_grad_(False)
            grads = dict(zip(self.gen, grads))
            self.gen_opt.step(self.gen, grads, cfg["learning_rate_gen"])
            with torch.no_grad():
                decay = cfg["ema_decay"]
                for k, e in self.ema.items():
                    e.copy_(decay * e + (1.0 - decay) * self.gen[k])
        self.step += 1
        return {"disc": is_disc, "dist": float(dist), "dist_scale": scale, "entropy": float(ent),
                "grads": {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}}


def snapshot(params: Params) -> Params:
    return {k: p.detach().float().cpu().clone() for k, p in params.items()}


def change_norms(before: Params, after: Params) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(after[k].detach().float().cpu() - before[k]))
            for k in before}


def _steps(tr: Trainer, batches: Sequence[torch.Tensor]) -> dict:
    """``tr``'s steps on ``batches``: each step's dist (with the size of
    the terms it is the difference of) and entropy, the first gradient of each kind of step by leaf norm, and the leaf norms of
    each net's and the EMA's change over the steps."""
    start = {"disc": snapshot(tr.disc), "gen": snapshot(tr.gen), "ema": snapshot(tr.ema)}
    steps: List[dict] = []
    first_grads: Dict[str, Dict[str, float]] = {}
    for x in batches:
        rec = tr.train_step(x)
        first_grads.setdefault("disc" if rec["disc"] else "gen", rec.pop("grads"))
        rec.pop("grads", None)
        steps.append(rec)
    return {
        "dist": [s["dist"] for s in steps],
        "dist_scale": [s["dist_scale"] for s in steps],
        "entropy": [s["entropy"] for s in steps],
        "first_grad": first_grads,
        "change": {net: change_norms(start[net], getattr(tr, net))
                   for net in ("disc", "gen", "ema")},
    }


def _plain_precision() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def follow(cfg: dict, seed: int, x_init: torch.Tensor, batches: Sequence[torch.Tensor],
           device: torch.device, ranks: int = 1) -> dict:
    """The reference's reading (:func:`_steps`) of the first steps, on
    ``batches``, from the seed and the init batch ``x_init``."""
    _plain_precision()
    tr = Trainer(cfg, seed, device, ranks)
    tr.init(seed, x_init)
    return _steps(tr, batches)


def resume(cfg: dict, seed: int, state: dict, batches: Sequence[torch.Tensor],
           device: torch.device, ranks: int = 1) -> dict:
    """The reference's reading (:func:`_steps`) of the steps on ``batches``
    from ``state`` at its step (:meth:`Trainer.load`), the latents drawn
    from the seed."""
    _plain_precision()
    tr = Trainer(cfg, seed, device, ranks)
    tr.load(state)
    return _steps(tr, batches)
