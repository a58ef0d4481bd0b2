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
  0``. Each step draws its latents at the global batch from a CUDA
  generator seeded ``seed + 1``.
* Under ``grad_accum`` > 1, a step's gradient in the port's microbatches
  (``Engine._microbatches``): each data rank's contiguous rows in
  ``grad_accum`` blocks, rank by rank, so that a model that fits the card
  only in microbatches fits here as it does in the port. The features of
  the whole batch, the match, the distance and the entropy come first,
  without grad; then each block computes its features again with grad
  and back-propagates ``sum f_block * cotangent_block``, the cotangents
  those the whole batch's loss injects; the blocks' gradients are summed.
  The match being constant, the loss is a sum over rows, so the gradient
  differs from the whole batch's by the order of its sums and, where a
  layer's weight gradient comes in the compute dtype (bf16), by its
  rounding once a block. Under ``grad_accum`` 1 each step runs over the
  whole batch at once.

The model is the configuration's family (its ``model``), a module of the
plain reference, ``portbench/reference/<model>.py``, that
``spec.load_family`` finds and the :class:`Trainer` is handed. It
provides:

* ``draw(seed) -> (disc, gen, cpu_rng)``: both nets' parameters (dicts of
  CPU tensors in the port's order of ``named_parameters``) drawn from a CPU
  generator seeded ``seed``, which is returned for the init's latents;
* ``images(x_uint8, compute)``: a uint8 NHWC batch as the critic's input;
* ``critic(params, x, compute, init=False)``: images to unit features (B,
  d), row by row; ``init`` runs the data-dependent init in place;
* ``generator(params, z, compute, init=False)``: latents to NHWC images;
* ``init_latent(n, cpu_rng)``: the data-dependent init's latents, on the
  CPU;
* ``latent(batch, generator, device)``: one step's latents, drawn on
  ``generator``.

A latent is a tensor, or a tuple of tensors, whose first axis is the batch.

:func:`follow` runs the first steps from the seed, :func:`resume` the
steps of a later call from a state at its step, and each returns what the
check compares. Nothing here imports the measured program.
"""

from __future__ import annotations

from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
Latent = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


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


def microbatches(batch: int, chips: int, accum: int) -> List[slice]:
    """The port's ``--grad_accum`` microbatches as rows of the global batch:
    each of ``chips`` data ranks' contiguous ``batch / chips`` rows cut at
    ``n * i // accum`` (``Engine._microbatches``), rank by rank."""
    n = batch // chips
    return [slice(k * n + n * i // accum, k * n + n * (i + 1) // accum)
            for k in range(chips) for i in range(accum)]


def latent_rows(z: Latent, rows: slice) -> Latent:
    """Rows ``rows`` of a latent (a tensor, or a tuple of tensors)."""
    return tuple(t[rows] for t in z) if isinstance(z, tuple) else z[rows]


def latent_to(z: Latent, device: torch.device) -> Latent:
    return tuple(t.to(device) for t in z) if isinstance(z, tuple) else z.to(device)


class Trainer:
    """The reference's state: both nets of ``family``, their Adam states,
    the EMA. ``ranks``: those whose own rows the two-batch halves come from
    (:func:`halves_order`); ``chips``: the data ranks whose rows the port's
    microbatches cut (:func:`microbatches`)."""

    def __init__(self, cfg: dict, family: ModuleType, seed: int, device: torch.device,
                 ranks: int = 1, chips: int = 1):
        self.cfg, self.family, self.device, self.ranks = cfg, family, device, ranks
        self.compute = getattr(torch, cfg["compute_dtype"])
        accum = cfg["grad_accum"]
        self.blocks = None if accum == 1 else microbatches(cfg["batch_size"], chips, accum)
        self.rng = torch.Generator(device=device).manual_seed(seed + 1)
        self.order = halves_order(cfg["batch_size"], ranks)
        self.step = 0

    def init(self, seed: int, x_init: torch.Tensor) -> None:
        """V from the seed, then the data-dependent init on ``x_init``."""
        cfg, device, fam = self.cfg, self.device, self.family
        disc, gen, cpu_rng = fam.draw(seed)
        self.disc = {k: t.to(device) for k, t in disc.items()}
        self.gen = {k: t.to(device) for k, t in gen.items()}
        fam.critic(self.disc, fam.images(x_init.to(device), self.compute), self.compute,
                   init=True)
        z = fam.init_latent(x_init.shape[0], cpu_rng)
        fam.generator(self.gen, latent_to(z, device), self.compute, init=True)
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

    def latents(self) -> Latent:
        """One step's latents at the global batch."""
        return self.family.latent(self.cfg["batch_size"], self.rng, self.device)

    def _match(self, fa, fb):
        if self.order is not None:
            order = self.order.to(fa.device)
            fa, fb = fa[order], fb[order]
        m = match(fa, fb, self.cfg["sinkhorn_lambda"], self.cfg["nr_sinkhorn_iter"])
        return fa, fb, m

    def _in_rows(self, cot: torch.Tensor) -> torch.Tensor:
        """A cotangent of the matched (reordered) rows, in batch row order."""
        if self.order is None:
            return cot
        out = torch.empty_like(cot)
        out[self.order.to(cot.device)] = cot
        return out

    def _block_grads(self, params: List[torch.Tensor],
                     loss: Callable[[slice], torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The gradient of ``sum_blocks loss(block)`` over the blocks, one
        block's graph at a time."""
        total = None
        for rows in self.blocks:
            grads = torch.autograd.grad(loss(rows), params)
            total = list(grads) if total is None else [t.add_(g) for t, g in zip(total, grads)]
        return tuple(total)

    def train_step(self, x_uint8: torch.Tensor) -> dict:
        """One step on a uint8 NHWC batch: ``{"disc", "dist", "entropy",
        "grads"}`` (the gradient the optimizer got, by leaf)."""
        cfg, cd, fam = self.cfg, self.compute, self.family
        is_disc = self.step % (cfg["nr_gen_per_disc"] + 1) == 0
        blocks = self.blocks is not None
        z = self.latents()
        x = fam.images(x_uint8.to(self.device), cd)
        if is_disc:
            params = [p.requires_grad_(True) for p in self.disc.values()]
            with torch.no_grad():
                fake = fam.generator(self.gen, z, cd)
            with torch.set_grad_enabled(not blocks):
                f_fake = fam.critic(self.disc, fake, cd)
                f_dat = fam.critic(self.disc, x, cd)
            fa, fb, (a_a, b_b, a_b, b_a, ent) = self._match(f_fake, f_dat)
            dist = distance(fa.detach(), fb.detach(), a_a, b_b, a_b)
            scale = distance_scale(fa, fb, a_a, b_b, a_b)
            if blocks:
                c_fake, c_dat = self._in_rows(a_a - a_b), self._in_rows(b_b - b_a)
                grads = self._block_grads(params, lambda r: (
                    torch.sum(fam.critic(self.disc, x[r], cd) * c_dat[r])
                    + torch.sum(fam.critic(self.disc, fake[r], cd) * c_fake[r])))
            else:
                loss = torch.sum(fb * (b_b - b_a)) + torch.sum(fa * (a_a - a_b))
                grads = torch.autograd.grad(loss, params)
            for p in params:
                p.requires_grad_(False)
            grads = dict(zip(self.disc, grads))
            self.disc_opt.step(self.disc, grads, -cfg["learning_rate_disc"])
        else:
            params = [p.requires_grad_(True) for p in self.gen.values()]
            with torch.no_grad():
                f_dat = fam.critic(self.disc, x, cd)
            with torch.set_grad_enabled(not blocks):
                f_gen = fam.critic(self.disc, fam.generator(self.gen, z, cd), cd)
            fa, fb, (a_a, b_b, a_b, b_a, ent) = self._match(f_gen, f_dat)
            dist = distance(fa.detach(), fb, a_a, b_b, a_b)
            scale = distance_scale(fa, fb, a_a, b_b, a_b)
            if blocks:
                c_gen = self._in_rows(a_a - a_b)
                grads = self._block_grads(params, lambda r: torch.sum(fam.critic(
                    self.disc, fam.generator(self.gen, latent_rows(z, r), cd), cd) * c_gen[r]))
            else:
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


def follow(cfg: dict, family: ModuleType, seed: int, x_init: torch.Tensor,
           batches: Sequence[torch.Tensor], device: torch.device, ranks: int = 1,
           chips: int = 1) -> dict:
    """The reference's reading (:func:`_steps`) of the first steps of
    ``family``, on ``batches``, from the seed and the init batch
    ``x_init``."""
    _plain_precision()
    tr = Trainer(cfg, family, seed, device, ranks, chips)
    tr.init(seed, x_init)
    return _steps(tr, batches)


def resume(cfg: dict, family: ModuleType, seed: int, state: dict,
           batches: Sequence[torch.Tensor], device: torch.device, ranks: int = 1,
           chips: int = 1) -> dict:
    """The reference's reading (:func:`_steps`) of ``family``'s steps on
    ``batches`` from ``state`` at its step (:meth:`Trainer.load`), the
    latents drawn from the seed."""
    _plain_precision()
    tr = Trainer(cfg, family, seed, device, ranks, chips)
    tr.load(state)
    return _steps(tr, batches)
