"""The benchmark's plain reference of the DenseNet
(``portbench/reference/densenet.py``) against the port on the CPU, at a tiny
size (L = 2, F = 4, batch 8) and at the source's widths where only shapes
are read.

The reference follows openai/ot-gan's ``models/densenet.py`` in plain
PyTorch and rounds to the compute dtype where the port rounds, so on the
same weights and inputs its init, features and images are the port's bit
for bit, in bfloat16 and float32. Its training steps
(``reference/train.py``'s ``follow`` and ``resume``) are held against the
port's ``Engine`` through one critic step and one generator step from the
seed, and one generator step from the program's state, whole batch and in
the port's microbatches. The configuration's conv table, which the
benchmark's MFU counts, is derived here from the port's own layers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.models import densenet as port
from otgan_tpu_torch.nn.layers import Conv2d, Dense, data_init, reset_parameters
from portbench import check, harness, spec
from portbench.reference import densenet, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs", "densenet_train_py.json")
L, F, BATCH = 2, 4, 8
SEED = 7
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def uint8_batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (BATCH, 32, 32, 3), np.uint8))
            for _ in range(n)]


def test_reference_imports_neither_jax_nor_the_port():
    """The family as the harness loads it (by path), and the training
    reference it is handed to: no ``jax``, ``jaxlib``, ``flax``,
    ``otgan_tpu`` or ``otgan_tpu_torch`` module is loaded."""
    probe = ("import json, sys\n"
             "from portbench import spec\n"
             "from portbench.reference import train\n"
             "fam = spec.load_family('.', 'densenet')\n"
             "assert callable(fam.critic) and callable(train.follow)\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "otgan_tpu", "otgan_tpu_torch"}


def port_models(x_init, compute):
    """The port's nets from ``SEED`` with their data-dependent init, as
    ``Engine.init_state`` draws and inits them."""
    rng = torch.Generator().manual_seed(SEED)
    gen = port.make_generator(L, F, compute_dtype=compute)
    disc = port.make_discriminator(L, F, compute_dtype=compute)
    reset_parameters(disc, rng)
    reset_parameters(gen, rng)
    data_init(disc, (x_init.float() / 127.5 - 1.0).to(compute))
    data_init(gen, port.sample_latent(x_init.shape[0], rng, filters_per_layer=F))
    return gen, disc


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_init_features_and_images_equal_the_port(dtype):
    """The same parameter names in the same order, the same data-dependent
    init, and on those weights the same features and images, bit for bit:
    the same operations in the same order, each rounding where the port's."""
    compute = DTYPES[dtype]
    fam = densenet.Family(L, F)
    x = uint8_batches(1, seed=1)[0]
    gen, disc = port_models(x, compute)
    d, g, rng = fam.draw(SEED)
    fam.critic(d, fam.images(x, compute), compute, init=True)
    fam.generator(g, fam.init_latent(BATCH, rng), compute, init=True)
    for mine, net in ((d, disc), (g, gen)):
        assert list(mine) == [k for k, _ in net.named_parameters()]
        for k, p in net.named_parameters():
            torch.testing.assert_close(mine[k], p.detach(), rtol=0, atol=0, msg=k)
    z = port.sample_latent(BATCH, torch.Generator().manual_seed(1), filters_per_layer=F)
    with torch.no_grad():
        torch.testing.assert_close(fam.generator(g, z, compute), gen(z), rtol=0, atol=0)
        torch.testing.assert_close(fam.critic(d, fam.images(x, compute), compute),
                                   disc((x.float() / 127.5 - 1.0).to(compute)), rtol=0, atol=0)


def test_latent_draws_what_the_engine_draws():
    """A step's four noises from one generator state, in ``sample_latent``'s
    order and shapes."""
    mine = densenet.Family(L, F).latent(BATCH, torch.Generator().manual_seed(3), "cpu")
    ports = port.sample_latent(BATCH, torch.Generator().manual_seed(3), "cpu",
                               filters_per_layer=F)
    assert len(mine) == 4
    for a, b in zip(mine, ports):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forwards_without_grad_run_in_blocks_of_rows():
    """A family with ``rows`` runs a forward without autograd in blocks of
    that many rows and joins them: the whole batch's values (bit for bit in
    bf16 here; in float32 the CPU's conv sums in another order at another
    batch, within 1e-6 of the largest value); the init and a forward under
    autograd take the whole batch at once. The configuration's family
    blocks 1250 rows, its microbatches."""
    assert densenet.SOURCE.rows == 1250
    fam, blocked = densenet.Family(L, F), densenet.Family(L, F, rows=3)
    with torch.no_grad():
        assert blocked._blocks(8, init=False) == [slice(0, 3), slice(3, 6), slice(6, 8)]
        assert blocked._blocks(8, init=True) == [slice(0, 8)]
    assert blocked._blocks(8, init=False) == [slice(0, 8)]  # under autograd
    x = uint8_batches(1, seed=2)[0]
    for compute in DTYPES.values():
        d, g, rng = fam.draw(SEED)
        fam.critic(d, fam.images(x, compute), compute, init=True)
        fam.generator(g, fam.init_latent(BATCH, rng), compute, init=True)
        z = fam.latent(BATCH, torch.Generator().manual_seed(4), "cpu")
        with torch.no_grad():
            for net, args in ((fam.generator, (g, z)), (fam.critic, (d, fam.images(x, compute)))):
                whole = net(*args, compute)
                parts = getattr(blocked, net.__name__)(*args, compute)
                atol = 0 if compute == torch.bfloat16 else 1e-6 * float(whole.abs().max())
                torch.testing.assert_close(parts, whole, rtol=0, atol=atol)


def test_source_widths_are_the_ports():
    """At L = F = 16 the module's family draws the port's parameters (names
    and shapes, both nets), and its critic's features are 7296 wide, the
    configuration's ``feature_dim``."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    d, g, _ = densenet.draw(0)
    for mine, net in ((d, port.make_discriminator()), (g, port.make_generator())):
        assert [(k, tuple(t.shape)) for k, t in mine.items()] == [
            (k, tuple(p.shape)) for k, p in net.named_parameters()]
    assert len(densenet.SOURCE.disc_shapes()) == len(densenet.SOURCE.gen_shapes()) == 52
    assert 4 * 4 * 2 * densenet.SOURCE.disc_shapes()[-1][0] == cfg["feature_dim"] == 7296


def engine_reading(cfg: TrainConfig, seed: int, x_init, batches):
    """The port's first two steps (a critic step, a generator step) from
    the seed, then one more generator step from the state they left: the
    readings ``check.numbers`` compares, the program's state before the
    last step, and the generator's first gradient by leaf."""
    eng = Engine(cfg, "cpu")
    state, features = eng.init_state(seed, x_init)
    start = {net: train.snapshot(p) for net, p in harness.leaves(state).items()}
    mets = []
    for x in batches[:2]:
        step = eng.disc_step if eng.is_disc_step(state.step) else eng.gen_step
        state, m = step(state, x)
        mets.append(m)
    first_grad = {net: {k: float(torch.linalg.vector_norm(v)) / (1.0 - cfg.adam_mom1)
                        for k, v in opt.v.items()}
                  for net, opt in (("disc", state.disc_opt), ("gen", state.gen_opt))}
    now = harness.leaves(state)
    first = {"dist": [float(m.dist) for m in mets], "entropy": [float(m.entropy) for m in mets],
             "first_grad": {"disc": first_grad["disc"]},
             "change": {net: train.change_norms(start[net], now[net]) for net in start}}
    before = harness.state_copy(state)
    state, m = eng.gen_step(state, batches[2])
    now = harness.leaves(state)
    replay = {"dist": [float(m.dist)], "entropy": [float(m.entropy)],
              "change": {net: train.change_norms(before[net], now[net])
                         for net in ("disc", "gen", "ema")}}
    return first, replay, before, first_grad["gen"], features


# the check's numbers of the first step, before any backward pass
FORWARD = ("dist_first", "entropy_first")
# float32: (numbers, bound); every other number under FLOAT32_OTHER
FLOAT32 = ((("grad", "gen_grad"), 1e-5), (("change", "replay_change"), 2e-4))
FLOAT32_OTHER = 1e-6
BF16_STEPS = 0.1


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_steps_follow_the_engine(dtype, accum, seed):
    """``follow`` (a critic and a generator step from the seed) and
    ``resume`` (a generator step from the program's state) against the
    port's ``Engine`` on the same batches, whole (``grad_accum`` 1) and in
    the port's microbatches (2): every number of the benchmark's check, and
    the generator's first gradient by its worst leaf (``gen_grad``).

    The models compute alike, bit for bit (above); the two matchers,
    written apart, differ in the last float32 bits of their plans, and each
    bound is what that difference becomes:

    * the first step's distance and entropy, before any backward pass:
      1e-6 in both dtypes (read: up to 4.0e-7);
    * float32, the distances and entropies of every step: 1e-6 (4.0e-7);
      the first gradients by their worst leaf: 1e-5 (1.8e-6); the changes
      over the steps: 2e-4 (6.9e-5), since Adam's first step divides each
      gradient element by its own size, so a small element's relative
      rounding passes into its change undivided;
    * bfloat16, every other number: 0.1. A plan's last bits flip bf16
      roundings in the backward pass, and at this size a 4-value bias
      whose gradient is a sum that cancels moves by up to 5.6% (seed 4,
      ``grad_accum`` 2; most seeds read under 2e-7). 0.1 still fails a step
      on half the batch (0.3 to 0.6 here in the benchmark's harness) or one
      that leaves the state unchanged (1).

    The matching runs at lambda 10 and 20 iterations: at the
    configuration's lambda 500 and a handful of iterations the plan is far
    from converged, and its last bits flip bf16 roundings on most seeds."""
    cfg = TrainConfig(model="densenet", layers_per_block=L, filters_per_layer=F,
                      batch_size=BATCH, sinkhorn_lambda=10.0, nr_sinkhorn_iter=20,
                      grad_accum=accum, compute_dtype=dtype)
    x_init, *batches = uint8_batches(4, seed=seed)
    first, replay, before, gen_grad, features = engine_reading(cfg, SEED, x_init, batches)
    ref_cfg = {k: getattr(cfg, k) for k in harness.STATED}
    ref_cfg["feature_dim"] = features
    # the configuration's family runs its forwards without grad in the port's microbatch rows
    fam, dev = densenet.Family(L, F, rows=BATCH // accum), torch.device("cpu")
    first_ref = train.follow(ref_cfg, fam, SEED, x_init, batches[:2], dev)
    replay_ref = train.resume(ref_cfg, fam, SEED, before, batches[2:], dev)
    numbers = check.numbers(first, first_ref, replay, replay_ref)
    assert set(numbers) == set(check.NUMBERS)
    gen_ref = first_ref["first_grad"]["gen"]
    numbers["gen_grad"] = check.worst_leaf(gen_grad, gen_ref, gen_ref)
    for name, value in numbers.items():
        if name in FORWARD:
            bound = 1e-6
        elif dtype == "bfloat16":
            bound = BF16_STEPS
        else:
            bound = next((b for names, b in FLOAT32 if name in names), FLOAT32_OTHER)
        assert value <= bound, (name, value, bound)
    assert all(v > 0 for v in replay["change"]["gen"].values())  # the step moved every leaf


def test_flops_table_is_the_ports():
    """Each layer's ``[c_in after CReLU, c_out, kh, kw, h_out, w_out]``
    (a dense layer ``[n_in, n_out, 1, 1, 1, 1]``), in the order the
    port's layers run, read from the port's DenseNet at L = F = 16 by
    forward hooks on one image, is the configuration's ``flops`` table:
    52 layers a net, ~2.87 GFLOP an image through the critic and ~7.62
    through the generator."""
    with open(CONFIG) as f:
        table = json.load(f)["flops"]

    def rows(net, inp):
        out = []

        def hook(m, _, y):
            o, i = m.V.shape[:2]
            out.append([i, o, 1, 1, 1, 1] if isinstance(m, Dense)
                       else [i, o, *m.V.shape[2:], *y.shape[1:3]])

        hooks = [m.register_forward_hook(hook) for m in net.modules()
                 if isinstance(m, (Conv2d, Dense))]
        with torch.no_grad():
            net(inp)
        for h in hooks:
            h.remove()
        return out

    got = {"disc": rows(port.make_discriminator(), torch.zeros(1, 32, 32, 3)),
           "gen": rows(port.make_generator(), port.sample_latent(1))}
    assert got == table
    flops = {k: sum(2 * a * b * c * d * e * f for a, b, c, d, e, f in v) for k, v in got.items()}
    assert flops["disc"] == pytest.approx(2.874e9, rel=1e-3)
    assert flops["gen"] == pytest.approx(7.622e9, rel=1e-3)


def test_configuration_states_the_ports_flags():
    """The configuration's flags, parsed by the port, give what the file
    states, and its reference family is found by its ``model``."""
    cell = spec.load(ROOT, "densenet.b5000")
    cfg = harness.program_config(cell, 1)
    assert (cfg.model, cfg.layers_per_block, cfg.filters_per_layer) == ("densenet", 16, 16)
    assert cfg.grad_accum == 4 and not cfg.fused_cycle and not cfg.remat
    assert cfg.init_batch_size == 0  # the data-dependent init on the whole batch
    assert cell.family.__file__ == os.path.join(ROOT, "portbench", "reference", "densenet.py")
