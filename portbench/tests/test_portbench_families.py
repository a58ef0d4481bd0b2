"""The plain reference's model families: the configuration's ``model`` names
a file of its own, ``portbench/reference/<model>.py``, that the harness
finds by name in a benchmark root, and under ``grad_accum`` > 1 the
reference computes a step's gradient in the port's microbatches."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.parallel.mesh import local_rows
from portbench import spec
from portbench.reference import dcgan, train
from portbench.tests.conftest import PORTBENCH, TINY, TINY_LIMITS, make_root

# a model family in one file: a critic of one dense layer on the images and
# a generator whose latent is a tuple of two noises (a vector and a 4x4 map)
STANDIN = '''
import torch
import torch.nn.functional as F

D = 16


def draw(seed):
    rng = torch.Generator().manual_seed(seed)
    disc = {"dense.W": 0.05 * torch.randn(D, 32 * 32 * 3, generator=rng), "dense.b": torch.zeros(D)}
    gen = {"dense.W": 0.05 * torch.randn(32 * 32 * 3, 8 + 4 * 4 * 3, generator=rng),
           "dense.b": torch.zeros(32 * 32 * 3)}
    return disc, gen, rng


def images(x_uint8, compute):
    return (x_uint8.float() / 127.5 - 1.0).to(compute)


def critic(params, x, compute, init=False):
    h = F.linear(x.reshape(x.shape[0], -1).float(), params["dense.W"], params["dense.b"])
    h = F.relu(torch.cat([h, -h], dim=-1))
    return h / torch.sqrt(torch.sum(h.square(), dim=-1, keepdim=True))


def generator(params, z, compute, init=False):
    u, m = z
    h = F.linear(torch.cat([u, m.reshape(m.shape[0], -1)], dim=-1), params["dense.W"],
                 params["dense.b"])
    return torch.tanh(h).reshape(u.shape[0], 32, 32, 3)


def init_latent(n, cpu_rng):
    return (torch.rand((n, 8), generator=cpu_rng) * 2.0 - 1.0,
            torch.rand((n, 4, 4, 3), generator=cpu_rng) * 2.0 - 1.0)


def latent(batch, generator, device):
    return tuple(torch.rand(s, generator=generator, device=device) * 2.0 - 1.0
                 for s in ((batch, 8), (batch, 4, 4, 3)))
'''


def tiny_config(**changes) -> dict:
    """The train.py configuration at a tiny size, as the reference reads it."""
    with open(os.path.join(PORTBENCH, "configs", "dcgan_train_py.json")) as f:
        cfg = json.load(f)
    cfg.update(batch_size=8, nr_sinkhorn_iter=5)
    cfg.update(changes)
    return cfg


def uint8_batches(n: int, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (batch, 32, 32, 3), np.uint8))
            for _ in range(n)]


def with_config(root: str, name: str, model: str) -> str:
    """``root``'s tiny cell with its configuration's ``model`` set to
    ``model``, under the configuration file ``name``."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    with open(os.path.join(root, "portbench", "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, model=model)
    with open(os.path.join(root, "portbench", "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    cell = f"{name}.t8"
    bench["configs"].append(dict(bench["configs"][0], name=name,
                                 file=f"portbench/configs/{name}.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=cell, config=name))
    with open(path, "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "portbench", "workloads", f"{TINY}.json")) as f:
        limits = f.read()
    with open(os.path.join(root, "portbench", "workloads", f"{cell}.json"), "w") as f:
        f.write(limits)
    return cell


def state_at(cfg: dict, family, seed: int, x_init, batch, ranks: int) -> dict:
    """The reference's state after its first step (a critic step), at a
    generator step."""
    tr = train.Trainer(cfg, family, seed, torch.device("cpu"), ranks, ranks)
    tr.init(seed, x_init)
    tr.train_step(batch)
    state = {net: train.snapshot(getattr(tr, net)) for net in ("disc", "gen", "ema")}
    for name in ("disc_opt", "gen_opt"):
        opt = getattr(tr, name)
        state[name] = {"t": float(opt.t), "v": train.snapshot(opt.v), "mg": train.snapshot(opt.mg)}
    state["step"] = tr.step
    return state


def test_family_is_resolved_from_model(tiny_root):
    cell = spec.load(tiny_root, TINY)
    assert cell.config["model"] == "dcgan"
    assert cell.family.__file__ == os.path.join(tiny_root, "portbench", "reference", "dcgan.py")
    for name in ("draw", "images", "critic", "generator", "init_latent", "latent"):
        assert callable(getattr(cell.family, name)), name


@pytest.fixture
def root(tmp_path):
    """A benchmark root of its own, which a test may add files to."""
    return make_root(str(tmp_path), TINY_LIMITS)


def test_unknown_family_is_refused_at_load(root):
    """A configuration whose model has no reference file fails when its cell
    is loaded, before any program is built, and names the file."""
    cell = with_config(root, "nofamily", "no_such_family")
    with pytest.raises(FileNotFoundError) as e:
        spec.load(root, cell)
    assert os.path.join("portbench", "reference", "no_such_family.py") in str(e.value)
    assert "nofamily" in str(e.value)


@pytest.mark.parametrize("accum", [1, 2])
def test_stand_in_family_in_one_file(root, accum):
    """A family written as one file under a benchmark root, its latent a
    tuple of two tensors, is found by a configuration's ``model`` and
    followed from the seed and resumed from a state, whole or in
    microbatches, with no other edit."""
    with open(os.path.join(root, "portbench", "reference", "standin.py"), "w") as f:
        f.write(STANDIN)
    cell = spec.load(root, with_config(root, "standin", "standin"))
    fam = cell.family
    assert fam.__file__ == os.path.join(root, "portbench", "reference", "standin.py")
    cfg = tiny_config(compute_dtype="float32", nr_gen_per_disc=1, grad_accum=accum)
    x_init, *batches = uint8_batches(4, 8)
    dev = torch.device("cpu")
    first = train.follow(cfg, fam, 3, x_init, batches[:2], dev)
    later = train.resume(cfg, fam, 3, state_at(cfg, fam, 3, x_init, batches[0], 1), batches[1:],
                         dev)
    assert len(first["dist"]) == 2 and len(later["dist"]) == 2
    assert set(first["first_grad"]) == {"disc", "gen"}
    # the resumed call's first step is the followed run's second, from the same state
    assert later["dist"][0] == pytest.approx(first["dist"][1], rel=1e-5)
    for reading in (first, later):
        assert all(math.isfinite(v) for v in reading["dist"] + reading["entropy"])
        for net in ("disc", "gen", "ema"):
            assert all(v > 0 for v in reading["change"][net].values()), net


def gap(prog: dict, ref: dict) -> float:
    """The gap of a net's leaf norms over the net's norm."""
    norm = math.sqrt(sum(v * v for v in ref.values()))
    diff = math.sqrt(sum((prog[k] - ref[k]) ** 2 for k in ref))
    return diff / norm if norm else diff


@pytest.mark.parametrize("ranks", [1, 2])
def test_microbatches_equal_the_whole_batch(ranks):
    """``grad_accum`` 2 and 4 at a tiny batch of 8 (blocks of half and a
    quarter of it on one rank, of each rank's rows on 2): a critic step
    (the first from the seed) and a generator step (from the state after
    it) read the same distance, scale and entropy as the whole batch, bit
    for bit, since these come from the whole batch's features without
    grad; first gradients and changes lie within 1e-6 of their net's norm.
    The tolerance is the blocks' gradient sum, in another order, in float32:
    the models compute in float64 here (each layer's result rounded to
    float32 as ``dcgan.py`` rounds it), so that no product's rounding at
    another batch size, amplified by the sums' cancellation, adds to it.
    On 2 ranks the cotangents go back from the matched rows' order to the
    batch's."""
    torch.set_num_threads(2)
    x_init, *batches = uint8_batches(3, 8, seed=ranks)
    dev = torch.device("cpu")
    base = tiny_config(compute_dtype="float64")
    state = state_at(base, dcgan, 5, x_init, batches[0], ranks)
    whole = (train.follow(base, dcgan, 5, x_init, batches[:1], dev, ranks, ranks),
             train.resume(base, dcgan, 5, state, batches[1:], dev, ranks, ranks))
    for accum in (2, 4):
        cfg = dict(base, grad_accum=accum)
        assert len(train.Trainer(cfg, dcgan, 5, dev, ranks, ranks).blocks) == accum * ranks
        blocks = (train.follow(cfg, dcgan, 5, x_init, batches[:1], dev, ranks, ranks),
                  train.resume(cfg, dcgan, 5, state, batches[1:], dev, ranks, ranks))
        for kind, w, b in zip(("critic", "generator"), whole, blocks):
            for key in ("dist", "dist_scale", "entropy"):
                assert b[key] == w[key], (accum, kind, key)
            for net, grads in w["first_grad"].items():
                assert gap(b["first_grad"][net], grads) <= 1e-6, (accum, kind, net)
            for net, change in w["change"].items():
                assert gap(b["change"][net], change) <= 1e-6, (accum, kind, net)


@pytest.mark.parametrize("batch,chips,accum", [(8, 1, 2), (8, 2, 2), (12, 2, 3), (8, 4, 1)])
def test_blocks_are_the_ports_microbatches(batch, chips, accum):
    """The reference's blocks are the rows of the port's microbatches: each
    rank's contiguous rows (``local_rows``) cut by ``Engine._microbatches``,
    rank by rank; under ``grad_accum`` 1 the whole batch at once."""
    cfg = tiny_config(batch_size=batch, grad_accum=accum)
    tr = train.Trainer(cfg, dcgan, 1, torch.device("cpu"), 1, chips)
    if accum == 1:
        assert tr.blocks is None
        return
    eng = Engine(TrainConfig(model="toy_mlp", batch_size=batch, grad_accum=accum,
                             compute_dtype="float32"), device="cpu")
    rows = torch.arange(batch)
    want = [local_rows(rows, k, chips)[sl].tolist() for k in range(chips)
            for sl in eng._microbatches(batch // chips)]
    assert [rows[sl].tolist() for sl in tr.blocks] == want
