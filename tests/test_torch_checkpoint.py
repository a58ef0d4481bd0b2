"""The port's checkpoints (``utils/checkpoint.py``), sample grids
(``utils/plotting.py``) and sampler CLI (``sample.py``) on the CPU: a
bit-exact round trip, exact resume, bfloat16 slots, background writes,
retention and checkpoint names against the JAX package's, and samples of a
toy and a DCGAN run, the DCGAN's PNG decoded again.

Resume is held bit for bit: the same float32 operations run in the same
order on the CPU, so k steps, a save, a restore into a fresh engine and m
more steps must equal k + m steps without a break, exactly.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from otgan_tpu.utils import checkpoint as jax_ckpt
from otgan_tpu.utils import plotting as jax_plotting
from otgan_tpu_torch import sample as sample_cli
from otgan_tpu_torch.config import TrainConfig
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.utils import checkpoint as ckpt
from otgan_tpu_torch.utils import plotting

B = 32


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread. The suite runs several pytest
    workers at once, and oversubscribed thread pools made such tests ~10x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(model="toy_mlp", batch_size=B, compute_dtype="float32", sinkhorn_lambda=50.0,
                nr_sinkhorn_iter=10, nr_gen_per_disc=1)
    base.update(kw)
    return TrainConfig(**base)


def _engine_state(seed=0, **kw):
    eng = Engine(_cfg(**kw), device="cpu")
    state, _ = eng.init_state(seed, sample_8gaussians(np.random.default_rng(seed), B))
    return eng, state


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [sample_8gaussians(rng, B) for _ in range(n)]


def _tensors(state):
    out = dict(ckpt._named_tensors(state))
    return {k: t.detach().clone() for k, t in out.items()}


def _assert_same_state(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step
    assert a.gen_opt.t == b.gen_opt.t and a.disc_opt.t == b.disc_opt.t
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def test_round_trip_is_bit_exact(tmp_path):
    eng, state = _engine_state()
    state, _ = eng.cycle(state, _batches(3))
    path = ckpt.save_checkpoint(str(tmp_path), state, 7)
    assert os.path.basename(path) == "otgan_state-7.npz"
    assert sorted(os.listdir(tmp_path)) == ["otgan_state-7.npz"]  # no temp file left
    _, fresh = _engine_state(seed=5)
    ckpt.restore_checkpoint(path, fresh)
    _assert_same_state(fresh, state)
    assert fresh.step == 3 and fresh.gen_opt.t == 2.0 and fresh.disc_opt.t == 3.0


def test_exact_resume(tmp_path):
    """k = 3 steps, save, restore into a fresh engine, m = 3 steps == 6
    steps without a break, bit for bit (latents drawn from the restored
    run generator)."""
    batches = _batches(6)
    eng, whole = _engine_state()
    whole, mets_whole = eng.cycle(whole, batches)
    eng, first = _engine_state()
    first, _ = eng.cycle(first, batches[:3])
    path = ckpt.save_checkpoint(str(tmp_path), first, 2)
    eng2, resumed = _engine_state(seed=9)  # another init: everything comes from the file
    ckpt.restore_checkpoint(path, resumed)
    resumed, mets = eng2.cycle(resumed, batches[3:])
    _assert_same_state(resumed, whole)
    for a, b in zip(mets, mets_whole[3:]):
        assert float(a.dist) == float(b.dist) and float(a.entropy) == float(b.entropy)


def test_bf16_slots(tmp_path):
    eng, state = _engine_state()
    state, _ = eng.cycle(state, _batches(2))
    full = ckpt.save_checkpoint(str(tmp_path / "f32"), state, 1)
    small = ckpt.save_checkpoint(str(tmp_path / "bf16"), state, 1, slot_dtype="bfloat16")
    with np.load(small) as data:
        keys = set(data.files)
    bf16 = {k for k in keys if k.endswith("__bf16")}
    assert bf16 and all(k.split("/")[0] in ("gen_ema", "gen_opt", "disc_opt") for k in bf16)
    assert all(np.load(small)[k].dtype == np.uint16 for k in bf16)
    assert "gen_opt/t" in keys and not any(k.startswith(("gen/", "disc/")) for k in bf16)
    assert os.path.getsize(small) < os.path.getsize(full)
    _, fresh = _engine_state(seed=3)
    ckpt.restore_checkpoint(small, fresh)
    for k, t in ckpt._named_tensors(fresh):
        want = dict(ckpt._named_tensors(state))[k].detach()
        if k.split("/")[0] in ("gen", "disc"):
            assert torch.equal(t.detach(), want), k  # parameters stay exact
        else:
            assert torch.equal(t.detach(), want.to(torch.bfloat16).float()), k
    assert fresh.gen_opt.t == state.gen_opt.t and fresh.step == state.step
    with pytest.raises(ValueError, match="slot_dtype"):
        ckpt.save_checkpoint(str(tmp_path), state, 2, slot_dtype="float16")


def test_async_write_then_latest(tmp_path, monkeypatch):
    """Background writes own their host copies: the state changes in place
    right after each save, and the file still holds the state at the save.
    Retention runs in the writer: the 2 highest steps stay, and the oldest
    file as the first long-term anchor."""
    eng, state = _engine_state()
    saved = {}
    for epoch, x in enumerate(_batches(4)):
        state, _ = eng.cycle(state, [x])
        saved[epoch] = _tensors(state)
        ckpt.save_checkpoint(str(tmp_path), state, epoch, async_write=True, max_to_keep=2)
        with torch.no_grad():
            for p in state.gen.parameters():
                p.add_(1.0)  # what the next step's in-place update does
    latest = ckpt.latest_checkpoint(str(tmp_path))  # waits for the writer
    assert os.path.basename(latest) == "otgan_state-3.npz"
    assert sorted(os.listdir(tmp_path)) == [f"otgan_state-{e}.npz" for e in (0, 2, 3)]
    _, fresh = _engine_state(seed=4)
    ckpt.restore_checkpoint(latest, fresh)
    for k, t in _tensors(fresh).items():
        assert torch.equal(t, saved[3][k]), k
    # a failed background write is raised by the next barrier
    def fail(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.np, "savez", fail)
    ckpt.save_checkpoint(str(tmp_path), state, 4, async_write=True)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        ckpt.wait_for_pending_saves()
    ckpt.wait_for_pending_saves()  # the error is raised once
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("otgan_state-3.npz")


def test_restore_checks_the_state(tmp_path):
    eng, state = _engine_state()
    path = ckpt.save_checkpoint(str(tmp_path), state, 0)
    _, wider = _engine_state(nonlinearity="celu")  # doubled fan-ins
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(path, wider)
    _, fresh = _engine_state(seed=2)
    before = fresh.rng.get_state()
    ckpt.restore_checkpoint(path, fresh, rng=False)  # the sampler's restore
    assert torch.equal(fresh.rng.get_state(), before)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.restore_checkpoint(str(tmp_path), fresh)


def _touch(directory, steps_mtimes):
    os.makedirs(directory, exist_ok=True)
    for step, mtime in steps_mtimes:
        p = os.path.join(directory, f"otgan_state-{step}.npz")
        with open(p, "wb") as f:
            f.write(b"x")
        os.utime(p, (mtime, mtime))
    with open(os.path.join(directory, "otgan_state-99.npz.tmp.npz"), "wb") as f:
        f.write(b"partial")


@pytest.mark.parametrize("max_to_keep,hours", [(3, 1.0), (2, 0.25), (10, 1.0)])
def test_retention_matches_jax(tmp_path, max_to_keep, hours):
    """The same names and mtimes (steps out of mtime order, 25 minutes
    apart) pruned by both packages leave the same files."""
    t0 = 1.7e9
    steps_mtimes = [(s, t0 + 1500.0 * i) for i, s in enumerate([0, 2, 1, 3, 5, 4, 6, 8, 7, 9])]
    _touch(tmp_path / "jax", steps_mtimes)
    _touch(tmp_path / "port", steps_mtimes)
    gone_j = jax_ckpt.prune_checkpoints(str(tmp_path / "jax"), max_to_keep, hours)
    gone = ckpt.prune_checkpoints(str(tmp_path / "port"), max_to_keep, hours)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert sorted(map(os.path.basename, gone)) == sorted(map(os.path.basename, gone_j))
    assert "otgan_state-99.npz.tmp.npz" in map(os.path.basename, gone)
    assert ckpt.latest_checkpoint(str(tmp_path / "port")).endswith("otgan_state-9.npz")


def test_checkpoint_step_errors(tmp_path):
    for name in ("otgan_state-12.npz", "/a/b/otgan_state-0.npz"):
        assert ckpt.checkpoint_step(name) == jax_ckpt.checkpoint_step(name) == int(
            name.split("-")[1][:-4])
    for name in ("model.npz", "otgan_state-x.npz", "otgan_state-3.npz.tmp", ""):
        for fn in (ckpt.checkpoint_step, jax_ckpt.checkpoint_step):
            with pytest.raises(ValueError, match="not a checkpoint path"):
                fn(name)
    stray = tmp_path / "17"
    stray.mkdir()
    orbax = tmp_path / "orbax" / "5"
    orbax.mkdir(parents=True)
    for fn in (ckpt.checkpoint_step, jax_ckpt.checkpoint_step):
        with pytest.raises(ValueError, match="not a checkpoint path"):
            fn(str(stray))
    assert jax_ckpt.checkpoint_step(str(orbax)) == 5
    with pytest.raises(ValueError, match="orbax"):
        ckpt.checkpoint_step(str(orbax))  # a step directory whose write did not finish
    assert ckpt.latest_checkpoint(str(tmp_path)) is None


def test_img_tile_matches_jax():
    imgs = np.random.default_rng(0).uniform(-1, 1, (7, 5, 4, 3)).astype(np.float32)
    for kw in (dict(), dict(aspect_ratio=2.0, border=2, border_color=1.0),
               dict(tile_shape=(2, 4), stretch=True)):
        np.testing.assert_array_equal(plotting.img_tile(imgs, **kw),
                                      jax_plotting.img_tile(imgs, **kw))
    np.testing.assert_array_equal(plotting.img_tile(imgs[..., 0]),
                                  jax_plotting.img_tile(imgs[..., 0]))


def _decode_png(data: bytes) -> np.ndarray:
    """A PNG of 8-bit grey or RGB rows, every row with filter 0 (what
    ``encode_png`` writes), back to its pixels; checks every chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color, *_ = header
    assert depth == 8 and color in (0, 2) and kind == b"IEND"
    chans = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * chans)
    assert not rows[:, 0].any()  # filter 0 on every row
    return rows[:, 1:].reshape((h, w, 3) if chans == 3 else (h, w))


def test_png_round_trip(tmp_path):
    pixels = np.random.default_rng(1).integers(0, 256, (9, 13, 3)).astype(np.uint8)
    np.testing.assert_array_equal(_decode_png(plotting.encode_png(pixels)), pixels)
    np.testing.assert_array_equal(_decode_png(plotting.encode_png(pixels[..., 1])),
                                  pixels[..., 1])
    grid = np.linspace(-1, 1, 6 * 7 * 3, dtype=np.float32).reshape(6, 7, 3)
    plotting.save_tile_img(grid, str(tmp_path / "g.png"))
    np.testing.assert_array_equal(_decode_png((tmp_path / "g.png").read_bytes()),
                                  ((grid + 1.0) * 127.5).astype(np.uint8))
    with pytest.raises(ValueError):
        plotting.encode_png(pixels.astype(np.float32))


def test_sample_cli_toy(tmp_path):
    """A toy run's checkpoint -> ``samples.npz`` of finite points, EMA and
    raw; the same seed gives the same samples."""
    eng, state = _engine_state()
    state, _ = eng.cycle(state, _batches(2))
    eng.cfg.save(str(tmp_path / "config.json"))
    ckpt.save_checkpoint(str(tmp_path), state, 4)
    x = sample_cli.main(["--save_dir", str(tmp_path), "--ema", "--num_samples", "300",
                         "--batch_size", "128", "--device", "cpu"])
    assert x.shape == (300, 2) and np.isfinite(x).all()
    np.testing.assert_array_equal(np.load(tmp_path / "samples.npz")["samples"], x)
    assert not (tmp_path / "samples.png").exists()
    z = eng.latents(128, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(x[:128], eng.sample(state, z, ema=True).numpy())
    raw = sample_cli.main(["--save_dir", str(tmp_path), "--num_samples", "10", "--batch_size",
                           "128", "--device", "cpu", "--out", str(tmp_path / "raw")])
    np.testing.assert_array_equal(raw, eng.sample(state, z).numpy()[:10])


def test_sample_cli_dcgan_png(tmp_path):
    """A DCGAN state's checkpoint -> ``samples.npz`` and a ``samples.png``
    grid that decodes to the tiled samples."""
    cfg = TrainConfig(batch_size=4, compute_dtype="float32", save_dir=str(tmp_path))
    eng = Engine(cfg, device="cpu")
    state, _ = eng.init_state(0, np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3))
                              .astype(np.uint8))
    cfg.save(str(tmp_path / "config.json"))
    path = ckpt.save_checkpoint(str(tmp_path), state, 0, slot_dtype="bfloat16")
    x = sample_cli.main(["--save_dir", str(tmp_path), "--checkpoint", path, "--num_samples", "6",
                         "--batch_size", "4", "--device", "cpu"])
    assert x.shape == (6, 32, 32, 3) and np.isfinite(x).all() and np.abs(x).max() <= 1.0
    png = _decode_png((tmp_path / "samples.png").read_bytes())
    grid = plotting.img_tile(x, aspect_ratio=1.0, border_color=1.0)
    assert png.shape == grid.shape == (3 * 33 - 1, 3 * 33 - 1, 3)
    np.testing.assert_array_equal(png, ((grid + 1.0) * 127.5).astype(np.uint8))
