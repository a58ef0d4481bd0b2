"""Crash recovery in the port (the batch-8000 rehearsal's pieces on the CPU).

* ``--remat_policy disc_c2_half`` is accepted, warns once that the port
  cannot save half a tensor (saying whether disc_c2 is recomputed or kept
  whole), and changes no number: the critic's gradients with and without
  it are equal bit for bit (tolerance 0, float32, CPU).
* The toy under ``--checkpoint_backend orbax`` as a trainer process:
  SIGKILLed after an epoch record, with stale step directories planted
  above the newest commit (DCP files without ``.metadata``, and only
  ``.metadata.tmp``), resumed with ``--load_params``: it restores the
  newest committed step and says the epoch, the stale directories are
  gone once it re-saves that step or commits a later one, and the
  committed set at exit is ``retained_steps``'.
* The rehearsal script ``otgan_tpu_torch/examples/marathon_b8000.sh``:
  valid bash, its ``COMMON_FLAGS`` parse and equal the JAX script's flag
  for flag (read, not run), and ``chip_smoke.py`` phase 15 changes only
  the depth flags it lists.
* The ``model_saving`` schedule (3:1) under ``--grad_accum 2 --remat``
  on the toy at batch 32, lam 500: each step of the port against the JAX engine on the
  same batches and latents from the same state, within the JAX band at
  lam 500 (dist and entropy 1e-4 absolute, ROADMAP queue 3 item 3); and a
  DCP save and restore of the port's state between two steps changes
  nothing after it (bit for bit).
"""

import json
import os
import pathlib
import shlex
import shutil
import signal
import subprocess
import sys
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from otgan_tpu.config import TrainConfig as JaxConfig
from otgan_tpu.config import parse_args as jax_parse_args
from otgan_tpu.engine import Engine as JaxEngine
from otgan_tpu_torch.config import TrainConfig, parse_args
from otgan_tpu_torch.convert import state_from_jax
from otgan_tpu_torch.data.toy import sample_8gaussians
from otgan_tpu_torch.engine import Engine
from otgan_tpu_torch.models import dcgan
from otgan_tpu_torch.nn.layers import reset_parameters
from otgan_tpu_torch.utils import checkpoint_orbax
from otgan_tpu_torch.utils.checkpoint import _named_tensors, retained_steps

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = REPO / "otgan_tpu_torch" / "examples" / "marathon_b8000.sh"
JAX_SCRIPT = REPO / "examples" / "marathon_b8000.sh"


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- fault 2: disc_c2_half ----

@pytest.mark.parametrize("policy, kept", [("disc_c2_half,disc_c4", "recomputed"),
                                          ("disc_c2,disc_c2_half", "kept whole")])
def test_disc_c2_half_warns_once_and_changes_no_gradient(policy, kept):
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32))
    base = policy.replace("disc_c2_half", "").strip(",")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plain = dcgan.make_discriminator(remat=True, remat_policy=base)
    assert not caught
    reset_parameters(plain, torch.Generator().manual_seed(0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        half = dcgan.make_discriminator(remat=True, remat_policy=policy)
    msgs = [str(w.message) for w in caught]
    assert len(msgs) == 1 and caught[0].category is UserWarning
    assert "cannot save half a tensor" in msgs[0] and f"disc_c2 will be {kept}" in msgs[0]
    half.load_state_dict(plain.state_dict())
    grads = []
    for module in (plain, half):
        out = module(x)
        grads.append(torch.autograd.grad(torch.sum(out ** 2), list(module.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---- the toy under DCP: SIGKILL, stale directories, resume, retention ----

MAX_KEEP, HOURS = 2, 100.0


def _toy_argv(save_dir, max_epochs, *extra):
    return [sys.executable, "-u", "-m", "otgan_tpu_torch.train", "--device", "cpu",
            "--model", "toy_mlp", "--batch_size", "64", "--sinkhorn_lambda", "50",
            "--nr_sinkhorn_iter", "5", "--nr_gen_per_disc", "1", "--checkpoint_backend",
            "orbax", "--save_every_epochs", "2", "--max_checkpoints_to_keep", str(MAX_KEEP),
            "--keep_checkpoint_every_n_hours", str(HOURS), "--max_epochs", str(max_epochs),
            "--save_dir", str(save_dir), *extra]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OTGAN_TOY_EPOCH_BATCHES="2",
                OMP_NUM_THREADS="1")


def _epochs(save_dir):
    path = save_dir / "metrics.jsonl"
    if not path.exists():
        return []
    return [json.loads(line)["epoch"] for line in path.read_text().splitlines()
            if line.endswith("}") and '"epoch"' in line]


def test_toy_dcp_sigkill_stale_dirs_resume_and_retention(tmp_path):
    d = tmp_path / "run"
    proc = subprocess.Popen(_toy_argv(d, 1000), cwd=REPO, env=_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    t0 = time.time()
    try:
        while not any(e >= 4 for e in _epochs(d)):
            assert proc.poll() is None and time.time() - t0 < 60
            time.sleep(0.01)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == -signal.SIGKILL
    committed = checkpoint_orbax.committed_steps(str(d))
    newest = max(committed)
    assert newest >= 1 and newest % 2 == 1  # saves at epochs 1, 3, 5, ...
    root = d / "orbax"
    for s in os.listdir(root):  # an in-flight write the kill cut short
        assert int(s) in committed or int(s) > newest
    # stale directories above the newest commit: DCP files without
    # .metadata (a step the resumed run never saves), and only .metadata.tmp
    # (a step it re-saves)
    stale_files = root / str(newest + 1)
    shutil.copytree(root / str(newest), stale_files)
    (stale_files / ".metadata").unlink()
    stale_tmp = root / str(newest + 2)
    shutil.rmtree(stale_tmp, ignore_errors=True)
    stale_tmp.mkdir()
    (stale_tmp / ".metadata.tmp").write_bytes(b"cut short")
    assert not checkpoint_orbax.is_committed(str(stale_files))
    assert not checkpoint_orbax.is_committed(str(stale_tmp))
    mtimes = {s: os.path.getmtime(os.path.join(p, ".metadata")) for s, p in committed.items()}

    out = subprocess.run(_toy_argv(d, newest + 5, "--load_params"), cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    restored = [line for line in out.stdout.splitlines() if line.startswith("restored ")]
    assert restored == [f"restored {root / str(newest)} (dcp checkpoint format); resuming at "
                        f"epoch {newest + 1}"]
    final = checkpoint_orbax.committed_steps(str(d))
    assert sorted(os.listdir(root)) == sorted(str(s) for s in final)  # nothing uncommitted
    assert newest + 2 in final and newest + 4 in final and newest + 1 not in final
    # the resumed run committed newest + 2 and newest + 4 after the others
    later = max(mtimes.values()) + 1.0
    mtimes.update({newest + 2: later, newest + 4: later + 1.0})
    assert set(final) == retained_steps(mtimes, MAX_KEEP, HOURS)


# ---- the rehearsal script's flags ----

def test_script_is_bash_and_its_flags_are_the_jax_scripts():
    subprocess.run(["bash", "-n", str(SCRIPT)], check=True)
    flags = chip_smoke.script_flags(str(SCRIPT))
    assert flags == chip_smoke.script_flags(str(JAX_SCRIPT))  # flag for flag
    argv = [w.replace("$RUN_DIR", "/run") for w in flags]
    cfg = parse_args(argv)
    assert (cfg.batch_size, cfg.nr_gen_per_disc, cfg.grad_accum, cfg.remat) == (8000, 3, 8, True)
    assert (cfg.checkpoint_backend, cfg.eval_fid, cfg.fused_cycle) == ("orbax", True, True)
    jax_cfg = jax_parse_args(argv)
    assert {k: getattr(cfg, k) for k in vars(jax_cfg) if hasattr(cfg, k)} == {
        k: v for k, v in vars(jax_cfg).items() if hasattr(cfg, k)}
    text = SCRIPT.read_text()
    assert "python -u -m otgan_tpu_torch.train" in text and "otgan_tpu.train" not in text
    for epoch in (21, 41):
        assert f"run_leg leg{1 if epoch == 21 else 2} {epoch}" in text


def test_phase15_flags_cut_only_depth():
    assert chip_smoke.REHEARSAL_CUTS == {"--max_epochs": "9", "--save_every_epochs": "2",
                                         "--eval_every_epochs": "3",
                                         "--inception_samples": "2000"}
    script = [w.replace("$RUN_DIR", "/run") for w in chip_smoke.script_flags(str(SCRIPT))]
    phase = chip_smoke.rehearsal_flags("/run")

    def pairs(words):
        out, i = {}, 0
        while i < len(words):
            takes = i + 1 < len(words) and not words[i + 1].startswith("--")
            out[words[i]] = words[i + 1] if takes else True
            i += 2 if takes else 1
        return out

    a, b = pairs(script), pairs(phase)
    changed = {k for k in set(a) | set(b) if a.get(k) != b.get(k)}
    assert changed == set(chip_smoke.REHEARSAL_CUTS)
    assert all(b[k] == v for k, v in chip_smoke.REHEARSAL_CUTS.items())
    assert shlex.join(phase).count("--save_dir /run") == 1


# ---- model_saving under --grad_accum 2 --remat against JAX, with a DCP round trip ----

B, ACCUM = 32, 2


def _cfg(cls):
    """The model_saving schedule and the rehearsal's microbatching and remat
    on the toy (the DCGAN's CPU steps take tens of seconds), at lam 500."""
    return cls(model="toy_mlp", batch_size=B, num_devices=1, compute_dtype="float32",
               nr_gen_per_disc=3, grad_accum=ACCUM, remat=True, sinkhorn_lambda=500.0,
               nr_sinkhorn_iter=50, data_dependent_init=False)


def _jax_latents(rng_key):
    """The latents the JAX step draws from ``rng_key``: one key a microbatch."""
    _, noise_key = jax.random.split(rng_key)
    return np.concatenate([np.asarray(jax.random.normal(k, (B // ACCUM, 256)))
                           for k in jax.random.split(noise_key, ACCUM)])


def test_model_saving_accum_remat_steps_match_jax_and_survive_dcp(tmp_path):
    """One 3:1 cycle (a critic step, then 3 generator steps). Before steps
    0-2 the port's state takes the JAX state (a free-running pair drifts at
    lam 500 from rounding, ROADMAP queue 3 item 4); before step 2 a copy
    goes through a DCP step directory into a fresh state of another seed,
    then both run steps 2 and 3 on their own. Every step of the port is
    within 1e-4 of JAX's, and the round-tripped state's steps, and its state
    after them, equal the other's bit for bit."""
    eng_j = JaxEngine(_cfg(JaxConfig))
    rng = np.random.default_rng(0)
    x_init = sample_8gaussians(rng, B)
    batches = [sample_8gaussians(rng, B) for _ in range(4)]
    state_j, _ = eng_j.init_state(0, eng_j.shard(x_init))
    eng = Engine(_cfg(TrainConfig), device="cpu")
    state, _ = eng.init_state(0, x_init)
    trip = None
    kinds = []
    for i, x in enumerate(batches):
        z = _jax_latents(state_j.rng)
        if i <= 2:
            state = state_from_jax(eng, state, jax.device_get(state_j))
        if i == 2:
            path = checkpoint_orbax.save_checkpoint(str(tmp_path), state, 1, async_write=False)
            trip = checkpoint_orbax.restore_checkpoint(path, eng.init_state(5, x_init)[0])
        kind = "disc" if eng.is_disc_step(i) else "gen"
        kinds.append(kind)
        state_j, met_j = (eng_j.disc_step if kind == "disc" else eng_j.gen_step)(
            state_j, eng_j.shard(x))
        step = eng.disc_step if kind == "disc" else eng.gen_step
        mets = []
        for st in [state] + ([trip] if trip is not None else []):
            st, met = step(st, x, z)
            mets.append(met)
            assert abs(float(met.dist) - float(met_j.dist)) < 1e-4, i
            assert abs(float(met.entropy) - float(met_j.entropy)) < 1e-4, i
        if trip is not None:
            assert torch.equal(mets[0].dist, mets[1].dist), i
            assert torch.equal(mets[0].entropy, mets[1].entropy), i
    assert kinds == ["disc", "gen", "gen", "gen"]
    assert state.step == trip.step == 4
    for (k, a), (_, b) in zip(_named_tensors(state), _named_tensors(trip)):
        assert torch.equal(a, b), k
