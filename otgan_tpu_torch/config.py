"""Training configuration (counterpart of ``otgan_tpu/config.py``).

Field names, defaults and CLI flags are the JAX package's, so a
``config.json`` written by either package reads in the other. The reference's
flags (``train.py:14-33``) map one to one; ``--nr_gpu`` aliases
``--num_devices``; ``batch_size`` is the GLOBAL batch. ``use_pallas`` means
"run the Sinkhorn loop in the hand-written CUDA kernel".

``--fused_cycle`` (default on) runs each G:D cycle on the card as one
CUDA graph, on one rank or each of K (its NCCL collectives in the graph),
the counterpart of the JAX package's one cycle program (``engine.py``).
Where a capture runs out of device memory (the DenseNet
at batch 5000, ``--grad_accum 4``, fits fused in a fresh process with
little to spare, ``measure_fused.py``) the engine drops its graphs and runs
the rest of the run eagerly, as ``--no_fused_cycle`` does, and the trainer
logs why; ``--no_fused_cycle`` skips the attempt.
``--compilation_cache_dir`` is read and has no effect:
eager torch compiles no XLA program to cache, and ``kernels/build.py``
already keeps the nvcc and g++ output by source hash in ``_build/``; the
JAX package's ``utils/compile_cache.py`` and ``utils/aot_cache.py`` have
no counterpart. ``--matching_precision highest|high|default`` is true
float32, 3xTF32 or one TF32 pass on the card (``ops/costs.py``).
:meth:`TrainConfig.model_opts` is the JAX package's: the toy reads the
default ``crelu`` as ``relu``, every family takes ``compute_dtype``,
``remat`` and ``remat_policy``, and the DenseNet its block sizes.
``--num_devices`` K > 1 runs under ``torchrun --nproc_per_node K``, and
``--matching_layout`` and ``--sharded_matching`` pick its matcher;
``--multihost`` shards the data over hosts (``torchrun --nnodes``, or the
manual ``--coordinator_address``, ``--num_processes``, ``--process_id``).
:func:`check_supported` rejects an unknown checkpoint backend or matching
precision.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # ---- reference flags (train.py:14-33) ----
    seed: int = 1
    batch_size: int = 256  # GLOBAL batch (reference: 625/gpu * 8 = 5000)
    learning_rate_disc: float = 3e-4
    learning_rate_gen: float = 3e-4
    data_dir: str = "/tmp/data"
    save_dir: str = "/tmp/otgan_tpu"
    optimizer: str = "adam"  # adam | adamax | nesterov
    nonlinearity: str = "crelu"  # crelu | celu | relu | elu
    num_devices: int = 0  # 0 = all available (replaces --nr_gpu)
    nr_gen_per_disc: int = 5
    sinkhorn_lambda: float = 500.0
    nr_sinkhorn_iter: int = 500
    single_batch: bool = False
    train_disc_against_ema: bool = False
    model: str = "dcgan"  # dcgan | densenet | toy_mlp
    load_params: bool = False
    model_name: str = ""
    no_sinkhorn: bool = False
    # ---- training-loop knobs with reference defaults ----
    ema_decay: float = 0.999  # train.py:63
    adam_mom1: float = 0.5  # train.py:142
    adam_mom2: float = 0.999
    max_epochs: int = 1000000  # train.py:196
    eval_every_epochs: int = 100  # inception cadence, train.py:245
    save_every_epochs: int = 200  # checkpoint cadence, train.py:275
    inception_samples: int = 50000
    inception_splits: int = 10
    inception_batch: int = 0
    eval_fid: bool = False
    fid_stats_path: str = ""
    # ---- densenet options ----
    layers_per_block: int = 16
    filters_per_layer: int = 16
    # ---- additions of the JAX package ----
    data_dependent_init: bool = True  # False: g=1, b=0 (the reference as shipped)
    init_batch_size: int = 0  # examples for the init pass (0 = batch_size)
    compute_dtype: str = "bfloat16"  # model matmul/conv dtype; matching is f32
    ingest_dtype: str = "uint8"  # uint8 | compute | float32 batches
    host_prefetch: bool = True
    use_pallas: bool = True  # here: the CUDA Sinkhorn kernel
    sharded_matching: bool = True
    matching_layout: str = "auto"
    matching_memory_budget_gb: float = 4.0
    grad_accum: int = 1
    remat: bool = False
    remat_policy: str = ""
    profile_dir: str = ""
    compilation_cache_dir: str = "~/.cache/otgan_tpu/xla"
    log_every_steps: int = 0  # 0 = log per epoch only (reference behavior)
    synthetic_data: bool = False
    synthetic_size: int = 5120
    fused_cycle: bool = True
    max_checkpoints_to_keep: int = 5
    keep_checkpoint_every_n_hours: float = 5.0
    sinkhorn_tol: float = 0.0  # opt-in early exit; 0 = fixed count
    matching_precision: str = "highest"
    debug_nans: bool = False
    checkpoint_slot_dtype: str = "float32"
    async_checkpoint: bool = True
    checkpoint_backend: str = "npz"
    # ---- multi-host ----
    multihost: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    disc_freeze_after_steps: int = 0

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "TrainConfig":
        """Load a saved config; unknown keys are ignored."""
        with open(path) as f:
            data = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in names})

    @classmethod
    def for_run(cls, save_dir: str, **overrides) -> "TrainConfig":
        """The config of the training run in ``save_dir`` (its
        ``config.json``, else the defaults), with ``overrides`` on top."""
        path = os.path.join(save_dir, "config.json")
        cfg = cls.load(path) if os.path.exists(path) else cls()
        return dataclasses.replace(cfg, save_dir=save_dir, **overrides)

    def model_opts(self) -> dict:
        """The model family's constructor options. The toy notebook's MLPs
        are plain relu: the global default ``crelu`` (for the conv models)
        would double every fan-in, so the toy reads it as ``relu``."""
        nonlin = self.nonlinearity
        if self.model == "toy_mlp" and nonlin == "crelu":
            nonlin = "relu"
        common = {"nonlinearity": nonlin, "remat": self.remat,
                  "compute_dtype": self.compute_dtype, "remat_policy": self.remat_policy}
        if self.model == "densenet":
            return {"layers_per_block": self.layers_per_block,
                    "filters_per_layer": self.filters_per_layer, **common}
        return common


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for an unknown checkpoint backend or matching
    precision (the JAX package's message)."""
    if cfg.checkpoint_backend not in ("npz", "orbax"):
        raise ValueError(f"--checkpoint_backend must be npz or orbax, got "
                         f"{cfg.checkpoint_backend!r}")
    from otgan_tpu_torch.ops.costs import resolve_precision

    resolve_precision(cfg.matching_precision)


def _add_bool_flag(p: argparse.ArgumentParser, name: str, default: bool):
    p.add_argument(f"--{name}", dest=name, action="store_true", default=default)
    p.add_argument(f"--no_{name}", dest=name, action="store_false")


def build_parser(description: str = "OT-GAN trainer (PyTorch)") -> argparse.ArgumentParser:
    defaults = TrainConfig()
    p = argparse.ArgumentParser(description=description)
    for f in dataclasses.fields(TrainConfig):
        if isinstance(getattr(defaults, f.name), bool):
            _add_bool_flag(p, f.name, getattr(defaults, f.name))
        else:
            p.add_argument(
                f"--{f.name}",
                type=type(getattr(defaults, f.name)),
                default=getattr(defaults, f.name),
            )
    p.add_argument("--nr_gpu", type=int, default=None, help="alias for --num_devices")
    # train_py = train.py defaults (global batch 625*8 = 5000, 5:1 G:D);
    # model_saving = train_with_model_saving.py (1000*8 = 8000, 3:1)
    p.add_argument("--preset", choices=["train_py", "model_saving"], default=None)
    return p


def config_from_namespace(ns: argparse.Namespace, argv: list) -> TrainConfig:
    """Apply the ``--nr_gpu`` alias and ``--preset`` to parsed flags; a flag
    given explicitly in ``argv`` wins over the preset."""
    ns = argparse.Namespace(**vars(ns))
    if ns.nr_gpu is not None:
        ns.num_devices = ns.nr_gpu
    del ns.nr_gpu

    def explicit(flag: str) -> bool:
        return any(a == flag or a.startswith(flag + "=") for a in argv)

    if ns.preset == "train_py":
        if not explicit("--batch_size"):
            ns.batch_size = 5000
        if not explicit("--nr_gen_per_disc"):
            ns.nr_gen_per_disc = 5
    elif ns.preset == "model_saving":
        if not explicit("--batch_size"):
            ns.batch_size = 8000
        if not explicit("--nr_gen_per_disc"):
            ns.nr_gen_per_disc = 3
    del ns.preset
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in vars(ns).items() if k in names})


def parse_args(argv: Optional[list] = None) -> TrainConfig:
    raw = list(argv if argv is not None else sys.argv[1:])
    return config_from_namespace(build_parser().parse_args(raw), raw)
