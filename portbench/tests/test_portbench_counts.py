"""The yardstick's counts against hand arithmetic at both batches."""

from __future__ import annotations

import json
import os

import pytest

from portbench import counts

HERE = os.path.dirname(os.path.abspath(__file__))
H100 = counts.peaks("NVIDIA H100 80GB HBM3")
EXP = 132 * 16 * 1980e6  # 132 SMs x 16 MUFU.EX2 a clock x 1980 MHz

# one image, forward (2 x c_in x c_out x 25 x output pixels)
D = [2 * 3 * 128 * 25 * 32 * 32, 2 * 256 * 256 * 25 * 16 * 16, 2 * 512 * 512 * 25 * 8 * 8,
     2 * 1024 * 1024 * 25 * 4 * 4]
G = [2 * 100 * 32768, 2 * 1024 * 1024 * 25 * 8 * 8, 2 * 512 * 512 * 25 * 16 * 16,
     2 * 256 * 256 * 25 * 32 * 32, 2 * 128 * 3 * 25 * 32 * 32]


def config(name):
    with open(os.path.join(os.path.dirname(HERE), "configs", f"{name}.json")) as f:
        return json.load(f)


def test_peaks_by_name():
    assert H100 == {"bf16": 989e12, "f32": 67e12, "bytes": 3.35e12}
    assert counts.peaks("NVIDIA H100 PCIe")["bf16"] == 756e12
    with pytest.raises(RuntimeError):
        counts.peaks("cpu")


def test_model_flops_by_hand():
    table = config("dcgan_train_py")["flops"]
    assert sum(D) == 19_660_800 + 3 * 838_860_800
    assert sum(G) == 6_553_600 + 3 * 3_355_443_200 + 19_660_800
    # generator step: G fwd, D fwd on fakes and data, D input gradients,
    # G weight gradients and input gradients but the latent's
    gen = sum(G) + 3 * sum(D) + sum(G) + sum(G) - G[0]
    # critic step: G fwd, D fwd x2, D weight gradients x2, D input gradients
    # x2 but the images'
    disc = sum(G) + 4 * sum(D) + 2 * (sum(D) - D[0])
    assert counts.model_flops(table, disc_step=False) == gen
    assert counts.model_flops(table, disc_step=True) == disc
    # a 5:1 cycle at batch 5000: 1.0733 PFLOP; a 3:1 cycle at batch 8000: 1.1116
    assert 5000 * (5 * gen + disc) == 1_073_348_608_000_000
    assert 8000 * (3 * gen + disc) == 1_111_280_844_800_000


@pytest.mark.parametrize("batch,ranks,want", [(5000, 1, 7.3728e12), (8000, 1, 1.8874368e13),
                                              (8000, 4, 4.718592e12)])
def test_gemm_flops_by_hand(batch, ranks, want):
    # 6 costs + 12 matched-feature products of (B/2)^2 x d, 2 FLOPs a term
    assert counts.gemm_flops(batch, 32768, ranks) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(18 * 2 * (batch // 2) ** 2 * 32768 / ranks, rel=1e-12)


@pytest.mark.parametrize("shape,ms", [((6, 2500, 2500), 8.968), ((6, 4000, 4000), 22.957),
                                      ((6, 1000, 4000), 5.739)])
def test_sinkhorn_bound_by_hand(shape, ms):
    """500 iterations: 2 expf a cell and iteration on the special-function
    units bound it (8 float32 operations at 67 TFLOP/s take a quarter of
    that; reading C and writing P once, far less)."""
    b, n, m = shape
    cells = b * n * m
    assert 2 * cells * 500 / EXP * 1e3 == pytest.approx(ms, rel=1e-3)
    assert 8 * cells * 500 / 67e12 < 2 * cells * 500 / EXP
    assert 4 * (2 * cells + b * n) / 3.35e12 < 2 * cells * 500 / EXP
    assert counts.sinkhorn_bound_s(b, n, m, 500, H100, EXP) * 1e3 == pytest.approx(ms, rel=1e-3)


def test_step_least_time_parts():
    cfg = config("dcgan_model_saving")
    one = counts.step_least_s(cfg, False, 1, H100, EXP)
    four = counts.step_least_s(cfg, False, 4, H100, EXP)
    assert one["model"] == pytest.approx(4 * four["model"])
    assert one["gemm"] == pytest.approx(1.8874368e13 / 67e12)
    assert four["sinkhorn"] * 1e3 == pytest.approx(5.739, rel=1e-3)
