"""The port's host batch assembler (``otgan_tpu_torch/data/native.py``,
built from ``otgan_tpu_torch/csrc/otgan_host.cpp``) against the JAX
package's (``otgan_tpu/data/native.py``) on the same seeded uint8 data,
indices and flips: uint8, float32 and bfloat16 bit for bit (tolerance 0;
the JAX side's bfloat16 through ``ml_dtypes``, here in the test only), one
thread against several, the dataset transpose, a stale library that is
rebuilt, and the numpy path when the build fails, which says so once."""

import ctypes
import subprocess

import ml_dtypes
import numpy as np
import pytest
import torch

from otgan_tpu.data import native as jax_native
from otgan_tpu_torch.data import native
from otgan_tpu_torch.kernels import build


def _case(n=64, batch=40, shape=(8, 6, 3), seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (n, *shape)).astype(np.uint8)
    idx = rng.integers(0, n, batch)
    flips = (rng.random(batch) < 0.5).astype(np.uint8)
    return data, idx, flips


def _bits(x) -> np.ndarray:
    """uint16 bit patterns of a bfloat16 batch of either package."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy().view(np.uint16)
    assert x.dtype == ml_dtypes.bfloat16
    return x.view(np.uint16)


def test_native_builds():
    assert native.native_available(), "the g++ build of csrc/otgan_host.cpp failed"
    assert build.host_lib_path().startswith(build.BUILD_DIR)


@pytest.mark.parametrize("flipped", [True, False])
@pytest.mark.parametrize("out_dtype", ["uint8", "float32", "bfloat16"])
def test_assemble_matches_jax_bit_for_bit(out_dtype, flipped):
    data, idx, flips = _case()
    flips = flips if flipped else None
    got = native.assemble_batch_u8(data, idx, flips, out_dtype=out_dtype)
    want = jax_native.assemble_batch_u8(data, idx, flips, out_dtype=out_dtype)
    if out_dtype == "bfloat16":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_every_byte_value_and_threads():
    """All 256 values through the lookup tables, flipped and not; several
    threads give the bytes of one."""
    data = np.arange(256, dtype=np.uint8).reshape(1, 8, 8, 4)
    data = np.concatenate([data, data[:, :, ::-1, :]] * 16)
    idx = np.arange(32)[::-1].copy()
    flips = (np.arange(32) % 3 == 0).astype(np.uint8)
    for out_dtype in ("uint8", "float32", "bfloat16"):
        one = native.assemble_batch_u8(data, idx, flips, n_threads=1, out_dtype=out_dtype)
        many = native.assemble_batch_u8(data, idx, flips, n_threads=5, out_dtype=out_dtype)
        want = jax_native.assemble_batch_u8(data, idx, flips, out_dtype=out_dtype)
        if out_dtype == "bfloat16":
            np.testing.assert_array_equal(_bits(one), _bits(want))
            np.testing.assert_array_equal(_bits(many), _bits(want))
        else:
            np.testing.assert_array_equal(one, want)
            np.testing.assert_array_equal(many, want)
    # bfloat16 is the float32 batch rounded to nearest even (torch's cast)
    f32 = native.assemble_batch_u8(data, idx, flips)
    np.testing.assert_array_equal(
        _bits(native.assemble_batch_u8(data, idx, flips, out_dtype="bfloat16")),
        _bits(torch.from_numpy(f32).to(torch.bfloat16)))


def test_nchw_to_nhwc_and_bad_input():
    src = np.random.default_rng(2).integers(0, 256, (5, 3, 4, 7)).astype(np.uint8)
    got = native.nchw_to_nhwc_u8(src)
    np.testing.assert_array_equal(got, np.transpose(src, (0, 2, 3, 1)))
    np.testing.assert_array_equal(got, jax_native.nchw_to_nhwc_u8(src))
    data, idx, flips = _case()
    with pytest.raises(ValueError, match="indices"):
        native.assemble_batch_u8(data, np.array([0, 64]), None)
    with pytest.raises(ValueError, match="flip_mask"):
        native.assemble_batch_u8(data, idx, flips[:3])
    with pytest.raises(ValueError, match="out_dtype"):
        native.assemble_batch_u8(data, idx, flips, out_dtype="float16")
    with pytest.raises(ValueError, match="uint8"):
        native.nchw_to_nhwc_u8(src.astype(np.float32))


@pytest.fixture
def fresh_native(tmp_path, monkeypatch):
    """The native module with nothing loaded yet, building into ``tmp_path``."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    return native


def test_stale_library_missing_a_symbol_is_rebuilt(fresh_native, tmp_path):
    """A library at the hashed path that lacks an entry point (an older or
    foreign file) is built again, not given up on."""
    old = tmp_path / "old.cpp"
    old.write_text('extern "C" {\nvoid otgan_assemble_batch_u8() {}\n'
                   'void otgan_nchw_to_nhwc_u8() {}\n}\n')
    stale = build.host_lib_path()
    subprocess.run(["g++", "-shared", "-fPIC", str(old), "-o", stale], check=True)
    with pytest.raises(AttributeError):
        ctypes.CDLL(stale).otgan_assemble_batch_u8_bf16  # noqa: B018
    lib = fresh_native._load()
    assert lib is not None and hasattr(lib, "otgan_assemble_batch_u8_bf16")
    data, idx, flips = _case()
    np.testing.assert_array_equal(
        _bits(fresh_native.assemble_batch_u8(data, idx, flips, out_dtype="bfloat16")),
        _bits(jax_native.assemble_batch_u8(data, idx, flips, out_dtype="bfloat16")))


def test_failed_build_takes_the_numpy_path_once(fresh_native, monkeypatch, capsys):
    def no_compiler(*a, **k):
        raise RuntimeError("g++ exited 1")

    monkeypatch.setattr(build, "build_host", no_compiler)
    data, idx, flips = _case()
    for out_dtype in ("uint8", "float32", "bfloat16"):
        got = fresh_native.assemble_batch_u8(data, idx, flips, out_dtype=out_dtype)
        want = jax_native.assemble_batch_u8(data, idx, flips, out_dtype=out_dtype)
        if out_dtype == "bfloat16":
            np.testing.assert_array_equal(_bits(got), _bits(want))
        else:
            np.testing.assert_array_equal(got, want)
    src = np.transpose(data, (0, 3, 1, 2)).copy()
    np.testing.assert_array_equal(fresh_native.nchw_to_nhwc_u8(src), data)
    assert not fresh_native.native_available()
    lines = [l for l in capsys.readouterr().out.splitlines() if "native build unavailable" in l]
    assert len(lines) == 1 and "using numpy" in lines[0]


def test_port_imports_no_jax_ml_dtypes_or_orbax():
    """Neither exists on the card's machine: the port and its smoke script
    import none of them (bfloat16 batches are torch tensors)."""
    import ast
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((repo / "otgan_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "otgan_tpu", "ml_dtypes",
                                                  "orbax"), f"{path}: {name}"
