"""paddle_tpu_torch's native data feed (``io/native_feed.py`` over its
copy ``io/csrc/datafeed.cc``) against the JAX package's C engine.

The reference's own source, ``csrc/datafeed.cc``, is built here with
``g++`` into the test's temporary directory (``csrc/`` is not touched)
with the flags of ``csrc/Makefile``, and loaded with ``ctypes``; the
port's library is built by the port at first use.  On the same inputs,
made with numpy from a seed, the shuffle, the three gathers and the
hogwild ``scatter_axpy`` give the same bits (tolerance 0: the two
libraries compile the same code).  A source that does not compile
raises at first use with the compiler's message (the port has no numpy
fallback)."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu_torch.io import native_feed

ROOT = Path(__file__).resolve().parents[1]
I64P = ctypes.POINTER(ctypes.c_int64)
F32P = ctypes.POINTER(ctypes.c_float)
U8P = ctypes.POINTER(ctypes.c_uint8)


@pytest.fixture(scope="module")
def ref_lib(tmp_path_factory):
    """The JAX package's csrc/datafeed.cc, built into a temporary dir."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to build the reference data feed")
    out = tmp_path_factory.mktemp("ref_feed") / "libref_datafeed.so"
    subprocess.run([cxx, *native_feed.CXX_FLAGS, "-o", str(out),
                    str(ROOT / "csrc" / "datafeed.cc")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.ptpu_shuffle_indices.argtypes = [I64P, ctypes.c_int64,
                                         ctypes.c_uint64]
    lib.ptpu_gather_f32.argtypes = [F32P, I64P, ctypes.c_int64,
                                    ctypes.c_int64, F32P]
    lib.ptpu_gather_u8_to_f32.argtypes = [U8P, I64P, ctypes.c_int64,
                                          ctypes.c_int64, F32P,
                                          ctypes.c_float]
    lib.ptpu_gather_i64.argtypes = [I64P, I64P, ctypes.c_int64,
                                    ctypes.c_int64, I64P]
    lib.ptpu_scatter_axpy.argtypes = [F32P, ctypes.c_int64, I64P,
                                      ctypes.c_int64, ctypes.c_int64,
                                      F32P, ctypes.c_float]
    return lib


def test_the_port_builds_its_own_copy_into_its_build_folder():
    assert native_feed.available()
    path = Path(native_feed.build_log["path"])
    assert path.parent == ROOT / "paddle_tpu_torch" / "io" / "build"
    assert path.exists() and native_feed.load_library().ptpu_version() == 1


@pytest.mark.parametrize("n,seed", [(1, 3), (1000, 0), (4097, 2 ** 40 + 5)])
def test_shuffle_equals_the_reference(ref_lib, n, seed):
    want = np.arange(n, dtype=np.int64)
    ref_lib.ptpu_shuffle_indices(want.ctypes.data_as(I64P), n,
                                 ctypes.c_uint64(seed))
    got = native_feed.shuffle_indices(n, seed)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))


def test_gathers_equal_the_reference(ref_lib):
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 300, 257).astype(np.int64)
    src = rng.randn(300, 3, 5).astype(np.float32)
    want = np.empty((257, 3, 5), np.float32)
    ref_lib.ptpu_gather_f32(src.ctypes.data_as(F32P),
                            rows.ctypes.data_as(I64P), 257, 15,
                            want.ctypes.data_as(F32P))
    np.testing.assert_array_equal(native_feed.gather_rows(src, rows), want)

    u8 = rng.randint(0, 256, (300, 7)).astype(np.uint8)
    want = np.empty((257, 7), np.float32)
    ref_lib.ptpu_gather_u8_to_f32(u8.ctypes.data_as(U8P),
                                  rows.ctypes.data_as(I64P), 257, 7,
                                  want.ctypes.data_as(F32P),
                                  ctypes.c_float(1 / 255))
    got = native_feed.gather_rows(u8, rows, u8_scale=1 / 255)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    i64 = rng.randint(-2 ** 40, 2 ** 40, (300,)).astype(np.int64)
    want = np.empty((257,), np.int64)
    ref_lib.ptpu_gather_i64(i64.ctypes.data_as(I64P),
                            rows.ctypes.data_as(I64P), 257, 1,
                            want.ctypes.data_as(I64P))
    np.testing.assert_array_equal(native_feed.gather_rows(i64, rows), want)
    # other dtypes index with numpy, as the reference
    f64 = rng.randn(300, 2)
    np.testing.assert_array_equal(native_feed.gather_rows(f64, rows),
                                  f64[rows])


def test_scatter_axpy_equals_the_reference(ref_lib):
    rng = np.random.RandomState(1)
    table = rng.randn(50, 9).astype(np.float32)
    slots = rng.randint(-1, 50, 400).astype(np.int64)   # -1: skipped
    grads = rng.randn(400, 9).astype(np.float32)
    want = table.copy()
    ref_lib.ptpu_scatter_axpy(want.ctypes.data_as(F32P), 9,
                              slots.ctypes.data_as(I64P), 400, 9,
                              grads.ctypes.data_as(F32P),
                              ctypes.c_float(-0.37))
    got = table.copy()
    assert native_feed.scatter_axpy(got, slots, grads, -0.37) is True
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="out of range"):
        native_feed.scatter_axpy(got, np.asarray([50]), grads[:1], 1.0)
    with pytest.raises(ValueError, match="grads size"):
        native_feed.scatter_axpy(got, slots[:3], grads[:2], 1.0)


def test_a_source_that_does_not_compile_raises_with_the_message(
        tmp_path, monkeypatch):
    bad = tmp_path / "datafeed.cc"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native_feed, "_SRC", bad)
    monkeypatch.setattr(native_feed, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_feed, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        native_feed.shuffle_indices(4, 0)
