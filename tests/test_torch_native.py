"""The port's native vector-I/O library against the JAX package's and against
the numpy branches, on the CPU.

`srsran_ce_tpu_torch/native/vector_io.cpp` is a copy of the JAX package's
`native/vector_io.cpp`, built by the port's loader into `_build/` (g++ is on
this host). Every function is held identical (`np.array_equal`, the same
float32 bits: each copies values, none computes) to JAX's
`srsran_ce_tpu.native.loader` and to the numpy branch the callers take when
the library does not build, on seeded records and batches. Then the serving
front-end with the native branch is held identical to its numpy branch and
to JAX's `serving.process` within tests/test_torch_serving.py's bars.
"""
import numpy as np
import pytest

from srsran_ce_tpu import serving as js
from srsran_ce_tpu.native import loader as jn
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu.utils import vectors as jvec
from srsran_ce_tpu_torch import serving as ts
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.native import loader as tn
from srsran_ce_tpu_torch.utils import vectors as tvec


def records(seed, n, n_sc=48, n_sym=14, n_ports=3, outside=0):
    """`n` seeded expected_entry_t records at distinct grid positions, as
    bytes; `outside` of them fall past the grid's subcarriers."""
    rng = np.random.default_rng(seed)
    sc, sym, port = np.unravel_index(rng.permutation(n_sc * n_sym * n_ports)[:n],
                                     (n_sc, n_sym, n_ports))
    sc[:outside] = n_sc + np.arange(outside)
    val = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    rec = np.empty(n, dtype=tvec._ENTRY_DTYPE)
    rec["packed"] = (sym.astype(np.uint16) << 8) | port.astype(np.uint16)
    rec["sc"] = sc.astype(np.uint16)
    rec["re"], rec["im"] = val.real, val.imag
    return rec.tobytes()


def same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.names:
        for f in a.dtype.names:
            assert np.array_equal(a[f], b[f]), f
    else:
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_library_builds_into_the_build_directory():
    assert tn.available()
    so = tn._target()
    assert so.exists() and so.parent.name == "_build" and so.parent.parent.name == "srsran_ce_tpu_torch"


@pytest.mark.parametrize("n", [0, 1, 777])
def test_parse_entries_matches_jax_and_numpy(n):
    raw = records(n, n)
    got = tn.parse_entries(raw)
    same(got, jn.parse_entries(raw))
    same(got, tvec.parse_entries_np(raw))
    same(got, jvec.parse_entries_np(raw))


def test_load_entries_takes_the_native_parser(tmp_path, monkeypatch):
    raw = records(5, 300)
    path = tmp_path / "x.dat"
    path.write_bytes(raw)
    called = []
    monkeypatch.setattr(tn, "parse_entries", lambda r: called.append(1) or jn.parse_entries(r))
    got = tvec.load_entries(path)
    assert called
    same(got, jvec.load_entries(path))
    monkeypatch.setattr(tn, "available", lambda: False)
    same(tvec.load_entries(path), got)
    path.write_bytes(raw[:-1])
    with pytest.raises(ValueError, match="multiple of 12"):
        tvec.load_entries(path)


def test_entries_to_grid_matches_jax_and_numpy():
    raw = records(9, 500)
    got = tn.entries_to_grid(raw, 48, 14, 3)
    same(got, jn.entries_to_grid(raw, 48, 14, 3))
    same(got, tvec.entries_to_grid(tvec.parse_entries_np(raw), 48, 14, 3))
    bad = records(9, 500, outside=4)
    for loader in (tn, jn):
        with pytest.raises(ValueError, match="4 records outside"):
            loader.entries_to_grid(bad, 48, 14, 3)


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_ri_conversions_match_jax_and_numpy(n_threads):
    rng = np.random.default_rng(n_threads)
    x = (rng.standard_normal((7, 5, 14, 2)) + 1j * rng.standard_normal((7, 5, 14, 2)))
    x = x.astype(np.complex64)
    ri = tn.complex_to_ri(x)
    same(ri, jn.complex_to_ri(x))
    same(ri, np.stack([est.split_ri(a) for a in x]))
    back = tn.ri_to_complex(ri, n_threads=n_threads)
    same(back, jn.ri_to_complex(ri, n_threads=n_threads))
    same(back, x)
    arrays = [np.ascontiguousarray(a) for a in x.astype(np.complex128)]  # complex128 in
    packed = tn.assemble_batch_ri(arrays, n_threads=n_threads)
    same(packed, jn.assemble_batch_ri(arrays, n_threads=n_threads))
    same(packed, np.stack([est.split_ri(a.astype(np.complex64)) for a in arrays]))
    out = np.full(packed.shape, np.nan, np.float32)
    assert tn.assemble_batch_ri(arrays, n_threads=n_threads, out=out) is out
    same(out, packed)


def test_assemble_refuses_what_it_cannot_pack():
    a = np.zeros((3, 4), np.complex64)
    with pytest.raises(ValueError):
        tn.assemble_batch_ri([a, np.zeros((3, 5), np.complex64)])
    with pytest.raises(ValueError):
        tn.assemble_batch_ri([])
    with pytest.raises(ValueError):
        tn.assemble_batch_ri([a], out=np.zeros((1, 2, 3, 4), np.float64))


def test_packs_and_merges_are_counted():
    a = [np.ones((2, 3), np.complex64)] * 4
    p0, m0 = tn.packs, tn.merges
    tn.ri_to_complex(tn.assemble_batch_ri(a))
    tn.complex_to_ri(np.stack(a))
    assert (tn.packs - p0, tn.merges - m0) == (1, 1)


def test_failed_build_warns_once_and_serving_takes_numpy(monkeypatch, tmp_path):
    bad = tmp_path / "vector_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tn, "_SRC", bad)
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_error", None)
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "_build")
    with pytest.warns(RuntimeWarning, match="using numpy"):
        assert not tn.available()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not tn.available()  # reported once
        arrays = [np.full((2, 3), 1 + 2j, np.complex64)] * 2
        packed = ts._assemble(arrays)
        assert np.array_equal(packed[:, 0], np.ones((2, 2, 3))) and np.array_equal(
            ts._merge_batch(packed), np.stack(arrays))


def _problems(mod, cases):
    return [mod.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                        float(c.beta), c.hop1, c.hop2, c.config) for c in cases]


@pytest.mark.parametrize("out", ["grid", "factored"])
def test_process_native_matches_numpy_branch_and_jax(out, monkeypatch):
    """Six problems of two signatures, batch 4 (a padded tail): the native
    branch bit-identical to the numpy branch, both within
    tests/test_torch_serving.py's bars of the JAX package's process."""
    cases = [jsyn.make_case(seed=60 + i, snr_db=30.0, n_prbs=12, n_layers=1 + i % 2)
             for i in range(6)]
    p0, m0 = tn.packs, tn.merges
    got = ts.process(_problems(ts, cases), batch_size=4, out=out, device="cpu")
    assert tn.packs - p0 == 2 * 2 and tn.merges - m0 >= 2  # rg and pilots a chunk; merges
    monkeypatch.setattr(tn, "available", lambda: False)
    ref = ts.process(_problems(ts, cases), batch_size=4, out=out, device="cpu")
    want = js.process(_problems(js, cases), batch_size=4, out=out)
    fields = ("channel_est_rg",) if out == "grid" else ("profiles", "sym_rot")
    for g, r, w in zip(got, ref, want):
        for f in fields + ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
            assert np.array_equal(getattr(g, f), getattr(r, f)), f
        for f in fields:
            a, b = getattr(g, f), getattr(w, f)
            assert np.abs(a - b).max() / np.abs(b).max() <= 1e-5, f
        np.testing.assert_allclose(g.noise_est, w.noise_est, rtol=1e-4)
