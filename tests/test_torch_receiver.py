"""The port's receiver chain against the JAX package's, on the CPU.

`srsran_ce_tpu_torch.ops.equalize`, `ops.demap`, `utils.synthetic.make_mimo_case`
and `models.receiver` against their JAX counterparts, with inputs made from
numpy seeds and fed to both sides, in float64 (the JAX side under x64):

- MMSE equalization, dense and factored, the closed-form inverses for nL 1-4
  and the general inverse for nL = 5: relative 1e-10 (max-abs error over
  max-abs value; the same elementwise arithmetic, the sums over <= 5 terms
  may associate differently);
- LLRs of all six modulations, `llrs` and `llr_planes`: relative 1e-9;
  `constellation`, `modulate` and `descramble_llrs` identical;
- `make_mimo_case`: every array and field bit-identical;
- `build_receiver_ri` (batched, two problems) in both modes, with and without
  the demapper, one and two hops, kernels "xla" and "pallas" (whose plain
  versions run here): x, SINR and the scalars relative 1e-9, the int8 LLR
  planes identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

from srsran_ce_tpu.models import estimator as jest
from srsran_ce_tpu.models import receiver as jrcv
from srsran_ce_tpu.ops import demap as jdemap
from srsran_ce_tpu.ops import equalize as jeq
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu_torch.models import estimator as port_est
from srsran_ce_tpu_torch.models import receiver as trcv
from srsran_ce_tpu_torch.ops import demap, equalize
from srsran_ce_tpu_torch.utils import synthetic as tsyn


def rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def crandn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("nL", [1, 2, 3, 4, 5])
def test_mmse_equalize_dense_matches_jax(nL):
    rng = np.random.default_rng(nL)
    n_rx, n_sc, n_sym = max(nL, 2), 24, 14
    y = crandn(rng, (n_rx, n_sc, n_sym))
    h = crandn(rng, (n_rx, n_sc, n_sym, nL))
    noise = 0.05
    xj, sj = jeq.mmse_equalize(y, h, noise, beta=1.3)
    xt, st = equalize.mmse_equalize(t(y), t(h), noise, beta=1.3)
    assert rel(xt, xj) <= 1e-10 and rel(st, sj) <= 1e-10
    # the serve layout with two batch axes equals the single problems
    ys = np.stack([y, 2.0 * y])  # (2, n_rx, n_sc, n_sym)
    hs = np.stack([h, h[::-1]])
    noises = np.array([noise, 0.2])
    xb, sb = equalize.mmse_equalize_serve(
        t(ys).permute(1, 0, 3, 2), t(hs).permute(1, 4, 0, 3, 2), t(noises)[:, None, None], beta=1.3
    )
    for b in range(2):
        xj, sj = jeq.mmse_equalize_serve(
            np.moveaxis(ys[b], -2, -1), np.transpose(hs[b], (0, 3, 2, 1)), noises[b], beta=1.3
        )
        assert rel(xb[:, b], xj) <= 1e-10 and rel(sb[:, b], sj) <= 1e-10


@pytest.mark.parametrize("nL", [1, 2, 3, 4, 5])
def test_mmse_equalize_factored_matches_jax(nL):
    rng = np.random.default_rng(10 + nL)
    n_rx, n_sc, n_sym = max(nL, 3), 36, 14
    y = crandn(rng, (n_rx, n_sym, n_sc))
    prof = crandn(rng, (n_rx, nL, n_sc))
    rot = np.exp(1j * rng.uniform(-np.pi, np.pi, (n_rx, n_sym)))
    xj, sj = jeq.mmse_equalize_factored_serve(y, prof, rot, 0.07, 7, 7, beta=0.9)
    xt, st = equalize.mmse_equalize_factored_serve(t(y), t(prof), t(rot), 0.07, 7, 7, beta=0.9)
    assert xt.shape == (nL, 7, n_sc) and st.shape == (nL, n_sc)
    assert rel(xt, xj) <= 1e-10 and rel(st, sj) <= 1e-10
    y_ref = np.moveaxis(y, -1, -2)  # (n_rx, n_sc, n_sym), one shared rotation
    xj, sj = jeq.mmse_equalize_factored(y_ref, prof, rot[0], 0.07, 0, 7)
    xt, st = equalize.mmse_equalize_factored(t(y_ref), t(prof), t(rot[0]), 0.07, 0, 7)
    assert rel(xt, xj) <= 1e-10 and rel(st, sj) <= 1e-10


@pytest.mark.parametrize("modulation", demap.MODULATIONS)
def test_llrs_match_jax(modulation):
    rng = np.random.default_rng(len(modulation))
    x = 0.8 * crandn(rng, (3, 5, 40))
    sinr = rng.uniform(0.0, 40.0, (3, 5, 40))
    sinr[0, 0, :5] = 0.0  # erasures
    want = np.asarray(jdemap.llrs(x, sinr, modulation))
    got = demap.llrs(t(x), t(sinr), modulation).numpy()
    assert got.shape == x.shape + (demap.bits_per_symbol(modulation),)
    assert rel(got, want) <= 1e-9
    assert np.all(got[0, 0, :5] == 0.0)
    planes = demap.llr_planes(t(x), t(sinr[:, :1]), modulation).numpy()
    assert rel(planes, np.asarray(jdemap.llr_planes(x, sinr[:, :1], modulation))) <= 1e-9
    assert np.array_equal(demap.constellation(modulation), jdemap.constellation(modulation))
    nb = demap.bits_per_symbol(modulation)
    bits = rng.integers(0, 2, (4, 6 * nb))
    assert np.array_equal(demap.modulate(bits, modulation), jdemap.modulate(bits, modulation))


def test_demap_tables_and_descramble_match_jax():
    for m in (1, 2, 3, 4, 5):
        for a, b in zip(demap._pam_table(m), jdemap._pam_table(m)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="modulation"):
        demap.bits_per_symbol("8psk")
    rng = np.random.default_rng(3)
    c = rng.integers(0, 2, (6, 14, 2, 4)).astype(np.uint8)
    l8 = rng.integers(-127, 128, c.shape).astype(np.int8)
    lf = rng.standard_normal(c.shape).astype(np.float32)
    for llr in (l8, lf):
        want = jdemap.descramble_llrs(llr, c)
        got = demap.descramble_llrs(llr, c)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        got_t = demap.descramble_llrs(t(llr), c)
        assert got_t.dtype == t(llr).dtype and np.array_equal(got_t.numpy(), want)


def _same(a, b, path="case"):
    """Bit-identity of two values built by the two packages."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


@pytest.mark.parametrize(
    "kw",
    [dict(n_rx=2, modulation="16qam", n_prbs=12, n_layers=2),
     dict(n_rx=3, modulation="qpsk", scramble=False, n_prbs=8, n_layers=1, two_hops=True,
          noise_seed=0),
     dict(n_rx=1, modulation="256qam", n_prbs=6, n_layers=3, snr_db=12.0, cfo_hz=0.0,
          time_interp="linear")],
    ids=["16qam_2rx", "qpsk_3rx_hops_unscrambled", "256qam_1rx_ti"],
)
def test_make_mimo_case_identical(kw):
    _same(tsyn.make_mimo_case(seed=41, **kw), jsyn.make_mimo_case(seed=41, **kw))
    bits = np.random.default_rng(0).integers(
        0, 2, tsyn.make_mimo_case(seed=41, **kw).bits.shape, dtype=np.uint8
    )
    _same(tsyn.make_mimo_case(seed=41, bits=bits, **kw), jsyn.make_mimo_case(seed=41, bits=bits, **kw))


RECEIVER_CASES = [
    # name, make_mimo_case geometry, n_rx, mode, modulation
    ("factored_1hop", dict(n_prbs=12, n_layers=2), 2, "auto", None),
    ("dense_2hops_16qam", dict(n_prbs=8, n_layers=2, two_hops=True), 2, "dense", "16qam"),
    ("factored_2hops_qpsk", dict(n_prbs=8, n_layers=1, two_hops=True), 3, "auto", "qpsk"),
    ("dense_time_interp_256qam", dict(n_prbs=6, n_layers=4, time_interp="linear",
                                      doppler_hz=200.0), 4, "auto", "256qam"),
]


def _receiver_inputs(kw, n_rx):
    cases = [jsyn.make_mimo_case(seed=s, n_rx=n_rx, modulation="16qam", snr_db=25.0, **kw)
             for s in (61, 62)]
    rg = np.stack([jest.split_ri(c.received_rg) for c in cases])
    pil = np.stack([jest.split_ri(c.pilots) for c in cases])
    beta = np.array([1.0, 1.25])
    return cases[0], rg, pil, beta


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
@pytest.mark.parametrize("name,kw,n_rx,mode,modulation", RECEIVER_CASES,
                         ids=[c[0] for c in RECEIVER_CASES])
def test_receiver_matches_jax_f64(name, kw, n_rx, mode, modulation, kernels):
    c, rg, pil, beta = _receiver_inputs(kw, n_rx)
    nL = c.pilots.shape[2]
    args = (c.hop1, c.hop2, c.config, nL, n_rx)
    kw_b = dict(batched=True, mode=mode, data_beta=1.1, kernels=kernels, modulation=modulation,
                llr_scale=4.0)
    want = jrcv.build_receiver_ri(*args, **kw_b)(rg, pil, beta)
    got = trcv.build_receiver_ri(*args, device="cpu", **kw_b)(t(rg), t(pil), t(beta))
    if modulation is None:
        assert isinstance(got, trcv.ReceiverResult)
        assert got.x.shape == np.asarray(want.x).shape
        assert rel(got.x, want.x) <= 1e-9
    else:
        assert isinstance(got, trcv.LlrResult) and len(got.llr) == len(want.llr)
        for p, q in zip(got.llr, want.llr):
            assert p.dtype == torch.int8 and np.array_equal(p.numpy(), np.asarray(q))
    assert got.sinr.shape == np.asarray(want.sinr).shape
    assert rel(got.sinr, want.sinr) <= 1e-9
    for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        assert rel(getattr(got, f), getattr(want, f)) <= 1e-9, f


def test_receiver_single_problem_and_numpy_inputs():
    """batched=False drops the problem axis; numpy inputs go to the device
    device; the result equals the batched call's first problem (the LLRs bit
    for bit, the noise to 1e-12: the batch's sums may associate apart)."""
    c, rg, pil, beta = _receiver_inputs(dict(n_prbs=8, n_layers=2), 2)
    args = (c.hop1, c.hop2, c.config, 2, 2)
    one = trcv.build_receiver_ri(*args, modulation="64qam", device="cpu")(rg[0], pil[0], beta[0])
    both = trcv.build_receiver_ri(*args, batched=True, modulation="64qam", device="cpu")(
        t(rg), t(pil), t(beta))
    assert one.llr[0].shape == both.llr[0].shape[1:]
    for p, q in zip(one.llr, both.llr):
        assert torch.equal(p, q[0])
    assert rel(one.noise_est, both.noise_est[0]) <= 1e-12


def test_receiver_qpsk_link_is_error_free():
    """The chain end to end on a 30 dB QPSK link (2 RX x 2 layers, scrambled):
    descrambled hard decisions equal the transmitted bits on every scored RE."""
    case = tsyn.make_mimo_case(seed=7, n_rx=2, modulation="qpsk", snr_db=30.0, n_prbs=12,
                               n_layers=2)
    fn = trcv.build_receiver_ri(case.hop1, case.hop2, case.config, 2, 2, modulation="qpsk",
                                device="cpu")
    res = fn(port_est.split_ri(case.received_rg), port_est.split_ri(case.pilots), case.beta)
    llr = np.stack([p.numpy() for p in res.llr], axis=-1)  # (nL, n_sym, n_sc, nbits)
    llr = demap.descramble_llrs(np.transpose(llr, (2, 1, 0, 3)), case.scramble_c)
    hard = (llr < 0).astype(np.uint8)
    assert np.array_equal(hard[case.data_mask], case.bits[case.data_mask])


def test_receiver_build_refusals():
    c = tsyn.make_case(seed=1, n_prbs=4)
    args = (c.hop1, c.hop2, c.config, 1, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trcv.build_receiver_ri(*args)
    with pytest.raises(ValueError, match="kernels"):
        trcv.build_receiver_ri(*args, kernels="pallas_front", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        trcv.build_receiver_ri(*args, mode="both", device="cpu")
    with pytest.raises(ValueError, match="modulation"):
        trcv.build_receiver_ri(*args, modulation="8psk", device="cpu")
    ti = tsyn.make_case(seed=1, n_prbs=4, time_interp="linear")
    with pytest.raises(ValueError, match="time_interp"):
        trcv.build_receiver_ri(ti.hop1, ti.hop2, ti.config, 1, 2, mode="factored", device="cpu")
    # learned smoothing builds and needs the denoiser's params at the call;
    # the tracked receiver refuses time interpolation, as in JAX
    learned = dataclasses.replace(c.config, smoothing="learned")
    fn_l = trcv.build_receiver_ri(c.hop1, c.hop2, learned, 1, 2, device="cpu")
    rg2 = np.stack([port_est.split_ri(c.received_rg)] * 2, axis=1)
    with pytest.raises(ValueError, match="needs denoiser params"):
        fn_l(rg2, port_est.split_ri(c.pilots), 1.0)
    with pytest.raises(ValueError, match="time_interp"):
        trcv.build_tracked_receiver_ri(ti.hop1, ti.hop2, ti.config, 1, 2, device="cpu")
    fn = trcv.build_receiver_ri(*args, device="cpu")
    rg = np.zeros((2, 3) + c.received_rg.shape)
    with pytest.raises(ValueError, match="n_rx=2"):
        fn(rg, port_est.split_ri(c.pilots), 1.0)
