"""The port's `serving.process` against the JAX package's, on the CPU.

The same problems (numpy seeds, complex64 grids) go through
`srsran_ce_tpu.serving.process` and `srsran_ce_tpu_torch.serving.process(...,
device="cpu")`, both in float32, and every output is compared:

- "grid" and "factored": the grids within relative 1e-5 (max-abs error over
  max-abs value: two float32 programs that associate their sums apart), the
  scalars within rtol 1e-4 (atol 1e-6 for the CFO in Hz and 1e-12 for the TA
  in seconds);
- "equalized" and "llrs": the symbols within NMSE 1e-7 and the SINR within
  relative 1e-4. The MMSE inverse multiplies the grids' float32 differences
  by the channel's condition number (up to |H|^2 / sigma^2, ~1e3 at 30 dB on
  these 2 x 2 links): measured symbol NMSE up to 2e-8 and SINR relative up to
  4e-5. NMSE 1e-7 is the JAX package's own bar between two of its float32
  programs (tests/test_serving.py:322);
- "llrs": int8 LLRs within one quantization step, on at most 0.1 % of the
  entries (a float32 value on a rounding boundary may round either way);
- "decoded", on the host path and with `decode_on_device=True`: `info` and
  `ok` identical to the JAX package's and payload-exact, with small codes
  (an array code, NR BG2 at Z=32 with TS 38.212 rate matching), scrambled and
  not, CRC-gated, per-problem codings and the two-phase early-termination
  retry.
`process(params=...)` (learned smoothing) is compared in
tests/test_torch_denoiser.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from srsran_ce_tpu import serving as js
from srsran_ce_tpu import transport as jtr
from srsran_ce_tpu.ops import ldpc as jl
from srsran_ce_tpu.ops import nr_ldpc as jnr
from srsran_ce_tpu.ops import sequences as jseq
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu_torch import serving as ts
from srsran_ce_tpu_torch import transport as ttr
from srsran_ce_tpu_torch.models import receiver as trcv
from srsran_ce_tpu_torch.ops import ldpc as tl
from srsran_ce_tpu_torch.ops import nr_ldpc as tnr

SCALARS = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")


def rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def nmse(a, b):
    return float(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2))


def problems(mod, cases, rgs=None):
    rgs = rgs or [c.received_rg for c in cases]
    return [mod.Problem(rg.astype(np.complex64), c.pilots.astype(np.complex64), float(c.beta),
                        c.hop1, c.hop2, c.config) for c, rg in zip(cases, rgs)]


def check_scalars(got, want):
    for f in SCALARS:
        atol = {"cfo_hz": 1e-6, "time_alignment": 1e-12}.get(f, 0.0)
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-4, atol=atol,
                                   err_msg=f)


def run_both(cases, rgs=None, **kw):
    """(JAX results, port results) of one process call over `cases`."""
    order = np.random.default_rng(len(cases)).permutation(len(cases))
    cases = [cases[i] for i in order]
    rgs = None if rgs is None else [rgs[i] for i in order]
    want = js.process(problems(js, cases, rgs), **kw)
    got = ts.process(problems(ts, cases, rgs), device="cpu", **kw)
    assert len(got) == len(want) == len(cases)
    return want, got


def test_grid_and_factored_match_jax():
    """A shuffled mix of plan signatures (time interpolation, wiener + WLS CFO,
    two hops), batch 4 with tail padding, in submission order."""
    specs = [
        dict(n_prbs=24, n_layers=1),
        dict(n_prbs=24, n_layers=2, smoothing="wiener", cfo_estimator="wls"),
        dict(n_prbs=12, n_layers=1, two_hops=True),
        dict(n_prbs=24, n_layers=1, time_interp="linear", doppler_hz=250.0),
    ]
    cases = [jsyn.make_case(seed=37 + 10 * j + i, snr_db=30.0, **sp)
             for j, sp in enumerate(specs) for i in range(3 if j < 2 else 2)]
    want, got = run_both(cases, batch_size=4, matmul_precision=None)
    for g, w in zip(got, want):
        assert isinstance(g, ts.ServeResult) and g.channel_est_rg.dtype == np.complex64
        assert rel(g.channel_est_rg, w.channel_est_rg) <= 1e-5
        check_scalars(g, w)
    static = [c for c in cases if c.config.time_interp == "none"]
    want, got = run_both(static, batch_size=2, out="factored")
    for g, w in zip(got, want):
        assert isinstance(g, ts.FactoredServeResult)
        assert rel(g.profiles, w.profiles) <= 1e-5 and rel(g.sym_rot, w.sym_rot) <= 1e-5
        assert rel(g.dense(), w.dense()) <= 1e-5
        check_scalars(g, w)


def test_auto_delay_and_doppler_passes_match_jax():
    """The host probes are numpy copies (equal floats), and the problems they
    re-bucket serve as in the JAX package."""
    cases = [jsyn.make_case(seed=20 + i, n_prbs=52, n_layers=1, n_taps=1, snr_db=20.0,
                            smoothing="wiener") for i in range(2)]
    cases += [jsyn.make_case(seed=5, n_prbs=24, n_layers=1, snr_db=30.0, doppler_hz=600.0),
              jsyn.make_case(seed=4, n_prbs=24, n_layers=1, snr_db=30.0, cfo_hz=0.0)]
    for pj, pt in zip(problems(js, cases), problems(ts, cases)):
        assert ts.estimate_delay_spread(pt) == js.estimate_delay_spread(pj)
        assert ts.estimate_doppler(pt) == js.estimate_doppler(pj)
    grid = (5e-8, 2.5e-7, 1e-6)
    want, got = run_both(cases, batch_size=2, matmul_precision=None, wiener_auto_delay=grid,
                         auto_time_interp_hz=100.0)
    for g, w in zip(got, want):
        assert rel(g.channel_est_rg, w.channel_est_rg) <= 1e-5
        check_scalars(g, w)


def _receiver_stream(specs, seed0, n_each):
    cases, rgs = [], []
    for j, sp in enumerate(specs):
        for i in range(n_each):
            seed = seed0 + 10 * j + i
            ports = [jsyn.make_case(seed=seed, noise_seed=500 + r, snr_db=30.0, **sp["kw"])
                     for r in range(sp["n_rx"])]
            cases.append(ports[0])
            rg = np.stack([p.received_rg for p in ports])
            rgs.append(rg[0] if sp["n_rx"] == 1 and j == 0 else rg)  # 2-D and 3-D forms
    return cases, rgs


def test_equalized_matches_jax():
    """out="equalized" over single- and 2-RX problems, dense (time-interpolated)
    and factored buckets, two hops, data_beta."""
    specs = [
        dict(n_rx=1, kw=dict(n_prbs=24, n_layers=1)),
        dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2)),
        dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2, time_interp="linear")),
        dict(n_rx=2, kw=dict(n_prbs=12, n_layers=1, two_hops=True)),
    ]
    cases, rgs = _receiver_stream(specs, 300, 3)
    want, got = run_both(cases, rgs, batch_size=4, matmul_precision=None, out="equalized",
                         data_beta=1.1)
    for g, w in zip(got, want):
        assert isinstance(g, ts.EqualizedServeResult) and g.x.shape == w.x.shape
        assert nmse(g.x, w.x) <= 1e-7 and rel(g.sinr, w.sinr) <= 1e-4
        check_scalars(g, w)


def test_llrs_match_jax():
    specs = [
        dict(n_rx=1, kw=dict(n_prbs=24, n_layers=1)),
        dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2, time_interp="linear")),
        dict(n_rx=2, kw=dict(n_prbs=12, n_layers=1, two_hops=True)),
    ]
    cases, rgs = _receiver_stream(specs, 700, 2)
    want, got = run_both(cases, rgs, batch_size=4, matmul_precision="high", out="llrs",
                         modulation="16qam", llr_scale=8.0)
    n_off = n_all = 0
    for g, w in zip(got, want):
        assert isinstance(g, ts.LlrServeResult) and g.llr.dtype == np.int8
        assert g.llr.shape == w.llr.shape
        d = np.abs(g.llr.astype(np.int64) - w.llr.astype(np.int64))
        assert d.max() <= 1
        n_off += int((d > 0).sum())
        n_all += d.size
        assert rel(g.sinr, w.sinr) <= 1e-4
        check_scalars(g, w)
        np.testing.assert_array_equal(g.llrs_float(), g.llr / 8.0)
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def _coded_case(code_j, code_t, coding_kw, seed, mk, snr_db, n_filler=0):
    """(JAX coding, port coding, JAX case, payload) of a link carrying encoded words."""
    cj = jtr.TransportCoding(code=code_j, **coding_kw)
    ct = ttr.TransportCoding(code=code_t, **coding_kw)
    nbits = {"qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8}[mk["modulation"]]
    geo = jsyn.make_mimo_case(seed=seed, snr_db=snr_db, **mk)
    n_sc, n_sym = geo.data_mask.shape
    nL = geo.pilots.shape[2]
    lay = jtr.layout(cj, geo.hop1, geo.hop2, n_sc, n_sym, nL, nbits)
    plan = jl.make_ldpc_plan(code_j)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (lay.c_words, jtr.payload_bits(cj, plan.k)), dtype=np.uint8)
    words = jtr.crc_attach(u, cj.crc) if cj.crc else u
    words = np.concatenate([words, np.zeros((lay.c_words, n_filler), np.uint8)], axis=1)
    bits = jtr.place_codewords(lay, jl.encode(code_j, words), nL, nbits, fill_rng=rng)
    case = jsyn.make_mimo_case(seed=seed, snr_db=snr_db, bits=bits, **mk)
    return cj, ct, case, u


def _decoded_both(cases, cj, ct, modulation, batch_size=2, **kw):
    """JAX host, JAX device, port host, port device results of one stream."""
    kwj = dict(batch_size=batch_size, out="decoded", modulation=modulation,
               matmul_precision=None, **kw)
    pj, pt = problems(js, cases), problems(ts, cases)
    return (js.process(pj, coding=cj, **kwj), js.process(pj, coding=cj, decode_on_device=True, **kwj),
            ts.process(pt, coding=ct, device="cpu", **kwj),
            ts.process(pt, coding=ct, decode_on_device=True, device="cpu", **kwj))


@pytest.mark.parametrize("scramble", [False, True])
def test_decoded_host_and_device_match_jax(scramble):
    """An array code (n = 976) on a 16QAM 2 x 2 link, CRC16-gated."""
    seed = 5100
    c_init = jseq.pusch_scrambling_c_init(0x4601, seed % 1024, q=0)
    coding_kw = dict(n_iters=30, interleave_seed=77, scramble_c_init=c_init if scramble else None,
                     crc="crc16", early_iters=None)
    mk = dict(n_rx=2, modulation="16qam", scramble=scramble, n_prbs=12, n_layers=2)
    cj, ct, case, u = _coded_case(jl.array_code(8, 16, 61), tl.array_code(8, 16, 61),
                                  coding_kw, seed, mk, 20.0)
    jh, jd, th, td = _decoded_both([case, case, case], cj, ct, "16qam")
    for a, b, c, d in zip(jh, jd, th, td):
        assert c.soft is not None and d.soft is None
        for r in (c, d):
            assert np.array_equal(r.info, u) and bool(np.all(r.ok))
        assert np.array_equal(c.info, a.info) and np.array_equal(c.ok, a.ok)
        assert np.array_equal(d.info, b.info) and np.array_equal(d.ok, b.ok)
        check_scalars(d, b)
        check_scalars(c.soft, a.soft)


@pytest.mark.parametrize("tx_bits", [None, 2400])
def test_decoded_nr_rate_match_matches_jax(tx_bits):
    """NR BG2 at Z=32 with TS 38.212 rate matching: punctured head (erasures),
    16 fillers pinned, and with tx_bits=2400 repeats soft-combined and
    re-clipped to the int8 range; scrambled, CRC11."""
    rnti, seed = 0x3344, 4242
    coding_kw = dict(rate_match="nr", n_filler=16, crc="crc11", n_iters=20, early_iters=None,
                     scramble_c_init=jseq.pusch_scrambling_c_init(rnti, seed % 1024),
                     tx_bits=tx_bits)
    mk = dict(n_rx=2, modulation="qpsk", scramble=True, rnti=rnti, n_prbs=24, n_layers=1)
    cj, ct, case, u = _coded_case(jnr.nr_base_graph(2, 32), tnr.nr_base_graph(2, 32),
                                  coding_kw, seed, mk, 22.0, n_filler=16)
    jh, jd, th, td = _decoded_both([case], cj, ct, "qpsk", batch_size=4)
    for a, b, c, d in zip(jh, jd, th, td):
        for r in (c, d):
            assert np.array_equal(r.info, u) and bool(np.all(r.ok))
        assert np.array_equal(c.info, a.info) and np.array_equal(d.info, b.info)
        assert np.array_equal(c.ok, a.ok) and np.array_equal(d.ok, b.ok)


@pytest.mark.parametrize("on_device", [False, True])
def test_decoded_two_layer_256qam_nr_bg1_matches_jax(on_device):
    """The 2-layer 256QAM uplink of `cebench`'s `pusch_n78_100mhz_4rx_2l256`
    at a CPU's size: 4 rx, 2 layers on DM-RS ports 0-1, 12 PRB, an NR BG1
    code at Z=32 (K' 672, 32 fillers, E 1152, a multiple of 2 layers x 8
    bits), layered sweeps, scrambled, CRC24B; the host and the device decode
    paths each against the JAX package's, payload-exact."""
    rnti, seed = 0x4601, 5230
    code_j, code_t = jnr.nr_base_graph(1, 32), tnr.nr_base_graph(1, 32)
    coding_kw = dict(rate_match="nr", n_filler=32, crc="crc24b", tx_bits=1152, n_iters=16,
                     schedule="layered", interleave_seed=7, early_iters=None,
                     scramble_c_init=jseq.pusch_scrambling_c_init(rnti, seed % 1024, q=0))
    mk = dict(n_rx=4, modulation="256qam", scramble=True, rnti=rnti, n_prbs=12, n_layers=2)
    cj, ct, case, u = _coded_case(code_j, code_t, coding_kw, seed, mk, 30.0, n_filler=32)
    assert u.shape[0] >= 8
    kw = dict(batch_size=2, out="decoded", modulation="256qam", matmul_precision=None,
              decode_on_device=on_device)
    want = js.process(problems(js, [case] * 2), coding=cj, **kw)
    got = ts.process(problems(ts, [case] * 2), coding=ct, device="cpu", **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.info, u) and bool(np.all(g.ok))
        assert np.array_equal(g.info, w.info) and np.array_equal(g.ok, w.ok)
        check_scalars(g if on_device else g.soft, w if on_device else w.soft)


def test_decoded_early_termination_and_per_problem_codings_match_jax():
    """The host path's two-phase retry (early_iters=2 of 30 sweeps: most words
    fail the first phase at 12 dB and rerun) and a per-problem coding list
    (two interleavers)."""
    code_j, code_t = jl.array_code(8, 16, 61), tl.array_code(8, 16, 61)
    mk = dict(n_rx=1, modulation="qpsk", scramble=False, n_prbs=12, n_layers=1)
    links = [_coded_case(code_j, code_t, dict(n_iters=30, interleave_seed=s, early_iters=2),
                         51 + s, mk, 12.0) for s in (3, 4)]
    cases = [lk[2] for lk in links]
    kw = dict(batch_size=2, out="decoded", modulation="qpsk", matmul_precision=None)
    want = js.process(problems(js, cases), coding=[lk[0] for lk in links], **kw)
    got = ts.process(problems(ts, cases), coding=[lk[1] for lk in links], device="cpu", **kw)
    for g, w, lk in zip(got, want, links):
        assert np.array_equal(g.info, w.info) and np.array_equal(g.ok, w.ok)
        assert np.array_equal(g.info, lk[3]) and bool(np.all(g.ok))


def _same_up_to_chunking(a, b):
    """One result against the same problem's at another chunking: float
    arrays and scalars within relative 1e-6 (batch sums may associate
    apart), int8 LLRs within one step, decoded bits and flags exactly."""
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("info", "ok"):
            assert np.array_equal(x, y), f.name
        elif f.name == "llr":
            assert np.abs(x.astype(np.int16) - y.astype(np.int16)).max() <= 1
        elif f.name == "soft":
            assert (x is None) == (y is None)
            if x is not None:
                _same_up_to_chunking(x, y)
        elif isinstance(x, (np.ndarray, float)):
            assert rel(y, x) <= 1e-6, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("out", ["grid", "factored", "equalized", "llrs", "decoded",
                                 "decoded_on_device"])
def test_inflight_and_batch_size_do_not_change_results(out):
    """Every out runs one serve loop: (batch_size, inflight) in {(2, 1), (2, 4),
    (8, 2)} change the chunks, the tail padding and the chunks kept pending
    across two buckets, not the results."""
    if out in ("grid", "factored"):
        cases = [jsyn.make_case(seed=500 + i, snr_db=25.0, n_prbs=12, n_layers=(1, 2)[i % 2])
                 for i in range(5)]
        kw = dict(out=out)
    else:
        coding_kw = dict(n_iters=8, interleave_seed=7, crc="crc16", early_iters=None)
        links = [_coded_case(jl.array_code(8, 16, 61), tl.array_code(8, 16, 61), coding_kw,
                             520 + i, dict(n_rx=(2, 1)[i % 2], modulation="qpsk", scramble=False,
                                           n_prbs=12, n_layers=1), 20.0) for i in range(5)]
        cases = [lk[2] for lk in links]
        kw = dict(out=out.split("_")[0], modulation="qpsk", coding=links[0][1],
                  decode_on_device=out == "decoded_on_device")
    base = ts.process(problems(ts, cases), batch_size=2, inflight=1, device="cpu", **kw)
    if out.startswith("decoded"):
        assert all(np.array_equal(r.info, lk[3]) and r.ok.all() for r, lk in zip(base, links))
    for chunking in (dict(batch_size=2, inflight=4), dict(batch_size=8, inflight=2)):
        got = ts.process(problems(ts, cases), device="cpu", **chunking, **kw)
        assert len(got) == len(base)
        for a, b in zip(base, got):
            _same_up_to_chunking(a, b)


def test_tail_padding_shares_one_receiver_per_signature():
    """Five problems of one signature at batch 2: three chunks (the last padded)
    through one receiver (one cache entry)."""
    cases = [jsyn.make_mimo_case(seed=100 + i, n_rx=2, n_prbs=8, n_layers=1) for i in range(5)]
    trcv._build_receiver_cached.cache_clear()
    res = ts.process(problems(ts, cases), batch_size=2, out="equalized", device="cpu")
    info = trcv._build_receiver_cached.cache_info()
    assert (info.misses, info.currsize) == (1, 1) and len(res) == 5


def test_process_refusals():
    c = jsyn.make_case(seed=3, n_prbs=12)
    p = problems(ts, [c])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.process(p)
    with pytest.raises(ValueError, match="out must be"):
        ts.process(p, out="symbols", device="cpu")
    with pytest.raises(ValueError, match="modulation"):
        ts.process(p, out="llrs", device="cpu")
    with pytest.raises(ValueError, match="coding"):
        ts.process(p, out="decoded", modulation="qpsk", device="cpu")
    coding = ttr.TransportCoding(code=tl.array_code(2, 6, 11))
    with pytest.raises(ValueError, match="single shared coding"):
        ts.process(p, out="decoded", modulation="qpsk", coding=[coding], decode_on_device=True,
                   device="cpu")
    with pytest.raises(ValueError, match="coding list length"):
        ts.process(p, out="decoded", modulation="qpsk", coding=[coding, coding], device="cpu")
    multi = ts.Problem(np.stack([c.received_rg] * 2).astype(np.complex64),
                       c.pilots.astype(np.complex64), 1.0, c.hop1, c.hop2, c.config)
    with pytest.raises(ValueError, match="equalized"):
        ts.process([multi], device="cpu")
    ti = dataclasses.replace(p[0], config=dataclasses.replace(c.config, time_interp="linear"))
    with pytest.raises(ValueError, match="time_interp"):
        ts.process([ti], out="factored", device="cpu")
    with pytest.raises(ValueError, match="auto_time_interp_hz"):
        ts.process(p, out="factored", auto_time_interp_hz=100.0, device="cpu")
