"""The port's multi-slot tracking against the JAX package's, on the CPU.

`srsran_ce_tpu_torch.models.tracking.build_tracked_ri`,
`models.receiver.build_tracked_receiver_ri` and `serving.TrackedServer`
against their JAX counterparts on the same numpy-made soundings:

- the tracked estimator in float64 over 5-slot sequences (a static channel
  re-sounded with fresh noise, then a different channel, which snaps the gain
  back toward 1), in the ref, serve and factored layouts, for filter, wiener
  and none smoothing, 1 and 2 layers, one and two hops: grids, the threaded
  state and w within relative 1e-12 (max-abs error over max-abs value);
- the tracked receiver in float64, with and without the demapper: symbols,
  SINR, state and w within relative 1e-12, int8 LLRs identical;
- TrackedServer in float32 (both packages pack complex64 batches): grids
  within relative 1e-5 and scalars within rtol 1e-4 (tests/test_torch_serving.py's
  float32 bars), symbols within NMSE 1e-7, int8 LLRs within one step on at
  most 0.1 % of the entries, the stored states within relative 1e-5 and w
  equal;
- the JAX package's behavioural checks (tests/test_tracking.py) on the
  port: the static-channel gain and the tracked receiver's slot 0 and BER.
"""
import dataclasses

import numpy as np
import pytest
import torch

from srsran_ce_tpu import serving as js
from srsran_ce_tpu.models import receiver as jrcv
from srsran_ce_tpu.models import tracking as jtrk
from srsran_ce_tpu_torch import serving as ts
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models import receiver as trcv
from srsran_ce_tpu_torch.models import tracking as ttrk
from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
from srsran_ce_tpu_torch.utils import synthetic

SCALARS = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")
TRACK_CASES = [
    ("filter_nL2_cfo", dict(n_prbs=12, n_layers=2, cfo_hz=200.0)),
    ("filter_nL1_two_hops", dict(n_prbs=8, n_layers=1, two_hops=True)),
    ("wiener_nL1_two_hops", dict(n_prbs=8, n_layers=1, two_hops=True, smoothing="wiener")),
    ("wiener_nL2", dict(n_prbs=12, n_layers=2, smoothing="wiener", cfo_hz=-150.0)),
    ("none_nL2", dict(n_prbs=8, n_layers=2, smoothing="none")),
]


def rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def nmse(a, b):
    return float(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2))


def soundings(kw, n=5, snr_db=5.0):
    """n soundings: a static channel with fresh noise, the last one a different
    channel (the innovation then exceeds the noise floor)."""
    cases = [synthetic.make_case(seed=5, snr_db=snr_db, noise_seed=100 + s, **kw)
             for s in range(n - 1)]
    return cases + [synthetic.make_case(seed=6, snr_db=snr_db, **kw)]


def batch_of(c, batch=2):
    """Problem 0 as made, problem k scaled by 1 + 0.1 k (float64 ri)."""
    scale = (1.0 + 0.1 * np.arange(batch))[:, None, None, None]
    rg = est.split_ri(c.received_rg)[None] * scale
    pil = np.broadcast_to(est.split_ri(c.pilots), (batch, 2) + c.pilots.shape).copy()
    return rg, pil, np.full(batch, c.beta)


@pytest.mark.parametrize("layout", ["ref", "serve", "factored"])
@pytest.mark.parametrize("name,kw", TRACK_CASES, ids=[n for n, _ in TRACK_CASES])
def test_tracked_ri_matches_jax(name, kw, layout):
    cases = soundings(kw)
    c0 = cases[0]
    nL = c0.pilots.shape[2]
    fj = jtrk.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL, batched=True, out_layout=layout)
    ft = ttrk.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL, batched=True, out_layout=layout,
                               device="cpu")
    sj = jtrk.init_state(c0.hop1, c0.hop2, c0.config, nL, batch=2, dtype=np.float64)
    st = ttrk.init_state(c0.hop1, c0.hop2, c0.config, nL, batch=2, dtype=torch.float64,
                         device="cpu")
    assert [tuple(h.shape) for h in st[0]] == [h.shape for h in sj[0]]
    field = "profiles" if layout == "factored" else "channel_est_rg"
    ws = []
    for c in cases:
        rg, pil, beta = batch_of(c)
        rj, hj, wj = fj(rg, pil, beta, *sj)
        rt, ht, wt = ft(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta), *st)
        sj, st = (hj, wj), (ht, wt)
        assert rel(getattr(rt, field), getattr(rj, field)) <= 1e-12
        if layout == "factored":
            assert rel(rt.sym_rot, rj.sym_rot) <= 1e-12
        for f in SCALARS:
            np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), rtol=1e-12, atol=1e-300)
        for a, b in zip(ht, hj):
            assert rel(a, b) <= 1e-12
        assert rel(wt, wj) <= 1e-12
        ws.append(float(wt[0]))
    # the static soundings accumulate the running average; the new channel snaps back
    assert ws[:4] == [1.0, 2.0, 3.0, 4.0] and ws[4] < 4.0, ws


def test_tracked_ri_unbatched_matches_batched():
    """batched=False: one problem without the leading axis, the batched
    function's problem 0 (relative 1e-12: the products block by batch size)."""
    c = synthetic.make_case(seed=60, n_prbs=12, n_layers=2, snr_db=10.0, cfo_hz=200.0)
    one = ttrk.build_tracked_ri(c.hop1, c.hop2, c.config, 2, out_layout="serve", device="cpu")
    many = ttrk.build_tracked_ri(c.hop1, c.hop2, c.config, 2, batched=True, out_layout="serve",
                                 device="cpu")
    rg, pil, beta = batch_of(c)
    s1 = ttrk.init_state(c.hop1, c.hop2, c.config, 2, dtype=torch.float64, device="cpu")
    sb = ttrk.init_state(c.hop1, c.hop2, c.config, 2, batch=2, dtype=torch.float64, device="cpu")
    for _ in range(2):
        r1, h1, w1 = one(rg[0], pil[0], beta[0], *s1)
        rb, hb, wb = many(rg, pil, beta, *sb)
        s1, sb = (h1, w1), (hb, wb)
        assert rel(r1.channel_est_rg, rb.channel_est_rg[0]) <= 1e-12
        assert all(rel(a, b[0]) <= 1e-12 for a, b in zip(h1, hb))
        assert w1.shape == () and float(w1) == float(wb[0])


def test_tracking_refusals():
    c = synthetic.make_case(seed=8, n_prbs=8, n_layers=1)
    args = (c.hop1, c.hop2, c.config, 1)
    with pytest.raises(ValueError, match="out_layout"):
        ttrk.build_tracked_ri(*args, out_layout="dense", device="cpu")
    ti = dataclasses.replace(c.config, time_interp="linear")
    tracked_rx = lambda *a, **k: trcv.build_tracked_receiver_ri(*a, 2, **k)  # noqa: E731
    for build in (ttrk.build_tracked_ri, tracked_rx):
        with pytest.raises(ValueError, match="time_interp"):
            build(c.hop1, c.hop2, ti, 1, device="cpu")
        with pytest.raises(ValueError, match="learned"):
            build(c.hop1, c.hop2, dataclasses.replace(c.config, smoothing="learned"), 1,
                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrk.build_tracked_ri(*args)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrk.init_state(*args)
    plan = make_plan(*args)
    pt = plan_tensors(plan, "cpu", torch.float64)
    rg = torch.zeros((1,) + c.received_rg.shape, dtype=torch.complex128)
    pil = torch.zeros((1,) + c.pilots.shape, dtype=torch.complex128)
    h = (torch.zeros((1, 1, plan.hop1.n_re), dtype=torch.complex128),)
    with pytest.raises(ValueError, match="both"):
        est._estimate_impl(plan, pt, rg, pil, torch.ones(1, dtype=torch.float64), h_prev=h)
    with pytest.raises(ValueError, match="hops"):
        est._estimate_impl(plan, pt, rg, pil, torch.ones(1, dtype=torch.float64), h_prev=h * 2,
                           track_w=torch.zeros(1, dtype=torch.float64))


@pytest.mark.parametrize("modulation", [None, "qpsk"])
def test_tracked_receiver_matches_jax(modulation):
    mk = dict(n_rx=2, modulation="qpsk", scramble=False, n_prbs=6, n_layers=2, cfo_hz=200.0)
    cases = [synthetic.make_mimo_case(seed=41, snr_db=5.0, noise_seed=500 + s, **mk)
             for s in range(3)]
    cases.append(synthetic.make_mimo_case(seed=42, snr_db=5.0, **mk))
    c0 = cases[0]
    fj = jrcv.build_tracked_receiver_ri(c0.hop1, c0.hop2, c0.config, 2, 2, data_beta=1.1,
                                        modulation=modulation, batched=True)
    ft = trcv.build_tracked_receiver_ri(c0.hop1, c0.hop2, c0.config, 2, 2, data_beta=1.1,
                                        modulation=modulation, batched=True, device="cpu")
    h0, w0 = jtrk.init_state(c0.hop1, c0.hop2, c0.config, 2, batch=2, dtype=np.float64)
    sj = (tuple(np.stack([h] * 2) for h in h0), np.stack([w0] * 2))
    st = tuple(torch.as_tensor(h) for h in sj[0]), torch.as_tensor(sj[1])
    for c in cases:
        rg = np.stack([est.split_ri(c.received_rg)] * 2)
        rg[1] *= 0.9
        pil = np.stack([est.split_ri(c.pilots)] * 2)
        beta = np.full(2, c.beta)
        rj, hj, wj = fj(rg, pil, beta, *sj)
        rt, ht, wt = ft(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta), *st)
        sj, st = (hj, wj), (ht, wt)
        if modulation is None:
            assert rel(rt.x, rj.x) <= 1e-12
        else:
            assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(rt.llr, rj.llr))
        assert rel(rt.sinr, rj.sinr) <= 1e-12
        for f in SCALARS:
            np.testing.assert_allclose(getattr(rt, f), getattr(rj, f), rtol=1e-12, atol=1e-300)
        assert all(rel(a, b) <= 1e-12 for a, b in zip(ht, hj)) and rel(wt, wj) <= 1e-12
    assert tuple(wt.shape) == (2, 2)


def _prob(mod, c, rg=None):
    return mod.Problem((c.received_rg if rg is None else rg).astype(np.complex64),
                       c.pilots.astype(np.complex64), float(c.beta), c.hop1, c.hop2, c.config)


def _check_states(srv_t, srv_j):
    assert set(srv_t._state) == set(srv_j._state)
    for key, (hj, wj) in srv_j._state.items():
        ht, wt = srv_t._state[key]
        assert all(rel(a, b) <= 1e-5 for a, b in zip(ht, hj))
        assert type(wt) is type(wj) and np.array_equal(np.asarray(wt), np.asarray(wj))


def test_tracked_server_grid_matches_jax():
    """Mixed signatures (1 and 2 layers, two hops), more streams of one
    signature than a chunk (tail padding), 3 soundings, then a mode switch
    of one stream to the receiver family and back, which resets it."""
    specs = [dict(n_prbs=8, n_layers=1, cfo_hz=0.0, cfo_compensate=False),
             dict(n_prbs=8, n_layers=2), dict(n_prbs=6, n_layers=1, two_hops=True)]
    n_streams = [5, 2, 1]
    srv_j = js.TrackedServer(batch_size=2, matmul_precision=None)
    srv_t = ts.TrackedServer(batch_size=2, matmul_precision=None, device="cpu")
    for s in range(3):
        cases, ids = [], []
        for j, (sp, n) in enumerate(zip(specs, n_streams)):
            for k in range(n):
                cases.append(synthetic.make_case(seed=70 + 10 * j + k, snr_db=10.0,
                                                 noise_seed=300 + s, **sp))
                ids.append(f"s{j}.{k}")
        order = np.random.default_rng(s).permutation(len(cases))
        cases, ids = [cases[i] for i in order], [ids[i] for i in order]
        want = srv_j.process([_prob(js, c) for c in cases], ids)
        got = srv_t.process([_prob(ts, c) for c in cases], ids)
        for g, w in zip(got, want):
            assert isinstance(g, ts.ServeResult) and g.channel_est_rg.dtype == np.complex64
            assert rel(g.channel_est_rg, w.channel_est_rg) <= 1e-5
            for f in SCALARS:
                atol = {"cfo_hz": 1e-6, "time_alignment": 1e-12}.get(f, 0.0)
                np.testing.assert_allclose(getattr(g, f), getattr(w, f), rtol=1e-4, atol=atol)
        _check_states(srv_t, srv_j)
    assert {float(w) for (_, w) in srv_t._state.values()} == {3.0}
    # stream s0.0 switches to the receiver family: its grid state goes
    m = synthetic.make_mimo_case(seed=92, n_rx=2, modulation="qpsk", n_prbs=6, n_layers=1)
    for srv, mod in ((srv_j, js), (srv_t, ts)):
        srv.process([_prob(mod, m)], ["s0.0"], out="equalized")
    _check_states(srv_t, srv_j)
    assert sum(k[1] == "s0.0" for k in srv_t._state) == 1
    c = synthetic.make_case(seed=70, snr_db=10.0, noise_seed=999, **specs[0])
    for srv, mod in ((srv_j, js), (srv_t, ts)):
        srv.process([_prob(mod, c)], ["s0.0"])
    _check_states(srv_t, srv_j)
    key = next(k for k in srv_t._state if k[1] == "s0.0")
    assert srv_t._state[key][1] == 1.0  # a fresh first sounding
    srv_t.reset("s0.0")
    assert not any(k[1] == "s0.0" for k in srv_t._state)
    srv_t.reset()
    assert not srv_t._state


def test_tracked_server_batch_size_does_not_change_results_or_states():
    """Five streams of one signature over two slots: at batch 2 three chunks
    a slot (the tail padded), at batch 8 one; the grids, the scalars and the
    stored states within relative 1e-6 (batch sums may associate apart), w
    equal."""
    srv = {b: ts.TrackedServer(batch_size=b, matmul_precision=None, device="cpu")
           for b in (2, 8)}
    ids = [f"s{k}" for k in range(5)]
    for s in range(2):
        cases = [synthetic.make_case(seed=80 + k, snr_db=10.0, noise_seed=400 + s, n_prbs=8,
                                     n_layers=2) for k in range(5)]
        got = {b: v.process([_prob(ts, c) for c in cases], ids) for b, v in srv.items()}
        for a, b in zip(got[2], got[8]):
            assert rel(b.channel_est_rg, a.channel_est_rg) <= 1e-6
            assert all(rel(getattr(b, f), getattr(a, f)) <= 1e-6 for f in SCALARS)
        assert set(srv[2]._state) == set(srv[8]._state)
        for key, (h2, w2) in srv[2]._state.items():
            h8, w8 = srv[8]._state[key]
            assert all(rel(b, a) <= 1e-6 for a, b in zip(h2, h8)) and w2 == w8 == s + 1


@pytest.mark.parametrize("out", ["equalized", "llrs"])
def test_tracked_server_receiver_matches_jax(out):
    """The receiver family: 2-port and 1-port streams, 3 streams of one
    signature over a chunk of 2, 3 soundings."""
    mk = dict(modulation="qpsk", scramble=False, n_prbs=6, n_layers=1, cfo_hz=200.0)
    srv_j = js.TrackedServer(batch_size=2, matmul_precision=None)
    srv_t = ts.TrackedServer(batch_size=2, matmul_precision=None, device="cpu")
    kw = dict(out=out, modulation="qpsk" if out == "llrs" else None, data_beta=1.1)
    for s in range(3):
        cases = [synthetic.make_mimo_case(seed=50 + k, n_rx=2 if k < 3 else 1, snr_db=5.0,
                                          noise_seed=700 + s, **mk) for k in range(4)]
        ids = [f"ue{k}" for k in range(4)]
        want = srv_j.process([_prob(js, c) for c in cases], ids, **kw)
        got = srv_t.process([_prob(ts, c) for c in cases], ids, **kw)
        for g, w in zip(got, want):
            if out == "equalized":
                assert isinstance(g, ts.EqualizedServeResult) and nmse(g.x, w.x) <= 1e-7
            else:
                assert isinstance(g, ts.LlrServeResult)
                d = np.abs(g.llr.astype(np.int16) - w.llr.astype(np.int16))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3
            assert rel(g.sinr, w.sinr) <= 1e-4
        _check_states(srv_t, srv_j)
    assert all(np.array_equal(w, np.full(w.shape, 3.0, np.float32))
               for (_, w) in srv_t._state.values())
    with pytest.raises(ValueError, match="modulation"):
        srv_t.process([_prob(ts, cases[0])], ["ue0"], out="llrs")
    with pytest.raises(ValueError, match="one RX port"):
        srv_t.process([_prob(ts, cases[0])], ["ue0"])


def _nmse_truth(ch, truth):
    return float(np.sum(np.abs(ch - truth) ** 2) / (np.sum(np.abs(truth) ** 2) + 1e-30))


def test_tracking_gains_on_static_channel():
    """tests/test_tracking.py's check on the port: 8 soundings of a static
    channel at 0 dB, the tracked estimate beats the single-slot one by more
    than 4 dB (a running average gains ~9 dB at N=8)."""
    kw = dict(n_prbs=24, n_layers=1, cfo_hz=0.0, cfo_compensate=False)
    cases = [synthetic.make_case(seed=5, snr_db=0.0, noise_seed=1000 + s, **kw) for s in range(8)]
    c0 = cases[0]
    fn = ttrk.build_tracked_ri(c0.hop1, c0.hop2, c0.config, 1, device="cpu")
    state = ttrk.init_state(c0.hop1, c0.hop2, c0.config, 1, device="cpu")
    for c in cases:
        res, h, w = fn(est.split_ri(c.received_rg.astype(np.complex64)),
                       est.split_ri(c.pilots.astype(np.complex64)), np.float32(c.beta), *state)
        state = (h, w)
    single = est.estimate(c0.received_rg.astype(np.complex64), c0.pilots.astype(np.complex64),
                          np.float32(c0.beta), c0.hop1, c0.hop2, c0.config, device="cpu")
    n_single = _nmse_truth(single.channel_est_rg.astype(np.complex128), c0.true_channel)
    n_tracked = _nmse_truth(est.merge_ri(res.channel_est_rg.numpy()).astype(np.complex128),
                            c0.true_channel)
    gain_db = 10 * np.log10(n_single / n_tracked)
    assert gain_db > 4.0, (n_single, n_tracked, gain_db)


def test_tracked_receiver_first_slot_matches_plain_and_then_improves():
    """tests/test_tracking.py's check on the port: slot 0 (weight 0) gives the
    plain receiver's bits; after 8 soundings of a static channel at 0 dB with
    CFO compensation on, the tracked receiver's hard-decision BER does not
    exceed the single-slot receiver's on the same input, and w holds the
    running average."""
    n_slots, n_rx, nL = 8, 2, 1
    mk = dict(n_rx=n_rx, modulation="qpsk", scramble=False, n_prbs=12, n_layers=nL,
              cfo_hz=200.0, cfo_compensate=True)
    cases = [synthetic.make_mimo_case(seed=41, snr_db=0.0, noise_seed=500 + s, **mk)
             for s in range(n_slots)]
    c0 = cases[0]
    fn_t = trcv.build_tracked_receiver_ri(c0.hop1, c0.hop2, c0.config, nL, n_rx,
                                          modulation="qpsk", device="cpu")
    fn_p = trcv.build_receiver_ri(c0.hop1, c0.hop2, c0.config, nL, n_rx, modulation="qpsk",
                                  device="cpu")
    state = ttrk.init_state(c0.hop1, c0.hop2, c0.config, nL, batch=n_rx, device="cpu")

    def ber(res, c):
        llr = np.stack([pl.numpy() for pl in res.llr], axis=-1)
        dec = (np.transpose(llr, (2, 1, 0, 3)) < 0).astype(np.uint8)
        m = np.broadcast_to(c.data_mask[:, :, None, None], c.bits.shape)
        return float(np.mean((dec != c.bits)[m]))

    for s, c in enumerate(cases):
        args = (est.split_ri(c.received_rg.astype(np.complex64)),
                est.split_ri(c.pilots.astype(np.complex64)), np.float32(c.beta))
        res, h, w = fn_t(*args, *state)
        state = (h, w)
        rp = fn_p(*args)
        if s == 0:
            assert ber(res, c) == ber(rp, c), "slot 0 must equal the plain receiver"
    assert float(state[1].min()) > n_slots - 2, state[1]
    bt, bp = ber(res, cases[-1]), ber(rp, cases[-1])
    assert bt <= bp, (bt, bp)
