"""The port's sharded paths (`srsran_ce_tpu_torch/parallel/`) in a gloo world of
four ranks on the CPU, case by case against tests/test_sharding.py.

One world is spawned for the whole file (`parallel.launch.spawn_world`, a
FileStore rendezvous, no port); its ranks run every case of `SPECS` in one
go (`validation.sharded.run_cases`, inputs made from seeds with numpy) and
rank 0 hands back the global outputs. The references are computed here, in
the parent: the float64 numpy oracle of the JAX package, the port's
unsharded builders in float64 and the JAX package's unsharded trackers and
receivers. The bounds are test_sharding.py's (and tests/test_receiver.py's
and tests/test_ldpc.py's for the sharded receivers and decoder):

  channels against the oracle NMSE < 1e-18; against the unsharded path
  rtol 1e-12 / atol 1e-14, seams included; noise and CFO rtol 1e-8, EPRE,
  RSRP and TA rtol 1e-9 (TA atol 1e-15); learned smoothing against the
  unsharded denoiser rtol 3e-6 / atol 1e-8 (float32 convolutions), noise
  rtol 1e-6; tracked grids, states and w rtol 1e-10; receivers x rtol
  1e-10 / atol 1e-12, SINR rtol 1e-9, int8 LLRs within one step; the DP
  decoder bit for bit, payload-exact; the data-parallel training step's loss
  and params rtol 1e-6 against the unsharded step on the whole batch.

The JAX test's 8-device meshes become 4-rank ones: (2, 4) -> (1, 4),
(8, 1) -> (4, 1), (4, 2) -> (2, 2). tests/test_torch_parallel_sp.py runs a
world of two ranks and holds the port to the JAX package's sharded builders.
"""
import zlib

import numpy as np
import pytest
import torch

from srsran_ce_tpu.models import receiver as jrcv
from srsran_ce_tpu.models import tracking as jtrk
from srsran_ce_tpu.utils import oracle
from srsran_ce_tpu_torch.models import denoiser as tdn
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models import training as ttr
from srsran_ce_tpu_torch.ops import ldpc as tldpc
from srsran_ce_tpu_torch.parallel import launch
from srsran_ce_tpu_torch.validation import sharded

N_RANKS = 4

SP_CASES = [
    ("1layer_filter", dict(n_prbs=32, n_layers=1, smoothing="filter")),
    ("2layer_filter", dict(n_prbs=32, n_layers=2, smoothing="filter")),
    ("4layer", dict(n_prbs=64, n_layers=4, smoothing="filter")),
    ("mean", dict(n_prbs=32, n_layers=1, smoothing="mean")),
    ("none", dict(n_prbs=32, n_layers=1, smoothing="none")),
    ("comb4", dict(n_prbs=32, n_layers=1, comb=4)),
    ("cfo_off", dict(n_prbs=32, n_layers=1, cfo_compensate=False)),
    ("wideband_272", dict(n_prbs=272, n_layers=1)),
    ("cnn_inpaint", dict(n_prbs=32, n_layers=1, interp="cnn")),
    ("cnn_inpaint_2layer_wide", dict(n_prbs=272, n_layers=2, interp="cnn")),
    ("filter_alpha_blend", dict(n_prbs=32, n_layers=2, cnn_alpha=0.4)),
    ("wiener", dict(n_prbs=32, n_layers=2, smoothing="wiener")),
    ("time_interp", dict(n_prbs=32, n_layers=2, time_interp="linear", doppler_hz=300.0)),
    ("time_interp_cnn", dict(n_prbs=32, n_layers=1, interp="cnn", time_interp="linear",
                             doppler_hz=300.0)),
    ("time_interp_wiener", dict(n_prbs=32, n_layers=2, smoothing="wiener", time_interp="linear",
                                doppler_hz=300.0)),
    ("cfo_wls", dict(n_prbs=32, n_layers=2, cfo_estimator="wls")),
]
PADDED_SP_CASES = [
    ("wideband_273_filter", dict(n_prbs=273, n_layers=1, smoothing="filter")),
    ("pad_mean", dict(n_prbs=25, n_layers=1, smoothing="mean")),
    ("pad_none", dict(n_prbs=25, n_layers=1, smoothing="none")),
    ("pad_wiener", dict(n_prbs=25, n_layers=2, smoothing="wiener")),
    ("pad_cnn_interp", dict(n_prbs=27, n_layers=1, interp="cnn")),
    ("pad_2layer", dict(n_prbs=25, n_layers=2, smoothing="filter")),
    ("pad_alpha_blend", dict(n_prbs=25, n_layers=1, cnn_alpha=0.4)),
    ("pad_comb4", dict(n_prbs=27, n_layers=1, comb=4)),
    ("pad_time_interp", dict(n_prbs=25, n_layers=1, time_interp="linear", doppler_hz=300.0)),
]
HOPPED = [("linear", "none"), ("cnn", "none"), ("linear", "linear"), ("cnn", "linear")]
FACTORED = [
    ("cfo", dict(n_prbs=32, n_layers=2, cfo_hz=250.0)),
    ("wiener", dict(n_prbs=32, n_layers=2, smoothing="wiener")),
    ("two_hops", dict(n_prbs=16, n_layers=1, two_hops=True, cfo_hz=150.0)),
]
TRACKED = [
    ("single_hop", dict(n_prbs=32, n_layers=2, cfo_hz=0.0, cfo_compensate=False), 55, 700),
    ("hopped", dict(n_prbs=8, n_layers=2, two_hops=True, cfo_hz=0.0, cfo_compensate=False), 57,
     800),
    ("padded_cfo", dict(n_prbs=25, n_layers=1, cfo_hz=200.0), 58, 900),
]
RECEIVERS = [("single_hop", dict(n_prbs=24, n_layers=2, cfo_hz=250.0)),
             ("two_hops", dict(n_prbs=12, n_layers=2, cfo_hz=250.0, two_hops=True))]
FUZZ_DRAWS = (4, 16, 29)  # draws whose shard count is 4: est hopped, receiver, tracked


def _sp(name, kw, seed, **extra):
    return dict(name=name, kind="sp", mesh=(1, 4), kw=dict(kw), seed=seed, **extra)


SPECS = (
    [dict(name="dp_oracle", kind="dp_batched", mesh=(4, 1), seeds=list(range(8)),
          kw=dict(n_prbs=24, n_layers=2))]
    + [_sp(f"sp/{n}", kw, zlib.crc32(n.encode())) for n, kw in SP_CASES]
    + [_sp(f"pad/{n}", kw, zlib.crc32(n.encode())) for n, kw in PADDED_SP_CASES]
    + [_sp("seams", dict(n_prbs=64, n_layers=2, snr_db=25.0), 77),
       dict(name="sp_dp_combo", kind="sp_batched", mesh=(2, 2), seeds=[200, 201, 202, 203],
            kw=dict(n_prbs=32, n_layers=1)),
       dict(name="pad_batched", kind="sp_batched", mesh=(1, 4), seeds=[300, 301, 302, 303],
            kw=dict(n_prbs=25, n_layers=1)),
       dict(name="pad_batched_factored", kind="sp_batched", mesh=(1, 4),
            seeds=[300, 301, 302, 303], kw=dict(n_prbs=25, n_layers=1), layout="factored"),
       _sp("pad_hopped", dict(n_prbs=25, n_layers=1, two_hops=True), 91),
       _sp("learned", dict(n_prbs=32, n_layers=2, smoothing="learned", snr_db=25.0), 5, params=0),
       _sp("learned2d", dict(n_prbs=32, n_layers=2, smoothing="learned2d",
                             time_interp="linear", doppler_hz=300.0, snr_db=25.0), 6, params=1)]
    + [_sp(f"hopped/{i}-{t}", dict(n_prbs=12, n_layers=2, two_hops=True, interp=i, time_interp=t,
                                    doppler_hz=200.0 if t == "linear" else 0.0), 61)
       for i, t in HOPPED]
    + [dict(name="hopped_batched", kind="sp_batched", mesh=(2, 2), seeds=[70, 71, 72, 73],
            kw=dict(n_prbs=12, n_layers=1, two_hops=True)),
       dict(name="dp_factored", kind="dp_batched", mesh=(4, 1), seeds=list(range(50, 58)),
            kw=dict(n_prbs=24, n_layers=2, cfo_hz=200.0), layout="factored")]
    + [_sp(f"fac/{n}/{lay}", kw, 71, layout=lay) for n, kw in FACTORED for lay in ("factored", "ref")]
    + [dict(name="fac_batched", kind="sp_batched", mesh=(1, 4), seeds=[72, 73, 74, 75],
            kw=dict(n_prbs=32, n_layers=2, cfo_hz=200.0), layout="factored")]
    + [dict(name=f"tracked/{n}/{lay}", kind="sp_tracked", mesh=(1, 4), kw=kw, seed=seed,
            noise_seeds=[ns, ns + 1, ns + 2], layout=lay)
       for n, kw, seed, ns in TRACKED for lay in ("ref", "factored")]
    + [dict(name=f"rx/{k}/{n}/{mod}", kind=k, mesh=m, seeds=[0, 1] if k == "sp_receiver" else list(range(8)),
            n_rx=2, kw=kw, modulation=mod)
       for n, kw in RECEIVERS for mod in (None, "16qam")
       for k, m in (("sp_receiver", (2, 2)), ("dp_receiver", (4, 1)))
       if k == "sp_receiver" or n == "single_hop"]
    + [dict(name="dp_decoder", kind="dp_decoder", mesh=(4, 1), code=("array", 3, 8, 53),
            batch=16, n_iters=25, seed=12),
       dict(name="train", kind="train", mesh=(4, 1), batch=8, n_re=32, steps=2, seed=3),
       dict(name="train2d", kind="train", mesh=(4, 1), batch=4, n_re=24, steps=1, seed=4,
            two_d=True),
       dict(name="barrier", kind="barrier"),
       dict(name="halo", kind="halo", mesh=(1, 4)),
       dict(name="fuzz", kind="fuzz", mesh=(1, 4), draws=list(FUZZ_DRAWS))]
)
SCALAR_RTOL = dict(noise_est=1e-8, cfo_hz=1e-8, epre=1e-9, rsrp=1e-9, time_alignment=1e-9)


@pytest.fixture(scope="module")
def world():
    return launch.spawn_world(sharded.run_cases, N_RANKS, "gloo", "cpu", args=(SPECS, "cpu"))[0]


def spec_of(name):
    return next(s for s in SPECS if s["name"] == name)


def nmse(a, b):
    return float(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2))


def check_vs_oracle(out, case, scale=1.0, bound=1e-18):
    """The oracle's channel (NMSE) and scalars (test_sharding's rtols) of one problem."""
    o = oracle.estimate(case.received_rg * scale, case.pilots, case.beta, case.hop1, case.hop2,
                        case.config)
    ch = est.merge_ri(out["channel_est_rg"])
    assert ch.shape == o.channel_est_rg.shape
    assert nmse(ch, o.channel_est_rg) < bound
    for f, rtol in SCALAR_RTOL.items():
        want = getattr(o, f)
        if want is not None:
            np.testing.assert_allclose(float(out[f]), want, rtol=rtol,
                                       atol=1e-15 if f == "time_alignment" else 0.0)


def unsharded(spec, layout=None, params=None):
    """The port's unsharded float64 CPU run of a spec's inputs."""
    cases, rg, pil, beta = sharded.case_inputs(spec)
    c = cases[0]
    fn = est.build_ri(c.hop1, c.hop2, c.config, c.pilots.shape[2], batched=np.ndim(beta) == 1,
                      out_layout=layout or spec.get("layout", "ref"))
    extra = () if params is None else (params,)
    return sharded.to_numpy(fn(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta),
                               *extra))


def problem(out, i):
    return {k: v[i] for k, v in out.items()}


def test_dp_batched_matches_oracle(world):
    spec = spec_of("dp_oracle")
    cases = sharded.case_inputs(spec)[0]
    out = world["dp_oracle"]
    for i, c in enumerate(cases):
        check_vs_oracle(problem(out, i), c)
    # zero collectives: each rank's slice through the unsharded batched builder
    ref = unsharded(spec)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", [n for n, _ in SP_CASES])
def test_sp_matches_unsharded(world, name):
    spec = spec_of(f"sp/{name}")
    check_vs_oracle(world[spec["name"]], sharded.case_inputs(spec)[0][0])


@pytest.mark.parametrize("name", [n for n, _ in PADDED_SP_CASES])
def test_sp_padded_matches_unsharded(world, name):
    from srsran_ce_tpu_torch.models.plan import make_plan
    from srsran_ce_tpu_torch.parallel.subcarrier import make_shard_plan

    spec = spec_of(f"pad/{name}")
    case = sharded.case_inputs(spec)[0][0]
    sp = make_shard_plan(make_plan(case.hop1, case.hop2, case.config, case.pilots.shape[2]), 4)
    assert sp.pad > 0, "the case must exercise the padded route"
    check_vs_oracle(world[spec["name"]], case)


def test_sp_seams_bitwise_vs_unsharded(world):
    got = est.merge_ri(world["seams"]["channel_est_rg"])
    want = est.merge_ri(unsharded(spec_of("seams"))["channel_est_rg"])
    L = want.shape[0] // N_RANKS
    seams = np.concatenate([[s * L - 2, s * L - 1, s * L, s * L + 1] for s in range(1, N_RANKS)])
    np.testing.assert_allclose(got[seams], want[seams], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["sp_dp_combo", "pad_batched", "hopped_batched"])
def test_sp_batched_matches_oracle(world, name):
    spec = spec_of(name)
    out = world[name]
    if name == "pad_batched":
        assert out["channel_est_rg"].shape[2] == 25 * 12
    for i, c in enumerate(sharded.case_inputs(spec)[0]):
        check_vs_oracle(problem(out, i), c)


def test_sp_padded_batched_factored(world):
    spec = spec_of("pad_batched_factored")
    c = sharded.case_inputs(spec)[0][0]
    prof, rot = world[spec["name"]]["profiles"], world[spec["name"]]["sym_rot"]
    assert prof.shape[-1] == 25 * 12
    grid = est.reconstruct_factored(est.merge_ri(prof[0]), est.merge_ri(rot[0]), c.hop1, c.hop2)
    o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
    assert nmse(grid, o.channel_est_rg) < 1e-14


def test_sp_padded_hopped(world):
    spec = spec_of("pad_hopped")
    check_vs_oracle(world["pad_hopped"], sharded.case_inputs(spec)[0][0])


@pytest.mark.parametrize("name", ["learned", "learned2d"])
def test_sp_learned_smoothing_matches_unsharded(world, name):
    spec = spec_of(name)
    params = sharded.perturbed_params(spec["params"], name == "learned2d")
    got = world[name]
    want = unsharded(spec, params=params)
    if name == "learned":  # test_sharding.py's bound
        np.testing.assert_allclose(got["channel_est_rg"], want["channel_est_rg"], rtol=3e-6,
                                   atol=1e-8)
    else:  # no JAX test: float32 sums of 32 channels x 27 taps, 1e-5 of the grid's scale
        a, b = got["channel_est_rg"], want["channel_est_rg"]
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    np.testing.assert_allclose(got["noise_est"], want["noise_est"], rtol=1e-6)


@pytest.mark.parametrize("interp,time_interp", HOPPED)
def test_sp_hopped_matches_unsharded(world, interp, time_interp):
    spec = spec_of(f"hopped/{interp}-{time_interp}")
    out = world[spec["name"]]
    check_vs_oracle(out, sharded.case_inputs(spec)[0][0])
    want = unsharded(spec)
    np.testing.assert_allclose(out["channel_est_rg"], want["channel_est_rg"], rtol=1e-12,
                               atol=1e-14)


def test_dp_batched_factored(world):
    spec = spec_of("dp_factored")
    out = world["dp_factored"]
    for i, c in enumerate(sharded.case_inputs(spec)[0]):
        o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        grid = est.reconstruct_factored(est.merge_ri(out["profiles"][i]),
                                        est.merge_ri(out["sym_rot"][i]), c.hop1, c.hop2)
        assert nmse(grid, o.channel_est_rg) < 1e-18, i


@pytest.mark.parametrize("name", [n for n, _ in FACTORED])
def test_sp_factored_matches_unsharded_factored(world, name):
    spec = spec_of(f"fac/{name}/factored")
    c = sharded.case_inputs(spec)[0][0]
    out = world[spec["name"]]
    prof, rot = est.merge_ri(out["profiles"]), est.merge_ri(out["sym_rot"])
    want = unsharded(spec)
    np.testing.assert_allclose(rot, est.merge_ri(want["sym_rot"]), rtol=1e-12, atol=0)
    # single-hop overlap-save profiles against the unsharded fill: ulps; the
    # hopped fill multiplies each rank's column window of the operator
    tol = 1e-12 if c.hop2 is None else 1e-12
    np.testing.assert_allclose(prof, est.merge_ri(want["profiles"]), rtol=tol, atol=1e-13)
    grid = est.merge_ri(world[f"fac/{name}/ref"]["channel_est_rg"])
    recon = est.reconstruct_factored(prof, rot, c.hop1, c.hop2)
    np.testing.assert_allclose(recon, grid, rtol=1e-12, atol=1e-13)
    for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_allclose(out[f], want[f], rtol=1e-12)


def test_sp_factored_batched(world):
    spec = spec_of("fac_batched")
    out = world["fac_batched"]
    for i, c in enumerate(sharded.case_inputs(spec)[0]):
        o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
        grid = est.reconstruct_factored(est.merge_ri(out["profiles"][i]),
                                        est.merge_ri(out["sym_rot"][i]), c.hop1, c.hop2)
        assert nmse(grid, o.channel_est_rg) < 1e-18, i


def test_sp_factored_rejects_time_interp():
    from srsran_ce_tpu_torch.parallel import subcarrier as sc
    from srsran_ce_tpu_torch.utils import synthetic

    case = synthetic.make_case(seed=3, n_prbs=32, n_layers=1, time_interp="linear",
                               doppler_hz=200.0)
    for build in (sc.build_sp, sc.build_sp_batched):
        with pytest.raises(ValueError):
            build(case.hop1, case.hop2, case.config, 1, None, out_layout="factored", device="cpu")


@pytest.mark.parametrize("layout", ["ref", "factored"])
@pytest.mark.parametrize("name", [t[0] for t in TRACKED])
def test_sp_tracked_matches_unsharded_tracker(world, name, layout):
    """Three soundings with the state threaded: grids, states and w equal the
    JAX package's unsharded tracker (and the factored layout reconstructs the
    tracked grid of the reference layout)."""
    spec = spec_of(f"tracked/{name}/{layout}")
    kw = dict(spec["kw"], snr_db=0.0)
    from srsran_ce_tpu_torch.utils import synthetic

    cases = [synthetic.make_case(seed=spec["seed"], noise_seed=s, **kw) for s in spec["noise_seeds"]]
    c0 = cases[0]
    nL = c0.pilots.shape[2]
    f_un = jtrk.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL, out_layout=layout)
    st = jtrk.init_state(c0.hop1, c0.hop2, c0.config, nL)
    slots = world[spec["name"]]
    for s, c in enumerate(cases):
        r_un, h_un, w_un = f_un(est.split_ri(c.received_rg), est.split_ri(c.pilots),
                               np.asarray(c.beta), st[0], st[1])
        st = (tuple(np.asarray(h) for h in h_un), np.asarray(w_un))
        got = slots[s]
        np.testing.assert_allclose(float(got["w"]), float(w_un), rtol=1e-10)
        for i, h in enumerate(st[0]):
            np.testing.assert_allclose(got[f"h{i}"], h, rtol=1e-10, atol=1e-14)
        field = "channel_est_rg" if layout == "ref" else "profiles"
        np.testing.assert_allclose(got[field], np.asarray(getattr(r_un, field)), rtol=1e-10,
                                   atol=1e-14)
        if layout == "factored":
            grid = est.reconstruct_factored(est.merge_ri(got["profiles"]),
                                            est.merge_ri(got["sym_rot"]), c.hop1, c.hop2)
            ref_grid = est.merge_ri(world[f"tracked/{name}/ref"][s]["channel_est_rg"])
            np.testing.assert_allclose(grid, ref_grid, rtol=1e-12, atol=1e-14)
    if name == "single_hop":
        assert float(st[1]) > 2.0  # a static channel: the weight accumulates


@pytest.mark.parametrize("spec", [s for s in SPECS if s["name"].startswith("rx/")],
                         ids=lambda s: s["name"][3:])
def test_receiver_matches_unsharded(world, spec):
    """The DP and SP receivers against the JAX package's unsharded batched
    receiver on the same inputs (tests/test_receiver.py's bounds)."""
    cases, rg, pil, beta = sharded.case_inputs(spec)
    c = cases[0]
    nL = c.pilots.shape[2]
    fn = jrcv.build_receiver_ri(c.hop1, c.hop2, c.config, nL, spec["n_rx"], batched=True,
                                modulation=spec["modulation"])
    want = fn(rg, pil, beta)
    got = world[spec["name"]]
    if spec["modulation"] is None:
        np.testing.assert_allclose(got["x"], np.asarray(want.x), rtol=1e-10, atol=1e-12)
    else:
        lu = np.stack([np.asarray(p) for p in want.llr], axis=1)
        assert got["llr"].dtype == np.int8
        assert np.abs(got["llr"].astype(np.int64) - lu.astype(np.int64)).max() <= 1
    np.testing.assert_allclose(got["sinr"], np.asarray(want.sinr), rtol=1e-9, atol=1e-12)
    for f in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)), rtol=1e-9)


def test_dp_sharded_decode_matches_unsharded(world):
    spec = spec_of("dp_decoder")
    got = world["dp_decoder"]
    code = tldpc.array_code(*spec["code"][1:])
    rng = np.random.default_rng(spec["seed"])
    plan = tldpc.make_ldpc_plan(code)
    u = rng.integers(0, 2, (spec["batch"], plan.k), dtype=np.uint8)
    cw = tldpc.encode(code, u)
    llr = (4.0 * (1 - 2.0 * cw) + rng.normal(0, 0.6, cw.shape)).astype(np.float32)
    ref = tldpc.build_decoder(code, n_iters=spec["n_iters"], device="cpu")(llr)
    assert np.array_equal(got["bits"], ref.bits.numpy())
    assert np.array_equal(got["ok"], ref.ok.numpy())
    assert np.array_equal(got["info"], u) and np.array_equal(got["u"], u)


@pytest.mark.parametrize("name", ["train", "train2d"])
def test_dp_train_step_matches_unsharded(world, name):
    """The data-parallel step over 4 ranks == the unsharded step on the whole
    batch (the JAX package's global NMSE), loss and params rtol 1e-6."""
    spec = spec_of(name)
    two_d = spec.get("two_d", False)
    rng = np.random.default_rng(spec["seed"])
    make = tdn.make_training_batch_2d if two_d else tdn.make_training_batch
    state, tx = (ttr.init_state_2d if two_d else ttr.init_state)(seed=spec["seed"], device="cpu")
    params = {k: v.double() for k, v in state.params.items()}
    opt = ttr.fresh_adam_state(params)
    step = (ttr.build_train_step_2d if two_d else ttr.build_train_step)(tx)
    losses = []
    for _ in range(spec["steps"]):
        noisy, truth = make(rng, spec["batch"], spec["n_re"])
        params, opt, loss = step(params, opt, noisy, truth)
        losses.append(float(loss))
    got = world[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-6, atol=1e-9)


def test_all_device_barrier_and_heartbeat(world):
    r = world["barrier"]
    assert r["barrier_s"] >= 0.0
    assert r["healthy"] and r["error"] is None and r["rounds"] >= 1
    assert r["latency"] is not None
    assert r["failure"] == (False, ["injected"])


def test_halo_exchange_routes(world):
    """Both halo routes bit-identical; the left / right halos are the
    neighbours' edge blocks, zeros at the outermost ranks; psum and
    all_gather in rank order."""
    r = world["halo"]
    assert r["same"] and r["auto_route"] == "p2p"  # p2p against the all_gather route
    xs, lefts, rights = r["xs"], r["lefts"], r["rights"]
    for k in range(N_RANKS):
        want_l = xs[k - 1][..., -4:] if k > 0 else np.zeros_like(xs[k][..., -4:])
        want_r = xs[k + 1][..., :4] if k < N_RANKS - 1 else np.zeros_like(xs[k][..., :4])
        assert np.array_equal(lefts[k], want_l) and np.array_equal(rights[k], want_r)
    acc = xs[0]
    for k in range(1, N_RANKS):
        acc = acc + xs[k]
    assert np.array_equal(r["psum"], acc)
    assert np.array_equal(r["x"], np.concatenate(list(xs), axis=-1))
    assert world["_halo_routes"].get("p2p", 0) > 0


@pytest.mark.parametrize("draw", FUZZ_DRAWS)
def test_sp_fuzz_draw(world, draw):
    row = next(r for r in world["fuzz"] if r["draw"] == draw)
    assert row["n_sp"] == N_RANKS
    assert row["ok"], row
