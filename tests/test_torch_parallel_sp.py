"""The port's sharded paths in a gloo world of two ranks on the CPU against the
JAX package's sharded builders, plus the parts that need no world.

One world of two ranks for the file (`parallel.launch.spawn_world`) runs
`SPECS` (`validation.sharded.run_cases`, float64, inputs from seeds with
numpy). Here, in the parent, the JAX package's own sharded builders run the
same inputs over a mesh with the same shard count on the conftest's 8 virtual
CPU devices ((4, 2): dp 4, sp 2); the port's outputs are held to them at
tests/test_sharding.py's bounds: channels rtol 1e-12 / atol 1e-14 (the
learned denoiser: NMSE 1e-10, tests/test_torch_denoiser.py's bound of the
port against JAX, whose float32 convolutions sum in another order), scalars rtol
1e-9, tracked grids, states and w rtol 1e-10, receivers as
tests/test_receiver.py (x rtol 1e-10 / atol 1e-12, int8 LLRs within one
step), the DP decoder bit for bit. The seams at two shards are held to the
port's unsharded float64 run (rtol 1e-12 / atol 1e-14), and three deep-fuzz
draws whose shard count is 2 run in the world.

Without a world: the shard plans against the JAX package's (numpy copies,
field for field), the geometry refusals, the sharded denoisers at one shard
(zero halos) against the unsharded ones and the JAX package's, and the
inpainting operator built by probes against the identity-basis build, bit
for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_ce_tpu.models import denoiser as jdn
from srsran_ce_tpu.models import tracking as jtrk
from srsran_ce_tpu.models.plan import make_plan as jmake_plan
from srsran_ce_tpu.ops import ldpc as jldpc
from srsran_ce_tpu.parallel import mesh as jmesh
from srsran_ce_tpu.parallel import subcarrier as jsc
from srsran_ce_tpu.parallel.data_parallel import build_dp_decoder as jbuild_dp_decoder
from srsran_ce_tpu_torch.models import denoiser as tdn
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models.plan import make_plan
from srsran_ce_tpu_torch.ops import dsp
from srsran_ce_tpu_torch.parallel import launch
from srsran_ce_tpu_torch.parallel import mesh as tmesh
from srsran_ce_tpu_torch.parallel import subcarrier as sc
from srsran_ce_tpu_torch.utils import synthetic
from srsran_ce_tpu_torch.validation import sharded

N_RANKS = 2
JAX_CASES = [
    ("2layer_filter", dict(n_prbs=32, n_layers=2)),
    ("pad_comb4", dict(n_prbs=27, n_layers=1, comb=4)),
    ("alpha_blend", dict(n_prbs=25, n_layers=1, cnn_alpha=0.4)),
    ("wiener", dict(n_prbs=26, n_layers=2, smoothing="wiener")),
    ("mean", dict(n_prbs=25, n_layers=1, smoothing="mean")),
    ("cnn_time_interp", dict(n_prbs=32, n_layers=1, interp="cnn", time_interp="linear",
                             doppler_hz=300.0)),
    ("hopped", dict(n_prbs=12, n_layers=2, two_hops=True)),
    ("hopped_cnn_time_interp", dict(n_prbs=12, n_layers=1, two_hops=True, interp="cnn",
                                    time_interp="linear", doppler_hz=200.0)),
]
FUZZ_DRAWS = (3, 7, 15)  # draws whose shard count is 2: tracked, est cnn factored, receiver


def _sp(name, kw, seed, **extra):
    return dict(name=name, kind="sp", mesh=(1, 2), kw=dict(kw), seed=seed, **extra)


SPECS = (
    [_sp(f"jax/{n}/{lay}", kw, 40 + i, layout=lay) for i, (n, kw) in enumerate(JAX_CASES)
     for lay in ("ref", "factored") if lay == "ref" or "time_interp" not in kw]
    + [_sp("seams", dict(n_prbs=64, n_layers=2, snr_db=25.0), 77),
       _sp("learned", dict(n_prbs=48, n_layers=1, smoothing="learned", snr_db=25.0), 8,
           params=2),
       dict(name="batched", kind="sp_batched", mesh=(1, 2), seeds=[10, 11, 12],
            kw=dict(n_prbs=24, n_layers=2, cfo_hz=-120.0)),
       dict(name="tracked", kind="sp_tracked", mesh=(1, 2), kw=dict(n_prbs=24, n_layers=2),
            seed=21, noise_seeds=[1, 2, 3]),
       dict(name="tracked_hopped", kind="sp_tracked", mesh=(1, 2),
            kw=dict(n_prbs=6, n_layers=1, two_hops=True), seed=22, noise_seeds=[4, 5]),
       dict(name="rx", kind="sp_receiver", mesh=(1, 2), seeds=[3], n_rx=3,
            kw=dict(n_prbs=26, n_layers=2, cfo_hz=100.0), modulation="qpsk"),
       dict(name="dp_decoder", kind="dp_decoder", mesh=(2, 1), code=("nr", 2, 16), batch=8,
            n_iters=12, seed=5),
       dict(name="halo", kind="halo", mesh=(1, 2)),
       dict(name="barrier", kind="barrier"),
       dict(name="fuzz", kind="fuzz", mesh=(1, 2), draws=list(FUZZ_DRAWS))]
)


@pytest.fixture(scope="module")
def world():
    return launch.spawn_world(sharded.run_cases, N_RANKS, "gloo", "cpu", args=(SPECS, "cpu"))[0]


@pytest.fixture(scope="module")
def jmesh_2():
    return jmesh.make_mesh((4, N_RANKS), ("dp", "sp"))


def spec_of(name):
    return next(s for s in SPECS if s["name"] == name)


def jax_params(seed, two_d=False):
    return jax.tree.map(jnp.asarray, tdn.params_to_flax(sharded.perturbed_params(seed, two_d)))


@pytest.mark.parametrize("spec", [s for s in SPECS if s["name"].startswith("jax/")],
                         ids=lambda s: s["name"][4:])
def test_sp_matches_jax_sharded_builder(world, jmesh_2, spec):
    cases, rg, pil, beta = sharded.case_inputs(spec)
    c = cases[0]
    fn = jsc.build_sp(c.hop1, c.hop2, c.config, c.pilots.shape[2], jmesh_2,
                      out_layout=spec["layout"])
    want = fn(rg, pil, beta)
    got = world[spec["name"]]
    for f in got:
        w = np.asarray(getattr(want, f))
        if f in ("channel_est_rg", "profiles", "sym_rot"):
            np.testing.assert_allclose(got[f], w, rtol=1e-12, atol=1e-14, err_msg=f)
        else:
            np.testing.assert_allclose(got[f], w, rtol=1e-9, err_msg=f)


def test_sp_seams_two_shards_vs_unsharded(world):
    cases, rg, pil, beta = sharded.case_inputs(spec_of("seams"))
    c = cases[0]
    want = est.build_ri(c.hop1, c.hop2, c.config, 2)(torch.as_tensor(rg), torch.as_tensor(pil),
                                                      torch.as_tensor(beta))
    got = est.merge_ri(world["seams"]["channel_est_rg"])
    want = est.merge_ri(want.channel_est_rg.numpy())
    L = want.shape[0] // N_RANKS
    np.testing.assert_allclose(got[L - 2 : L + 2], want[L - 2 : L + 2], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_sp_learned_matches_jax_sharded_builder(world, jmesh_2):
    spec = spec_of("learned")
    cases, rg, pil, beta = sharded.case_inputs(spec)
    c = cases[0]
    fn = jsc.build_sp(c.hop1, c.hop2, c.config, 1, jmesh_2)
    want = fn(rg, pil, beta, jax_params(spec["params"]))
    got = world["learned"]
    # port against JAX: XLA's and PyTorch's float32 convolutions, at the NMSE
    # bound of tests/test_torch_denoiser.py (learned on every tier vs JAX)
    a, b = est.merge_ri(got["channel_est_rg"]), est.merge_ri(np.asarray(want.channel_est_rg))
    assert np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2) < 1e-10
    np.testing.assert_allclose(got["noise_est"], float(want.noise_est), rtol=1e-6)


def test_sp_batched_matches_jax_sharded_builder(world, jmesh_2):
    spec = spec_of("batched")
    cases, rg, pil, beta = sharded.case_inputs(spec)
    c = cases[0]
    mesh = jmesh.make_mesh((1, N_RANKS), ("dp", "sp"), devices=jax.devices()[:N_RANKS])
    want = jsc.build_sp_batched(c.hop1, c.hop2, c.config, 2, mesh)(rg, pil, beta)
    got = world["batched"]
    np.testing.assert_allclose(got["channel_est_rg"], np.asarray(want.channel_est_rg),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got["noise_est"], np.asarray(want.noise_est), rtol=1e-9)


@pytest.mark.parametrize("name", ["tracked", "tracked_hopped"])
def test_sp_tracked_matches_jax_sharded_tracker(world, jmesh_2, name):
    spec = spec_of(name)
    kw = dict(spec["kw"], snr_db=0.0)
    cases = [synthetic.make_case(seed=spec["seed"], noise_seed=s, **kw) for s in spec["noise_seeds"]]
    c0 = cases[0]
    nL = c0.pilots.shape[2]
    fn = jsc.build_sp_tracked(c0.hop1, c0.hop2, c0.config, nL, jmesh_2)
    st = jtrk.init_state(c0.hop1, c0.hop2, c0.config, nL)
    for s, c in enumerate(cases):
        r, h, w = fn(est.split_ri(c.received_rg), est.split_ri(c.pilots), np.asarray(c.beta),
                     st[0], st[1])
        st = (tuple(np.asarray(x) for x in h), np.asarray(w))
        got = world[name][s]
        np.testing.assert_allclose(float(got["w"]), float(w), rtol=1e-10)
        for i, x in enumerate(st[0]):
            np.testing.assert_allclose(got[f"h{i}"], x, rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(got["channel_est_rg"], np.asarray(r.channel_est_rg),
                                   rtol=1e-10, atol=1e-14)


def test_sp_receiver_matches_jax_sharded_receiver(world):
    spec = spec_of("rx")
    cases, rg, pil, beta = sharded.case_inputs(spec)
    c = cases[0]
    mesh = jmesh.make_mesh((1, N_RANKS), ("dp", "sp"), devices=jax.devices()[:N_RANKS])
    want = jsc.build_sp_receiver(c.hop1, c.hop2, c.config, 2, mesh, modulation="qpsk")(rg, pil, beta)
    got = world["rx"]
    lj = np.stack([np.asarray(p) for p in want.llr], axis=1)
    assert got["llr"].dtype == np.int8 and got["llr"].shape == lj.shape
    assert np.abs(got["llr"].astype(np.int64) - lj.astype(np.int64)).max() <= 1
    np.testing.assert_allclose(got["sinr"], np.asarray(want.sinr), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["noise_est"], np.asarray(want.noise_est), rtol=1e-9)


def test_dp_decoder_matches_jax_dp_decoder(world):
    from srsran_ce_tpu.ops import nr_ldpc as jnr

    spec = spec_of("dp_decoder")
    got = world["dp_decoder"]
    code = jnr.nr_base_graph(*spec["code"][1:])
    rng = np.random.default_rng(spec["seed"])
    u = rng.integers(0, 2, (spec["batch"], jldpc.make_ldpc_plan(code).k), dtype=np.uint8)
    cw = jldpc.encode(code, u)
    llr = (4.0 * (1 - 2.0 * cw) + rng.normal(0, 0.6, cw.shape)).astype(np.float32)
    mesh = jmesh.make_mesh((N_RANKS,), ("dp",), devices=jax.devices()[:N_RANKS])
    want = jbuild_dp_decoder(code, mesh, n_iters=spec["n_iters"])(llr)
    assert np.array_equal(got["bits"], np.asarray(want.bits))
    assert np.array_equal(got["ok"], np.asarray(want.ok))
    assert np.array_equal(got["info"], u)


def test_halo_and_barrier_two_ranks(world):
    h = world["halo"]
    assert h["same"]
    assert np.array_equal(h["lefts"][1], h["xs"][0][..., -4:])
    assert np.array_equal(h["rights"][0], h["xs"][1][..., :4])
    assert not h["lefts"][0].any() and not h["rights"][1].any()
    b = world["barrier"]
    assert b["healthy"] and b["rounds"] >= 1 and b["failure"] == (False, ["injected"])
    assert world["_foreign_modules"] == []


@pytest.mark.parametrize("draw", FUZZ_DRAWS)
def test_sp_fuzz_draw(world, draw):
    row = next(r for r in world["fuzz"] if r["draw"] == draw)
    assert row["n_sp"] == N_RANKS
    assert row["ok"], row


# ---------------------------------------------------------------------------
# Without a world
# ---------------------------------------------------------------------------

PLAN_CASES = [
    (dict(n_prbs=32, n_layers=2), 4),
    (dict(n_prbs=25, n_layers=1, cnn_alpha=0.4), 4),
    (dict(n_prbs=273, n_layers=1), 8),
    (dict(n_prbs=27, n_layers=1, comb=4, interp="cnn"), 2),
    (dict(n_prbs=48, n_layers=2, smoothing="learned"), 2),
    (dict(n_prbs=24, n_layers=1, smoothing="wiener"), 3),
]


@pytest.mark.parametrize("kw,n_sp", PLAN_CASES)
def test_shard_plan_matches_jax(kw, n_sp):
    c = synthetic.make_case(seed=1, **kw)
    nL = c.pilots.shape[2]
    got = sc.make_shard_plan(make_plan(c.hop1, c.hop2, c.config, nL), n_sp)
    want = jsc.make_shard_plan(jmake_plan(c.hop1, c.hop2, c.config, nL), n_sp)
    for f in ("n_sp", "comb", "offs", "L", "R", "hw", "pad", "n_rlast", "local_re_idx",
              "interp_jl", "interp_jr", "interp_alpha", "first_zone", "last_zone"):
        a, b = getattr(got, f), getattr(want, f)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
        assert np.asarray(a).dtype == np.asarray(b).dtype, f


@pytest.mark.parametrize("n_prbs,n_sp", [(12, 4), (25, 4), (24, 5)])
def test_hopped_shard_plan_matches_jax(n_prbs, n_sp):
    c = synthetic.make_case(seed=2, n_prbs=n_prbs, n_layers=1, two_hops=True)
    got = sc.make_hopped_shard_plan(make_plan(c.hop1, c.hop2, c.config, 1), n_sp)
    want = jsc.make_hopped_shard_plan(jmake_plan(c.hop1, c.hop2, c.config, 1), n_sp)
    assert (got.n_sp, got.L) == (want.n_sp, want.L)
    assert got.n_sp * got.L >= got.n_sc == len(c.hop1.prb_mask) * 12


def test_shard_plan_rejects_bad_geometry():
    case = synthetic.make_case(seed=1, n_prbs=24, n_layers=1, two_hops=True)
    with pytest.raises(AssertionError):
        sc.make_shard_plan(make_plan(case.hop1, case.hop2, case.config, 1), 4)
    case2 = synthetic.make_case(seed=2, n_prbs=25, n_layers=1)
    plan2 = make_plan(case2.hop1, case2.hop2, case2.config, 1)
    sp2 = sc.make_shard_plan(plan2, 4)
    assert sp2.pad > 0 and sp2.n_rlast == sp2.R - sp2.pad
    assert 4 * sp2.R == sp2.pad + plan2.hop1.n_re
    case3 = synthetic.make_case(seed=3, n_prbs=25, n_layers=1, smoothing="learned")
    with pytest.raises(AssertionError):  # the padded route refuses the denoiser
        sc.make_shard_plan(make_plan(case3.hop1, case3.hop2, case3.config, 1), 4)


@pytest.mark.parametrize("two_d", [False, True])
def test_apply_sharded_single_shard_equals_apply(two_d):
    """Zero halos (one shard) == the unsharded denoiser, and == the JAX
    package's apply_sharded, within 3e-6 of the output's scale (the learned
    bound of test_sharding.py: float32 sums of 48 channels x 13 taps, which
    PyTorch's CPU convolution orders by the input's width, padded or not)."""
    params = sharded.perturbed_params(7, two_d, scale=0.1)
    rng = np.random.default_rng(9)
    shape = (3, 4, 48) if two_d else (3, 48)
    h = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    def zero_exchange(x, hw):
        z = x.new_zeros(x.shape[:-1] + (hw,))
        return z, z

    apply_s = tdn.apply_sharded_2d if two_d else tdn.apply_sharded
    apply_c = tdn.apply_complex_2d if two_d else tdn.apply_complex
    a = apply_s(params, torch.as_tensor(h), zero_exchange).numpy()
    b = apply_c(params, torch.as_tensor(h)).numpy()
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= 3e-6 * scale

    def jzero(x, hw):
        z = jnp.zeros(x.shape[:-1] + (hw,), x.dtype)
        return z, z

    japply = jdn.apply_sharded_2d if two_d else jdn.apply_sharded
    jparams = jax.tree.map(jnp.asarray, tdn.params_to_flax(params))
    j = np.asarray(japply(jparams, jnp.asarray(h), jzero))
    assert np.abs(a - j).max() <= 3e-6 * scale


def _masks():
    rng = np.random.default_rng(0)
    out = []
    for n, comb, hole in [(48, 2, None), (96, 4, None), (384, 2, (10, 30)), (300, 3, None),
                          (24, 12, None), (5, 2, None), (30, 6, (0, 12)), (200, 2, (150, 200))]:
        k = np.zeros(n, bool)
        k[::comb] = True
        if hole:
            k[hole[0] : hole[1]] = False
        out.append(k)
    for _ in range(12):
        n = int(rng.integers(3, 200))
        k = rng.random(n) < rng.uniform(0.05, 0.9)
        k[int(rng.integers(n))] = True
        out.append(k)
    out.append(np.ones(10, bool))
    return out


@pytest.mark.parametrize("n_iters", [1, 5, 40])
def test_inpaint_operator_probes_bit_identical(n_iters):
    """The operator built by probes (several rows a pass where their supports
    cannot meet) == the chain over the whole identity basis, bit for bit
    (signed zeros included)."""
    for known in _masks():
        filled = np.nonzero(known)[0]
        eye = torch.zeros((filled.size, known.size), dtype=torch.float64)
        eye[torch.arange(filled.size), torch.as_tensor(filled)] = 1.0
        want = dsp.cnn_inpaint(eye, known, n_iters, schedule=dsp.make_inpaint_schedule(known, n_iters))
        got = dsp.inpaint_operator(known, n_iters, torch.float64, "cpu")
        assert torch.equal(got, want) and torch.equal(got.signbit(), want.signbit()), known.size


def test_multihost_initialize_without_a_cluster(monkeypatch):
    """No arguments and no torchrun environment: single-process operation
    (False), as the JAX function without a cluster; an address alone raises."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.multihost_initialize() is False
    with pytest.raises(ValueError, match="num_processes"):
        tmesh.multihost_initialize("localhost:1")


def test_sp_fuzz_draws_match_jax():
    """The sharded sweep's draws are the JAX package's (a numpy copy): the
    same draw for the same index, so a draw number names one geometry in
    both packages."""
    from srsran_ce_tpu.validation import deepfuzz as jdf
    from srsran_ce_tpu_torch.validation import deepfuzz as tdf

    for d in range(40):
        a = tdf.draw_sp_case(np.random.default_rng(0xCE_59 + d))
        b = jdf.draw_sp_case(np.random.default_rng(0xCE_59 + d))
        assert a == b, d
