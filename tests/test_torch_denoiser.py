"""The port's denoisers and learned smoothing against the JAX package's, on the CPU.

- `models.denoiser.params_from_flax` against `PilotDenoiser.apply` /
  `PilotDenoiser2D.apply` of the JAX package on random params and inputs:
  relative 1e-5 (max-abs error over max-abs value; two float32 convolutions
  that sum in different orders);
- the committed `srsran_ce_tpu_torch/artifacts/denoiser{,2d}.npz` against the
  orbax restore of the shipped checkpoints: every array `np.array_equal`;
- learned and learned2d `build_ri` on every tier and layout, the receiver
  and `serving.process(params=...)` against the JAX functions with the same
  shipped params. The denoiser runs in float32 in both packages, so the
  float64 pipelines agree to the float32 convolution's rounding: grid NMSE
  <= 1e-10 (measured ~3e-14), scalars within rtol 1e-6. `process` runs in
  float32 in both packages: grids also within relative 1e-5, symbols within
  NMSE 1e-7, int8 LLRs within one step on at most 0.1 % of the entries,
  decoded info and ok identical (tests/test_torch_serving.py's bars);
- the JAX package's behavioural check test_denoiser2d.py::
  test_untrained_2d_is_identity on the port.

`python tests/test_torch_denoiser.py` rewrites the two npz files from the
checkpoints (flax layout, params only).
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from srsran_ce_tpu import serving as js
from srsran_ce_tpu import transport as jtr
from srsran_ce_tpu.models import denoiser as jdn
from srsran_ce_tpu.models import estimator as jest
from srsran_ce_tpu.models import receiver as jrcv
from srsran_ce_tpu.ops import ldpc as jl
from srsran_ce_tpu_torch import serving as ts
from srsran_ce_tpu_torch import transport as ttr
from srsran_ce_tpu_torch.models import denoiser as dn
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.models import receiver as trcv
from srsran_ce_tpu_torch.ops import ldpc as tl
from srsran_ce_tpu_torch.utils import synthetic

REPO = Path(__file__).resolve().parents[1]
CKPT = {"1d": "denoiser_ckpt", "2d": "denoiser2d_ckpt"}
SCALARS = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")


def restore_flax(kind: str) -> dict:
    """The shipped checkpoint's flax params ({"params": {"Conv_i": ...}}),
    numpy, restored through orbax."""
    from srsran_ce_tpu.models import training

    load = training.load_checkpoint if kind == "1d" else training.load_checkpoint_2d
    state = load(str(REPO / "srsran_ce_tpu" / "artifacts" / CKPT[kind]))
    return jax.tree_util.tree_map(np.asarray, state.params)


def write_artifacts() -> None:
    """The npz files of the port from the orbax checkpoints."""
    for kind, name in dn.SHIPPED.items():
        p = restore_flax(kind)
        np.savez(dn.ARTIFACTS / name, **dn.flax_npz_entries(p))


@pytest.fixture(scope="module")
def shipped():
    """kind -> (flax params for JAX, port params), both from the npz files
    (held equal to the orbax restore by test_shipped_npz_equal_orbax)."""
    return {kind: (dn.load_flax_npz(dn.ARTIFACTS / name), dn.load_shipped(kind, device="cpu"))
            for kind, name in dn.SHIPPED.items()}


def rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def nmse(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.sum(np.abs(a - b) ** 2) / np.sum(np.abs(b) ** 2))


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_shipped_npz_equal_orbax(kind):
    want = restore_flax(kind)["params"]
    got = dn.load_flax_npz(dn.ARTIFACTS / dn.SHIPPED[kind])["params"]
    assert set(got) == set(want) == {"Conv_0", "Conv_1", "Conv_2"}
    for layer in want:
        assert set(got[layer]) == {"kernel", "bias"}
        for leaf in ("kernel", "bias"):
            assert got[layer][leaf].dtype == want[layer][leaf].dtype
            assert np.array_equal(got[layer][leaf], want[layer][leaf]), (layer, leaf)
    shapes = {"1d": (13, 2, 48), "2d": (3, 9, 2, 32)}
    assert want["Conv_0"]["kernel"].shape == shapes[kind]


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_params_from_flax_matches_flax_apply(kind):
    """Random params (the zero-initialised last layer drawn too) and inputs:
    the port's module on params_from_flax(tree) against the flax module."""
    rng = np.random.default_rng(3)
    if kind == "1d":
        tree = jdn.init_params(jax.random.PRNGKey(1), n_re=40)
        x = rng.standard_normal((3, 40, 2)).astype(np.float32)
        flax_mod, port_mod = jdn.PilotDenoiser(), dn.PilotDenoiser()
    else:
        tree = jdn.init_params_2d(jax.random.PRNGKey(1), n_dsym=4, n_re=40)
        x = rng.standard_normal((3, 4, 40, 2)).astype(np.float32)
        flax_mod, port_mod = jdn.PilotDenoiser2D(), dn.PilotDenoiser2D()
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree)
    want = np.asarray(flax_mod.apply(tree, x))
    port_mod.load_state_dict(dn.params_from_flax(tree))
    with torch.no_grad():
        got = port_mod(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape and rel(got, want) <= 1e-5
    assert np.abs(want - x).max() > 0.1  # the residual branch is not zero
    # the complex wrappers: float64 in, the float32 convolution, float64 out
    h = (rng.standard_normal(x.shape[:-1]) + 1j * rng.standard_normal(x.shape[:-1]))
    j_fn, t_fn = ((jdn.apply_complex, dn.apply_complex) if kind == "1d"
                  else (jdn.apply_complex_2d, dn.apply_complex_2d))
    out = t_fn(dn.params_from_flax(tree), torch.as_tensor(h))
    assert out.dtype == torch.complex128 and rel(out.numpy(), np.asarray(j_fn(tree, h))) <= 1e-5


def test_halo_widths_and_identity_init():
    assert dn.halo_width() == jdn.halo_width() == 18
    assert dn.halo_width_2d() == jdn.halo_width_2d() == 12
    x = torch.randn(2, 30, 2)
    assert torch.equal(dn.PilotDenoiser()(x), x)
    x2 = torch.randn(2, 4, 30, 2)
    assert torch.equal(dn.PilotDenoiser2D()(x2), x2)


def test_module_cache_and_tf32_pin(shipped):
    """A params dict is moved to a device once; the module restores the
    caller's cudnn.allow_tf32 after pinning it off."""
    p = shipped["1d"][1]
    assert dn.module_for(p, False, "cpu") is dn.module_for(p, False, "cpu")
    assert dn.module_for(dict(p), False, "cpu") is not dn.module_for(p, False, "cpu")
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        dn.apply_complex(p, torch.ones(2, 24, dtype=torch.complex64))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    with pytest.raises(ValueError, match="kind"):
        dn.load_shipped("3d", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dn.load_shipped("1d")


LEARNED = [
    ("learned", "1d", dict(n_prbs=12, n_layers=2, smoothing="learned", cfo_hz=200.0)),
    ("learned_two_hops", "1d", dict(n_prbs=8, n_layers=1, smoothing="learned", two_hops=True)),
    ("learned2d", "2d", dict(n_prbs=12, n_layers=2, smoothing="learned2d", time_interp="linear",
                             doppler_hz=300.0)),
]
TIERS = [(k, lay) for k in ("xla", "pallas") for lay in ("ref", "serve", "factored")]


@pytest.mark.parametrize("kernels,layout", TIERS, ids=[f"{k}-{lay}" for k, lay in TIERS])
@pytest.mark.parametrize("name,kind,kw", LEARNED, ids=[n for n, _, _ in LEARNED])
def test_learned_build_ri_matches_jax(shipped, name, kind, kw, kernels, layout):
    c = synthetic.make_case(seed=3, snr_db=10.0, **kw)
    if layout == "factored" and c.config.time_interp != "none":
        with pytest.raises(ValueError, match="factored"):
            est.build_ri(c.hop1, c.hop2, c.config, 2, out_layout=layout)
        return
    nL = c.pilots.shape[2]
    rg = est.split_ri(c.received_rg)[None] * np.array([1.0, 1.1])[:, None, None, None]
    pil = np.broadcast_to(est.split_ri(c.pilots), (2, 2) + c.pilots.shape).copy()
    beta = np.full(2, c.beta)
    tree, params = shipped[kind]
    args = dict(batched=True, kernels=kernels, out_layout=layout)
    fn = est.build_ri(c.hop1, c.hop2, c.config, nL, **args)
    got = fn(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta), params)
    want = jest.build_ri(c.hop1, c.hop2, c.config, nL, **args)(rg, pil, beta, tree)
    field = "profiles" if layout == "factored" else "channel_est_rg"
    assert nmse(getattr(got, field), getattr(want, field)) <= 1e-10
    for f in SCALARS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="params"):
        fn(torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta))


def test_learned_pallas_front_refused():
    """kernels="pallas_front" refuses the learned smoothings, as the JAX
    builder does (_front_pallas_ok)."""
    for _, _, kw in LEARNED:
        c = synthetic.make_case(seed=3, **kw)
        with pytest.raises(ValueError, match="not eligible"):
            est.build_ri(c.hop1, c.hop2, c.config, c.pilots.shape[2], out_layout="serve",
                         kernels="pallas_front")


def test_untrained_2d_is_identity():
    """test_denoiser2d.py::test_untrained_2d_is_identity on the port: the
    zero-initialised residual makes untrained learned2d equal time_interp
    with smoothing "none"."""
    c = synthetic.make_case(seed=9, n_prbs=24, n_layers=2, snr_db=10.0, doppler_hz=200.0)
    cfg_2d = dataclasses.replace(c.config, smoothing="learned2d", time_interp="linear")
    cfg_none = dataclasses.replace(c.config, smoothing="none", time_interp="linear")
    rg, pil = est.split_ri(c.received_rg), est.split_ri(c.pilots)
    params = dn.PilotDenoiser2D().state_dict()
    out = est.build_ri(c.hop1, c.hop2, cfg_2d, 2)(rg, pil, c.beta, params)
    out_none = est.build_ri(c.hop1, c.hop2, cfg_none, 2)(rg, pil, c.beta)
    np.testing.assert_allclose(out.channel_est_rg.numpy(), out_none.channel_est_rg.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("name,kind,kw", LEARNED[::2], ids=[n for n, _, _ in LEARNED[::2]])
def test_learned_receiver_matches_jax(shipped, name, kind, kw):
    """build_receiver_ri with params, float64, factored (learned) and dense
    (learned2d has time interpolation), without and with the demapper."""
    mk = dict(kw, n_rx=2, modulation="qpsk", scramble=False, n_prbs=6)
    c = synthetic.make_mimo_case(seed=17, snr_db=15.0, **mk)
    nL = c.pilots.shape[2]
    tree, params = shipped[kind]
    rg = np.stack([est.split_ri(c.received_rg)] * 2)
    rg[1] *= 0.9
    pil = np.stack([est.split_ri(c.pilots)] * 2)
    beta = np.full(2, c.beta)
    for mod in (None, "qpsk"):
        a = dict(batched=True, modulation=mod)
        got = trcv.build_receiver_ri(c.hop1, c.hop2, c.config, nL, 2, device="cpu", **a)(
            torch.as_tensor(rg), torch.as_tensor(pil), torch.as_tensor(beta), params)
        want = jrcv.build_receiver_ri(c.hop1, c.hop2, c.config, nL, 2, **a)(rg, pil, beta, tree)
        if mod is None:
            assert nmse(got.x, want.x) <= 1e-10
        else:
            d = np.stack([np.abs(np.asarray(p, np.int16) - np.asarray(q, np.int16))
                          for p, q in zip(got.llr, want.llr)])
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        assert nmse(got.sinr, want.sinr) <= 1e-10
        np.testing.assert_allclose(got.noise_est, want.noise_est, rtol=1e-6)


def _probs(mod, cases):
    return [mod.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                        float(c.beta), c.hop1, c.hop2, c.config) for c in cases]


@pytest.mark.parametrize("out", ["grid", "factored", "equalized", "llrs"])
def test_process_params_matches_jax(shipped, out):
    """serving.process(params=...) in float32, both packages: a learned
    stream of two signatures over batch 2 with tail padding; learned2d in a
    call of its own (one shared params a call)."""
    cases = [synthetic.make_case(seed=40 + i, snr_db=20.0, **kw)
             for kw in (LEARNED[0][2], LEARNED[1][2]) for i in range(3)]
    runs = [("1d", cases)]
    if out in ("grid", "equalized", "llrs"):
        runs.append(("2d", [synthetic.make_case(seed=60 + i, snr_db=20.0, **LEARNED[2][2])
                            for i in range(3)]))
    kw = dict(batch_size=2, out=out, matmul_precision=None,
              modulation="qpsk" if out == "llrs" else None)
    for kind, cs in runs:
        tree, params = shipped[kind]
        want = js.process(_probs(js, cs), params=tree, **kw)
        got = ts.process(_probs(ts, cs), params=params, device="cpu", **kw)
        for g, w in zip(got, want):
            if out == "grid":
                assert rel(g.channel_est_rg, w.channel_est_rg) <= 1e-5
                assert nmse(g.channel_est_rg, w.channel_est_rg) <= 1e-10
            elif out == "factored":
                assert rel(g.profiles, w.profiles) <= 1e-5 and nmse(g.profiles, w.profiles) <= 1e-10
            elif out == "equalized":
                assert nmse(g.x, w.x) <= 1e-7 and rel(g.sinr, w.sinr) <= 1e-4
            else:
                d = np.abs(g.llr.astype(np.int16) - w.llr.astype(np.int16))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3
            np.testing.assert_allclose(g.noise_est, w.noise_est, rtol=1e-4)
        with pytest.raises(ValueError, match="needs params"):
            ts.process(_probs(ts, cs), device="cpu", **kw)


def test_process_decoded_params_matches_jax(shipped):
    """out="decoded" with learned smoothing, on the host and the device path:
    info and ok identical to the JAX package's and payload-exact."""
    seed = 5200
    code_j, code_t = jl.array_code(3, 8, 13), tl.array_code(3, 8, 13)
    coding_kw = dict(n_iters=20, interleave_seed=5, crc="crc16", early_iters=None)
    cj = jtr.TransportCoding(code=code_j, **coding_kw)
    ct = ttr.TransportCoding(code=code_t, **coding_kw)
    mk = dict(n_rx=2, modulation="qpsk", scramble=False, n_prbs=6, n_layers=1,
              smoothing="learned")
    geo = synthetic.make_mimo_case(seed=seed, snr_db=20.0, **mk)
    n_sc, n_sym = geo.data_mask.shape
    lay = jtr.layout(cj, geo.hop1, geo.hop2, n_sc, n_sym, 1, 2)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (lay.c_words, jtr.payload_bits(cj, jl.make_ldpc_plan(code_j).k)),
                     dtype=np.uint8)
    bits = jtr.place_codewords(lay, jl.encode(code_j, jtr.crc_attach(u, "crc16")), 1, 2,
                               fill_rng=rng)
    c = synthetic.make_mimo_case(seed=seed, snr_db=20.0, bits=bits, **mk)
    tree, params = shipped["1d"]
    kw = dict(batch_size=2, out="decoded", modulation="qpsk", matmul_precision=None)
    for on_device in (False, True):
        want = js.process(_probs(js, [c] * 3), params=tree, coding=cj,
                          decode_on_device=on_device, **kw)
        got = ts.process(_probs(ts, [c] * 3), params=params, coding=ct,
                         decode_on_device=on_device, device="cpu", **kw)
        for g, w in zip(got, want):
            assert np.array_equal(g.info, w.info) and np.array_equal(g.ok, w.ok)
            assert np.array_equal(g.info, u) and bool(np.all(g.ok))
        with pytest.raises(ValueError, match="needs params"):
            ts.process(_probs(ts, [c]), coding=ct, decode_on_device=on_device, device="cpu", **kw)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_artifacts()
