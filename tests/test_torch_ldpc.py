"""The port's LDPC decode path against the JAX package's, on the CPU.

`srsran_ce_tpu_torch.ops.ldpc`, `ops.nr_ldpc` and `transport` carry numpy
copies of the JAX package's code, plan, encoder, rate-matching and transport
helpers (held bit-identical here: arrays as raw bytes), and a PyTorch
`build_decoder` over the same tiers. The tiers are held to the JAX package's
with the same inputs, made with numpy:

- "xla" and "pallas" (the plain version of K4 on the CPU) against the JAX
  "xla" tier and the JAX Pallas kernel in interpret mode: bits, info and ok
  identical, the float32 posterior identical (min-sum is adds, subtracts and
  products by +-1 in the same order);
- "pallas_stream" (the plain version of K3) against the JAX streamed kernel in
  interpret mode: bits and ok identical, posterior identical in float32 and
  with bfloat16 messages (the same round-to-nearest-even of the same value);
- "xla_gather" against the JAX gather tier and the port's "xla" tier:
  posterior within rtol/atol 1e-5 (the JAX package's bound: the scatter-add
  association differs), bits and ok identical;
- BG1 at Z=384 (n = 26112) through the streamed tier against the float64
  `decode_reference`: payload-exact, bits and ok identical, posterior within
  1e-4 of its scale with float32 messages (the JAX package's bound) and 1e-2
  with bfloat16 messages (8 significant bits; the JAX package asserts the
  payload only).
The JAX Pallas kernels never run here at Z=384: interpret mode is minutes there.
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from srsran_ce_tpu import transport as jtr
from srsran_ce_tpu.ops import ldpc as jl
from srsran_ce_tpu.ops import nr_ldpc as jnr
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu_torch import transport as ttr
from srsran_ce_tpu_torch.ops import ldpc as tl
from srsran_ce_tpu_torch.ops import nr_ldpc as tnr
from srsran_ce_tpu_torch.ops.kernels import _build
from srsran_ce_tpu_torch.ops.kernels import ldpc as k4
from srsran_ce_tpu_torch.ops.kernels import ldpc_stream as k3
from srsran_ce_tpu_torch.utils import synthetic as tsyn

IRREGULAR = ((0, 2, -1, 1, -1, 0), (-1, 1, 0, -1, 3, 0), (2, -1, 1, 0, -1, -1))

# the five codes of the JAX bench's decode rows, then the small codes of its tests
CODES = {
    "n976": lambda m: m.array_code(6, 16, 61),
    "bg2_z208": lambda m: (jnr if m is jl else tnr).nr_base_graph(2, 208),
    "bg1_z52": lambda m: (jnr if m is jl else tnr).nr_base_graph(1, 52),
    "bg1_z384": lambda m: (jnr if m is jl else tnr).nr_base_graph(1, 384),
    "array_4_11_13": lambda m: m.array_code(4, 11, 13),
    "irregular_z7": lambda m: m.QCLdpcCode(base=IRREGULAR, z=7),
    "bg2_z16": lambda m: (jnr if m is jl else tnr).nr_base_graph(2, 16),
    "bg2_z144": lambda m: (jnr if m is jl else tnr).nr_base_graph(2, 144),
}


def same(a, b, path="root"):
    """Bit-identity of two values built by the two packages."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def awgn(code, plan, batch, snr_db, seed, encode):
    """(info bits, float32 LLRs) of `batch` words through BPSK + AWGN, as the JAX bench makes them."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, plan.k), dtype=np.uint8)
    cw = encode(code, u)
    snr = 10.0 ** (snr_db / 10)
    llr = 4 * snr * ((1 - 2.0 * cw) + rng.normal(0, np.sqrt(0.5 / snr), cw.shape))
    return u, llr.astype(np.float32)


def pair(name):
    return CODES[name](jl), CODES[name](tl)


def jax_tier(dec) -> str:
    """The tier a JAX `build_decoder` closure runs (its `kernels` after routing)."""
    return inspect.getclosurevars(dec.__wrapped__).nonlocals["kernels"]


def assert_result(got, want, posterior="equal"):
    for f in ("bits", "info", "ok"):
        same(np.asarray(getattr(want, f)), getattr(got, f).numpy(), f)
    p_t, p_j = got.posterior.numpy(), np.asarray(want.posterior)
    assert p_t.dtype == p_j.dtype and p_t.shape == p_j.shape
    if posterior == "equal":
        assert np.array_equal(p_t, p_j), np.abs(p_t - p_j).max()
    else:
        np.testing.assert_allclose(p_t, p_j, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# numpy copies: plans, encoders, NR helpers, transport
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CODES))
def test_plan_and_encode_identical(name):
    jc, tc = pair(name)
    assert jc.base == tc.base and jc.z == tc.z and (jc.n, jc.k) == (tc.n, tc.k)
    jp, tp = jl.make_ldpc_plan(jc), tl.make_ldpc_plan(tc)
    for f in ("max_degree", "slot_var", "slot_shift", "slot_valid", "edges", "nr_structure",
              "rank", "k", "info_cols", "parity_cols"):
        same(getattr(jp, f), getattr(tp, f), f)
    assert (jp.parity_gen is None) == (tp.parity_gen is None)
    if jp.parity_gen is not None:
        same(jp.parity_gen, tp.parity_gen)
    u = np.random.default_rng(len(name)).integers(0, 2, (3, jp.k), dtype=np.uint8)
    same(jl.encode(jc, u), tl.encode(tc, u))
    # the routing models: the port keeps the JAX package's TPU models for auto and G
    assert tl.default_layered_group(tc) == jl.default_layered_group(jc)
    assert tl._pallas_layout(tc) == jl._pallas_layout(jc)
    assert tl._edge_z(tc) == jl._edge_z(jc)
    for g in (1, 2, 8):
        for bf in (False, True):
            assert tl._stream_layout(tc, bf, g) == jl._stream_layout(jc, bf, g)


def test_structured_encoder_full_width():
    """BG1 at Z=384 encodes through the structured path; every check satisfied."""
    jc, tc = pair("bg1_z384")
    tp = tl.make_ldpc_plan(tc)
    assert tp.nr_structure is not None and tp.parity_gen is None and tp.k == 8448
    u = np.random.default_rng(9).integers(0, 2, (4, tp.k), dtype=np.uint8)
    cw = tl.encode(tc, u)
    same(jl.encode(jc, u), cw)
    bits, ok, _ = tl.decode_reference(tc, (1 - 2.0 * cw) * 4.0, n_iters=1)
    assert ok.all() and np.array_equal(bits, cw) and np.array_equal(cw[:, tp.info_cols], u)


@pytest.mark.parametrize("bg,z,e,qm,rv,n_filler", [
    (2, 16, 200, 2, 0, 0), (2, 16, 1024, 4, 2, 8), (1, 52, 1500, 2, 1, 0), (1, 384, 16896, 2, 0, 0),
    (2, 208, 6000, 6, 3, 40), (1, 64, 5000, 8, 0, 24),
])
def test_rate_match_identical(bg, z, e, qm, rv, n_filler):
    nbv = 68 if bg == 1 else 52
    same(jnr.make_rate_match(bg, z, nbv, e, qm=qm, rv=rv, n_filler=n_filler),
         tnr.make_rate_match(bg, z, nbv, e, qm=qm, rv=rv, n_filler=n_filler))


def test_nr_helpers_identical():
    same(jnr.lifting_sizes(), tnr.lifting_sizes())
    for z in jnr.lifting_sizes():
        assert jnr.lifting_set_index(z) == tnr.lifting_set_index(z)
    for bg in (1, 2):
        same(jnr.base_graph_params(bg), tnr.base_graph_params(bg))
        same(jnr.export_base_graph_entries(bg, seed=3), tnr.export_base_graph_entries(bg, seed=3))
        for kp in (40, 500, 2000, 3840, 8448):
            if kp <= (8448 if bg == 1 else 3840):
                assert jnr.select_lifting_size(bg, kp) == tnr.select_lifting_size(bg, kp)
        for b in (100, 3000, 9000, 30000, 100000):
            same(jnr.segment_payload(b, bg), tnr.segment_payload(b, bg))
            c, kp = tnr.segment_payload(b, bg)
            assert jnr.desegment_payload(c, kp, b) == tnr.desegment_payload(c, kp, b)
    for a, r in ((200, 0.2), (3000, 0.5), (300, 0.9), (9000, 0.7)):
        assert jnr.select_base_graph(a, r) == tnr.select_base_graph(a, r)
    for bg, z in ((1, 2), (1, 384), (2, 16), (2, 144), (2, 208), (2, 384)):
        assert jnr.nr_base_graph(bg, z).base == tnr.nr_base_graph(bg, z).base


def test_official_table_loader_identical(tmp_path):
    import json

    for bg in (1, 2):
        p = tmp_path / f"bg{bg}.json"
        p.write_text(json.dumps(jnr.export_base_graph_entries(bg, seed=5)))
        for z in (16, 208):
            jc = jnr.load_official_base_graph(p, z, strict=False)
            tc = tnr.load_official_base_graph(p, z, strict=False)
            assert jc.base == tc.base and jc.z == tc.z
        # the stand-in's edge count is not the published one: strict mode refuses it alike
        with pytest.raises(ValueError) as je:
            jnr.load_official_base_graph(p, 16)
        with pytest.raises(ValueError) as te:
            tnr.load_official_base_graph(p, 16)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kind", ["crc24a", "crc24b", "crc16", "crc11", "crc6"])
def test_crc_identical(kind):
    bits = np.random.default_rng(len(kind)).integers(0, 2, (5, 300), dtype=np.uint8)
    same(jtr.crc_bits(bits, kind), ttr.crc_bits(bits, kind))
    words = ttr.crc_attach(bits, kind)
    same(jtr.crc_attach(bits, kind), words)
    words[1, 7] ^= 1
    same(jtr.crc_check(words, kind), ttr.crc_check(words, kind))
    assert ttr.crc_check(words, kind).tolist() == [True, False, True, True, True]


@pytest.mark.parametrize("shape", [(24, 8424), (3, 1), (7, 2), (5, 33), (4, 3, 8424), (2, 8, 5),
                                   (1,), (8424,), (6, 8), (6, 9), (6, 16)],
                         ids=["e2e_span", "m1", "m2", "m33", "3d_e2e", "3d_m5", "1d_m1", "1d_e2e",
                              "m8", "m9", "m16"])
@pytest.mark.parametrize("kind", ["crc24a", "crc24b", "crc16", "crc11", "crc6"])
def test_crc_identical_across_spans(kind, shape):
    """The port's CRC (one cached table entry per message byte) against the
    JAX package's bit-serial register: the e2e row's 24 words of 8424 bits,
    message length 1, other short lengths and whole and part bytes, leading
    axes of 0-2 dimensions."""
    bits = np.random.default_rng(sum(shape) + len(kind)).integers(0, 2, shape, dtype=np.uint8)
    same(jtr.crc_bits(bits, kind), ttr.crc_bits(bits, kind))
    words = ttr.crc_attach(bits, kind)
    same(jtr.crc_attach(bits, kind), words)
    assert ttr.crc_check(words, kind).all()
    words[..., -1] ^= 1  # every word's last parity bit flipped
    same(jtr.crc_check(words, kind), ttr.crc_check(words, kind))
    assert not ttr.crc_check(words, kind).any()


@pytest.mark.parametrize("kind", ["crc24b", "crc6"])
def test_crc_empty_message_raises_like_jax(kind):
    empty = np.zeros((3, 0), np.uint8)
    with pytest.raises(ValueError):
        jtr.crc_bits(empty, kind)
    with pytest.raises(ValueError):
        ttr.crc_bits(empty, kind)


@pytest.mark.parametrize("rate_match,n_filler,tx_bits,nbits", [
    ("nr", 16, None, 2), ("nr", 0, 1000, 4), ("nr", 0, 2400, 2), ("circular", 0, None, 2),
    ("circular", 0, 900, 2),
])
def test_transport_layout_identical(rate_match, n_filler, tx_bits, nbits):
    """The test_nr_ldpc.py:146 geometry (24 PRB, one layer) from each package's HopConfig."""
    kw = dict(seed=11, n_prbs=24, n_layers=1, comb=2, snr_db=30.0)
    jcase, tcase = jsyn.make_case(**kw), tsyn.make_case(**kw)
    n_sc, n_sym = tcase.received_rg.shape
    out = {}
    for mod, case, m in ((jtr, jcase, jnr), (ttr, tcase, tnr)):
        code = m.nr_base_graph(2, 32)
        coding = mod.TransportCoding(code=code, rate_match=rate_match, n_filler=n_filler,
                                     tx_bits=tx_bits, crc="crc11", rv=1, interleave_seed=4)
        lay = mod.layout(coding, case.hop1, case.hop2, n_sc, n_sym, 1, nbits)
        rng = np.random.default_rng(5)
        k_pay = mod.payload_bits(coding, lay.k)
        u = rng.integers(0, 2, (lay.c_words, k_pay), np.uint8)
        words = mod.crc_attach(u, "crc11")
        words = np.concatenate([words, np.zeros((lay.c_words, n_filler), np.uint8)], axis=1)
        cw = (jl if mod is jtr else tl).encode(code, words)
        bits = mod.place_codewords(lay, cw, 1, nbits, fill_rng=rng)
        llr = ((1 - 2.0 * bits) * 20.0).astype(np.float32)
        llr8 = np.clip(llr * 3, -127, 127).astype(np.int8)
        out[mod] = dict(
            mask=mod.data_mask(case.hop1, case.hop2, n_sc, n_sym), lay=lay, k_pay=k_pay,
            bits=bits, streams=mod.extract_streams(lay, llr), streams8=mod.extract_streams(lay, llr8),
            tables=mod.device_extract_tables(lay, nbits, 1, n_sym, n_sc),
            planes=mod.scramble_planes(0x1234, n_sc, n_sym, 2, nbits),
            combined=mod.combine_llrs([llr8, llr8]), combined_f=mod.combine_llrs([llr, llr]),
        )
    same(out[jtr], out[ttr])


# ---------------------------------------------------------------------------
# decoder tiers against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["irregular_z7", "array_4_11_13"])
@pytest.mark.parametrize("kernels,schedule,group", [
    ("xla", "flooding", 1), ("pallas", "flooding", 1), ("pallas", "layered", 1),
    ("pallas", "layered", 2), ("pallas", "layered", 4),
])
def test_unrolled_and_k4_plain_match_jax(name, kernels, schedule, group):
    jc, tc = pair(name)
    rng = np.random.default_rng(len(name) + group)
    llr = rng.normal(0.0, 2.5, (5, jc.n)).astype(np.float32)
    kw = dict(n_iters=5, kernels=kernels, schedule=schedule, layered_group=group)
    dec = tl.build_decoder(tc, device="cpu", **kw)
    assert dec.tier == kernels
    assert_result(dec(llr), jl.build_decoder(jc, **kw)(llr))


@pytest.mark.parametrize("kernels,schedule,group", [
    ("xla", "flooding", 1), ("pallas", "flooding", 1), ("pallas", "layered", 2),
])
def test_int8_llrs_with_leading_axes_match_jax(kernels, schedule, group):
    """int8 LLRs (the receiver's soft bits) of shape (2, 3, n)."""
    jc, tc = pair("array_4_11_13")
    u, llr = awgn(tc, tl.make_ldpc_plan(tc), 6, 1.0, 21, tl.encode)
    llr8 = np.clip(np.rint(llr * 4), -127, 127).astype(np.int8).reshape(2, 3, -1)
    kw = dict(n_iters=6, kernels=kernels, schedule=schedule, layered_group=group)
    got = tl.build_decoder(tc, device="cpu", **kw)(llr8)
    assert got.bits.shape == (2, 3, tc.n) and got.info.shape == (2, 3, u.shape[1])
    assert got.ok.shape == (2, 3) and got.posterior.dtype == torch.float32
    assert_result(got, jl.build_decoder(jc, **kw)(llr8))
    # a tensor in is decoded on its own device, the same as the numpy array
    same(got.posterior.numpy(), tl.build_decoder(tc, device="cpu", **kw)(torch.as_tensor(llr8))
         .posterior.numpy())


def test_float64_runs_on_the_plain_tiers():
    jc, tc = pair("array_4_11_13")
    llr = np.random.default_rng(2).normal(0.0, 2.5, (3, jc.n))
    for kernels in ("xla", "pallas"):
        got = tl.build_decoder(tc, n_iters=4, kernels=kernels, device="cpu")(llr)
        assert got.posterior.dtype == torch.float64
        assert_result(got, jl.build_decoder(jc, n_iters=4, kernels=kernels)(llr))
    _, _, post = tl.decode_reference(tc, llr, n_iters=4)
    np.testing.assert_allclose(got.posterior.numpy(), post, rtol=0, atol=1e-12)


# z = 128 fills the JAX kernel's 128 lanes, z = 144 pads them; every pair of
# (z, G), (z, message type) and (G, message type) is covered once (the JAX
# kernel in interpret mode takes 3-25 s a case)
@pytest.mark.parametrize("z,group,c2v", [
    (128, 1, None), (144, 3, None), (128, 3, "bfloat16"), (144, 1, "bfloat16"),
])
def test_k3_plain_matches_jax_stream_kernel(z, group, c2v):
    jc, tc = jnr.nr_base_graph(2, z), tnr.nr_base_graph(2, z)
    u, llr = awgn(tc, tl.make_ldpc_plan(tc), 2, 3.5, z + group, tl.encode)
    kw = dict(n_iters=3, kernels="pallas_stream", schedule="layered", layered_group=group,
              stream_c2v_dtype=c2v)
    got = tl.build_decoder(tc, device="cpu", **kw)(llr)
    assert_result(got, jl.build_decoder(jc, **kw)(llr))
    assert bool(got.ok.all()) and np.array_equal(got.info.numpy(), u)


@pytest.mark.parametrize("name", ["irregular_z7", "array_4_11_13", "bg2_z16"])
def test_gather_tier_matches_jax_and_unrolled(name):
    jc, tc = pair(name)
    llr = np.random.default_rng(5).normal(0.0, 2.5, (6, jc.n)).astype(np.float32)
    got = tl.build_decoder(tc, n_iters=7, kernels="xla_gather", device="cpu")(llr)
    assert_result(got, jl.build_decoder(jc, n_iters=7, kernels="xla_gather")(llr), posterior="close")
    unrolled = tl.build_decoder(tc, n_iters=7, kernels="xla", device="cpu")(llr)
    np.testing.assert_allclose(got.posterior.numpy(), unrolled.posterior.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(got.bits, unrolled.bits) and torch.equal(got.ok, unrolled.ok)


@pytest.mark.parametrize("schedule,group", [("flooding", 1), ("layered", 1), ("layered", 3)])
def test_decode_reference_identical(schedule, group):
    jc, tc = pair("bg2_z16")
    _, llr = awgn(tc, tl.make_ldpc_plan(tc), 3, 0.5, 8, tl.encode)
    kw = dict(n_iters=5, schedule=schedule, layered_group=group)
    same(jl.decode_reference(jc, llr, **kw), tl.decode_reference(tc, llr, **kw))


@pytest.mark.parametrize("c2v,bound", [(None, 1e-4), ("bfloat16", 1e-2)])
def test_full_width_streamed_decode_on_cpu(c2v, bound):
    """The slice at full width: NR BG1, Z=384, 8 layered sweeps, 4 words at the bench's 3.5 dB."""
    tc = tnr.nr_base_graph(1, 384)
    u, llr = awgn(tc, tl.make_ldpc_plan(tc), 4, 3.5, 0, tl.encode)
    dec = tl.build_decoder(tc, n_iters=8, kernels="pallas_stream", schedule="layered",
                           stream_c2v_dtype=c2v, device="cpu")
    res = dec(llr)
    bits, ok, post = tl.decode_reference(tc, llr, n_iters=8, schedule="layered")
    assert ok.all() and np.array_equal(res.info.numpy(), u)
    assert np.array_equal(res.bits.numpy(), bits) and np.array_equal(res.ok.numpy(), ok)
    assert np.abs(res.posterior.double().numpy() - post).max() / np.abs(post).max() <= bound


# ---------------------------------------------------------------------------
# routing, gates, no fallback
# ---------------------------------------------------------------------------

ROUTES = [(name, sched, g, c2v) for name in CODES for sched, g, c2v in
          (("flooding", 1, None), ("layered", 1, None), ("layered", 2, "bfloat16"), ("layered", 8, None))]


@pytest.mark.parametrize("name,schedule,group,c2v", ROUTES)
def test_auto_routing_matches_jax(name, schedule, group, c2v, monkeypatch):
    """auto and the layered redirect pick the JAX package's tier: on the CPU
    (the JAX CPU backend), and on an accelerator (a CUDA device, as a pure
    function, against the JAX package with its backend reported as "tpu")."""
    jc, tc = pair(name)
    kw = dict(kernels="auto", schedule=schedule, layered_group=group, stream_c2v_dtype=c2v)
    for accel in (False, True):
        jl.build_decoder.cache_clear()
        if accel:
            monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
        try:
            want = jax_tier(jl.build_decoder(jc, n_iters=2, **kw))
        except ValueError:
            want = ValueError
        finally:
            jl.build_decoder.cache_clear()
            monkeypatch.undo()
        try:
            got = tl.select_tier(tc, accelerator=accel, **kw)
        except ValueError:
            got = ValueError
        assert got == want, (accel, got, want)
        if not accel and got is not ValueError:
            assert tl.build_decoder(tc, n_iters=2, device="cpu", **kw).tier == got
    if schedule == "layered":
        # an explicit plain tier with schedule="layered" moves to the kernel tier as in JAX
        try:
            want = jax_tier(jl.build_decoder(jc, n_iters=2, **dict(kw, kernels="xla")))
        except ValueError:
            want = ValueError
        try:
            got = tl.select_tier(tc, **dict(kw, kernels="xla"))
        except ValueError:
            got = ValueError
        assert got == want


@pytest.mark.parametrize("code_fn,kw", [
    (lambda m: m.array_code(4, 11, 13), dict(kernels="pallas_stream", schedule="flooding")),
    (lambda m: m.array_code(16, 64, 1021), dict(kernels="xla", schedule="layered")),
    (lambda m: m.array_code(16, 64, 1021), dict(kernels="pallas")),
    (lambda m: (jnr if m is jl else tnr).nr_base_graph(1, 384),
     dict(kernels="pallas_stream", schedule="layered", layered_group=16)),
    (lambda m: (jnr if m is jl else tnr).nr_base_graph(1, 384),
     dict(kernels="xla_gather", schedule="layered", layered_group=16)),
    (lambda m: (jnr if m is jl else tnr).nr_base_graph(1, 384),
     dict(kernels="auto", schedule="layered")),
])
def test_value_error_gates_match_jax(code_fn, kw):
    with pytest.raises(ValueError) as je:
        jl.build_decoder(code_fn(jl), n_iters=2, **kw)
    with pytest.raises(ValueError) as te:
        tl.build_decoder(code_fn(tl), n_iters=2, device="cpu", **kw)
    assert str(te.value) == str(je.value)


def test_bad_arguments_raise():
    code = tl.array_code(3, 8, 13)
    with pytest.raises(ValueError, match="unknown kernels"):
        tl.build_decoder(code, kernels="triton", device="cpu")
    with pytest.raises(ValueError, match="unknown schedule"):
        tl.build_decoder(code, schedule="serial", device="cpu")
    with pytest.raises(ValueError, match="c2v_dtype"):
        tl.build_decoder(tnr.nr_base_graph(2, 16), kernels="pallas_stream", schedule="layered",
                         stream_c2v_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match=r"\(\.\.\., n=104\)"):
        tl.build_decoder(code, device="cpu")(np.zeros((2, 103), np.float32))


def test_no_fallback_off_the_cpu(monkeypatch, tmp_path):
    """The entry point defaults to the card and raises without one; a tensor on
    another device reaches the kernel's checks, never the plain version; with
    no nvcc the kernels' build raises."""
    code = tl.array_code(3, 8, 13)
    plan = tl.make_ldpc_plan(code)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.build_decoder(code, n_iters=3)
    meta = torch.empty((2, code.n), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k4.ldpc_posterior(meta, plan, 2, 0.75)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        k3.ldpc_stream_posterior(meta, plan, 2, 0.75)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k4.check_args(torch.zeros((2, code.n)), plan, 1)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    for name in ("ldpc", "ldpc_stream"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)


def test_wrappers_take_the_plain_version_on_cpu():
    code = tnr.nr_base_graph(2, 16)
    plan = tl.make_ldpc_plan(code)
    _, llr = awgn(code, plan, 3, 1.0, 4, tl.encode)
    ch = torch.as_tensor(llr)
    n3, n4 = k3.launches, k4.launches
    for sched, g in (("flooding", 1), ("layered", 2)):
        assert torch.equal(k4.ldpc_posterior(ch, plan, 3, 0.75, sched, g),
                           k4.ldpc_posterior_plain(ch, plan, 3, 0.75, sched, g))
    for c2v in (None, "bfloat16"):
        assert torch.equal(k3.ldpc_stream_posterior(ch, plan, 3, 0.75, 3, c2v),
                           k3.ldpc_stream_posterior_plain(ch, plan, 3, 0.75, 3, c2v))
    assert (k3.launches, k4.launches) == (n3, n4)
    # flooding K4 plain is the "xla" tier's arithmetic; layered K3 plain at G=1 is K4's
    dec = tl.build_decoder(code, n_iters=3, kernels="xla", device="cpu")
    assert torch.equal(dec(ch).posterior, k4.ldpc_posterior_plain(ch, plan, 3, 0.75))
    assert torch.equal(k3.ldpc_stream_posterior_plain(ch, plan, 3, 0.75),
                       k4.ldpc_posterior_plain(ch, plan, 3, 0.75, "layered"))


# ---------------------------------------------------------------------------
# the kernels' compressed check-row records (csrc/ldpc_common.cuh), modelled
# in float32 torch: each row keeps one record per lane, {r1, r2} in the
# message type and a word i1 | message sign bits << 5; old messages and
# deltas are rebuilt from records. Held bit for bit (int32 views, so -0.0 is
# told from +0.0) to the plain versions.
# ---------------------------------------------------------------------------


def rec_msgs(rec, deg):
    """(B, deg, z) messages of slots 0 .. deg-1 rebuilt from a row's records."""
    r1, r2, word = rec
    t = torch.arange(deg)[None, :, None]
    mag = torch.where(t == (word & 31)[:, None], r2[:, None], r1[:, None])
    return torch.where(((word[:, None] >> (t + 5)) & 1) == 1, -mag, mag)


def min_fold(m, t0, t1):
    """(m1, m2, i1) of the sequential two-min fold over slots t0 .. t1 - 1 of
    the magnitudes m (axis 1): strict <, so the first minimum wins a tie; an
    empty range gives (inf, BIG, t0), which never wins a merge."""
    m1, m2 = torch.full_like(m[:, 0], float("inf")), torch.full_like(m[:, 0], k4.BIG)
    i1 = torch.full(m1.shape, t0, dtype=torch.int64)
    for t in range(t0, t1):
        if t == t0:
            m1 = m[:, t]
        else:
            less = m[:, t] < m1
            m2 = torch.where(less, m1, torch.minimum(m2, m[:, t]))
            i1 = torch.where(less, t, i1)
            m1 = torch.where(less, m[:, t], m1)
    return m1, m2, i1


def halves_fold(m):
    """The pair route's fold (pair_row): each of two threads takes N = (deg +
    1) // 2 slots, [0, N) and [deg - N, deg); with deg odd the upper one
    masks the shared slot N - 1 (+inf). Each folds as min / max, m1 =
    min(m1, m), m2 = min(m2, max(m1, m)), i1 moving on a strictly less
    magnitude, and the two merge: the upper half's minimum only where
    strictly less, and m2 the least of the other three values."""
    deg = m.shape[1]
    n = (deg + 1) // 2
    inf = torch.full_like(m[:, 0], float("inf"))

    def fold(t0, dup):
        m1, m2 = inf, torch.full_like(inf, k4.BIG)
        i1 = torch.full(m1.shape, t0, dtype=torch.int64)
        for u in range(n):
            mu = inf if (u == 0 and dup) else m[:, t0 + u]
            i1 = torch.where(mu < m1, t0 + u, i1)
            m2 = torch.minimum(m2, torch.maximum(m1, mu))
            m1 = torch.minimum(m1, mu)
        return m1, m2, i1

    (a1, a2, ai), (b1, b2, bi) = fold(0, False), fold(deg - n, 2 * n != deg)
    less = b1 < a1
    return (torch.where(less, b1, a1),
            torch.where(less, torch.minimum(a1, b2), torch.minimum(a2, b1)),
            torch.where(less, bi, ai))


def rec_fold(v, norm, mdt, halves=False):
    """A check lane's fold over the slots (axis 1) of v = L - old: the two
    minima (strict <, so the first minimum wins a tie), the parity, and the
    new record (r1, r2 rounded to the message type, the word); with `halves`
    the pair route's fold of the two halves."""
    deg = v.shape[1]
    m = v.abs()
    m1, m2, i1 = halves_fold(m) if halves else min_fold(m, 0, deg)
    negs = torch.zeros(m1.shape, dtype=torch.int64)
    for t in range(deg):
        negs |= (v[:, t] < 0).long() << t
    par = (v < 0).sum(1) % 2
    signs = torch.where(par == 1, negs ^ ((1 << deg) - 1), negs)
    stored = lambda x: (x * norm).to(mdt).float()
    return stored(m1), stored(m2), i1 | (signs << 5)


def zero_records(w, batch):
    return [(torch.zeros(batch, w.z), torch.zeros(batch, w.z),
             torch.zeros(batch, w.z, dtype=torch.int64)) for _ in range(w.mb)]


def layered_records(ch, w, n_iters, norm, group, mdt, halves=False):
    """The layered sweep on records: a group's new records from one L
    snapshot, then each row's delta (new message - old message) applied;
    with `halves` each record from the pair route's fold."""
    L = ch.clone()
    recs = zero_records(w, ch.shape[0])
    rows = [(w.row_ptr[i], w.row_ptr[i + 1]) for i in range(w.mb)]
    for _ in range(n_iters):
        for g0 in range(0, w.mb, group):
            grp = range(g0, min(g0 + group, w.mb))
            old = {i: recs[i] for i in grp}
            for i in grp:
                r0, r1 = rows[i]
                recs[i] = rec_fold(L[:, w.gidx[r0:r1]] - rec_msgs(recs[i], r1 - r0), norm, mdt,
                                   halves)
            for i in grp:
                r0, r1 = rows[i]
                idx = w.gidx[r0:r1]
                L[:, idx] = L[:, idx] + (rec_msgs(recs[i], r1 - r0) - rec_msgs(old[i], r1 - r0))
    return L


def flooding_records(ch, plan, w, n_iters, norm):
    """The flooding sweep on records: each column's sum of messages (edge
    order, row i's message t at lane (a - s) mod z) onto the LLRs, then every
    row's new record from L."""
    B = ch.shape[0]
    recs = zero_records(w, B)
    ch3 = ch.reshape(B, w.nb, w.z)

    def accum():
        acc = [ch3[:, j] for j in range(w.nb)]
        for i, t, j, s in plan.edges:
            acc[j] = acc[j] + torch.roll(rec_msgs(recs[i], t + 1)[:, t], s % w.z, dims=-1)
        return torch.stack(acc, 1).reshape(B, -1)

    for _ in range(n_iters):
        L = accum()
        for i in range(w.mb):
            r0, r1 = w.row_ptr[i], w.row_ptr[i + 1]
            recs[i] = rec_fold(L[:, w.gidx[r0:r1]] - rec_msgs(recs[i], r1 - r0), norm, torch.float32)
    return accum()


RECORD_CODES = {
    "irregular_z7": lambda: tl.QCLdpcCode(base=IRREGULAR, z=7),
    "bg2_z16": lambda: tnr.nr_base_graph(2, 16),
    "bg1_z8": lambda: tnr.nr_base_graph(1, 8),  # the BG1 stand-in: rows of degree 21 and 22
}


def record_llrs(code, kind):
    """(4, n) float32 LLRs: Gaussian, or crafted from a few magnitudes with
    exact zeros of both signs, so first-minimum ties and -0.0 occur."""
    rng = np.random.default_rng(code.n)
    if kind == "gauss":
        return torch.as_tensor(rng.normal(0.0, 2.0, (4, code.n)).astype(np.float32))
    vals = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.0], np.float32)
    return torch.as_tensor(vals[rng.integers(0, vals.size, (4, code.n))])


@pytest.mark.parametrize("kind", ["gauss", "ties"])
@pytest.mark.parametrize("schedule,group,c2v", [
    ("layered", 1, None), ("layered", 1, "bfloat16"), ("layered", 3, None),
    ("layered", 3, "bfloat16"), ("flooding", 1, None), ("layered_pair", 1, None),
    ("layered_pair", 1, "bfloat16"),
])
@pytest.mark.parametrize("name", list(RECORD_CODES))
def test_record_arithmetic_matches_plain(name, schedule, group, c2v, kind):
    code = RECORD_CODES[name]()
    plan = tl.make_ldpc_plan(code)
    w = k4.wiring(plan, "cpu")
    assert w.d <= k4.MAX_DEGREE
    ch = record_llrs(code, kind)
    if schedule == "flooding":
        got = flooding_records(ch, plan, w, 4, 0.75)
        want = k4.flooding_plain(ch, plan, w, 4, 0.75)
    else:
        mdt = torch.bfloat16 if c2v else torch.float32
        got = layered_records(ch, w, 4, 0.75, group, mdt, halves=schedule == "layered_pair")
        want = k3.ldpc_stream_posterior_plain(ch, plan, 4, 0.75, group, c2v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (got - want).abs().max()


@pytest.mark.parametrize("deg", [1, 2, 3, 4, 7, 8, 11, 14, 19, 21, 22, 27])
def test_halves_fold_is_the_sequential_fold(deg):
    """The pair route's merge of two half folds gives the sequential fold's
    (m1, m2, i1) bit for bit at every degree of the three buckets, on
    magnitudes drawn from a few values (ties everywhere, within a half and
    across the boundary) and below the mask value BIG: the first minimum
    wins a tie, in the lower half too."""
    rng = np.random.default_rng(deg)
    vals = np.array([0.0, 0.5, 1.0, 2.0, 1e29], np.float32)
    m = torch.as_tensor(vals[rng.integers(0, vals.size, (4096, deg))])
    h = (deg + 1) // 2
    if deg > 1:  # equal minima straddling the boundary; the least at the upper half's first slot
        m[0], m[1] = 2.0, 2.0
        m[0, h - 1] = m[0, h] = 0.5
        m[1, h] = 0.25
    got, want = halves_fold(m), min_fold(m, 0, deg)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    if deg > 1:
        assert int(got[2][0]) == h - 1 and int(got[2][1]) == h


def plain_fold(m):
    """(m1, m2, i1) as the plain version's check_update takes them: the first
    minimum (argmin), and the least of the other magnitudes and BIG."""
    i1 = m.argmin(1)
    onehot = torch.arange(m.shape[1])[None] == i1[:, None]
    return m.gather(1, i1[:, None])[:, 0], torch.where(onehot, k4.BIG, m).amin(1), i1


@pytest.mark.parametrize("deg", [1, 2, 3, 4, 7, 8, 11, 14, 19, 21, 22, 27])
def test_halves_fold_is_the_plain_fold_at_any_magnitude(deg):
    """At and above the mask value BIG, +inf included, the pair route's fold
    is the plain version's (m2 never above BIG), ties across the halves'
    boundary too; the sequential fold leaves BIG out where the first minimum
    is past slot 0."""
    rng = np.random.default_rng(100 + deg)
    vals = np.array([0.0, 0.5, 1e29, 1e30, 2e30, 1e31, 3e33, np.inf], np.float32)
    m = torch.as_tensor(vals[rng.integers(0, vals.size, (4096, deg))])
    m[0] = float("inf")
    if deg > 1:
        m[1] = 3e33
        m[1, deg - 1] = 2e30
    for g, w_ in zip(halves_fold(m), plain_fold(m)):
        assert torch.equal(g, w_)
    if deg > 1:
        f32 = lambda x: float(np.float32(x))
        assert float(halves_fold(m)[1][1]) == f32(k4.BIG) and float(min_fold(m, 0, deg)[1][1]) == f32(3e33)


def saturated_llrs(n, batch, seed):
    """(batch, n) float32 LLRs: Gaussian, with 30 % of them saturated to
    +-1e30 .. 3e33 (at and above BIG, finite through the sweeps)."""
    rng = np.random.default_rng(seed)
    llr = rng.normal(0.0, 2.0, (batch, n)).astype(np.float32)
    big = np.array([1e30, 2e30, 1e31, 3e33], np.float32)
    hit = rng.random((batch, n)) < 0.3
    llr[hit] = np.copysign(big[rng.integers(0, big.size, int(hit.sum()))], llr[hit])
    return torch.as_tensor(llr)


@pytest.mark.parametrize("c2v", [None, "bfloat16"])
@pytest.mark.parametrize("name", list(RECORD_CODES))
def test_pair_records_match_plain_on_saturated_llrs(name, c2v):
    """The layered sweep on records with the pair route's fold, on LLRs at
    and above BIG: bit for bit the plain version's."""
    code = RECORD_CODES[name]()
    plan = tl.make_ldpc_plan(code)
    w = k4.wiring(plan, "cpu")
    ch = saturated_llrs(code.n, 4, code.n)
    mdt = torch.bfloat16 if c2v else torch.float32
    got = layered_records(ch, w, 4, 0.75, 1, mdt, halves=True)
    want = k3.ldpc_stream_posterior_plain(ch, plan, 4, 0.75, 1, c2v)
    assert torch.isfinite(want).all() and torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# the launch plan (routes, shared memory, codewords a block) on the CPU; the
# card's tests hold it to the kernels' own plan (srs_ldpc_plan)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,batch,msg_bytes,layered,group,route,smem,scratch,cpb", [
    ("bg2_z208", 128, 4, False, 1, "chip", 191360 + 2560, 0, 1),  # LLRs, L, 42 x 208 records
    ("bg2_z208", 128, 4, True, 8, "chip", 43264 + 104832 + 8 * 2496 + 1264, 0, 1),
    ("bg1_z52", 128, 4, False, 1, "chip", 56992 + 3744, 0, 1),
    ("n976", 512, 4, False, 1, "chip", 12320 + 880, 0, 1),
    ("n976", 512, 4, True, 1, "chip", 3 * 8416 + 416, 0, 3),  # 3 codewords a block: 171 blocks
    ("bg1_z384", 128, 2, True, 1, "pair", 104448 + 2 * 3072 + 1824, 46 * 3072, 1),  # one wave
    ("bg1_z384", 128, 4, True, 1, "pair", 104448 + 2 * 4608 + 1824, 46 * 4608, 1),
    ("bg1_z384", 512, 2, True, 1, "pair", 104448 + 2 * 3072 + 1824, 46 * 3072, 1),  # four waves
    # the 2-layer 256QAM cell's call: 8 slots x 42 words, a block a word past one wave
    ("bg1_z384", 336, 2, True, 1, "pair", 104448 + 2 * 3072 + 1824, 46 * 3072, 1),
    ("bg1_z384", 512, 4, True, 1, "pair", 104448 + 2 * 4608 + 1824, 46 * 4608, 1),
    ("bg1_z384", 24, 4, False, 1, "stream", 104448 + 3744, 46 * 4608, 1),
])
def test_launch_plan_routes_and_budgets(name, batch, msg_bytes, layered, group, route, smem,
                                        scratch, cpb):
    w = k4.wiring(tl.make_ldpc_plan(CODES[name](tl)), "cpu")
    lp = k4.launch_plan(w, batch, msg_bytes, layered, group, 132)
    assert (lp.route, lp.smem, lp.scratch, lp.cpb) == (route, smem, scratch, cpb)
    limit = k4.PAIR_THREADS if route == "pair" else k4.MAX_THREADS
    assert lp.smem <= k4.SMEM_LIMIT and lp.threads % 32 == 0 and lp.threads <= limit
    assert lp.blocks == -(-batch // lp.cpb) and lp.blocks >= min(132, batch)


@pytest.mark.parametrize("name", list(CODES))
def test_launch_plan_takes_the_pair_route_where_the_rule_says(name, monkeypatch):
    """The pair route exactly where the stream route would run groups of one
    row at one codeword a block and 2z <= PAIR_THREADS, at any batch, with
    2z threads (padded to a warp) a block; every other plan, and every other
    number of a pair plan, as without the pair route (PAIR_THREADS 0)."""
    w = k4.wiring(tl.make_ldpc_plan(CODES[name](tl)), "cpu")
    n_sm = 132
    n_pair = 0
    for batch in (1, 24, 96, 128, 131, 132, 133, 200, 512):
        for msg_bytes in (2, 4):
            for layered, group in ((False, 1), (True, 1), (True, 2), (True, 3), (True, 8)):
                try:
                    lp = k4.launch_plan(w, batch, msg_bytes, layered, group, n_sm)
                except ValueError:
                    continue
                with monkeypatch.context() as mp:
                    mp.setattr(k4, "PAIR_THREADS", 0)
                    base = k4.launch_plan(w, batch, msg_bytes, layered, group, n_sm)
                rule = (layered and group == 1 and base.route == "stream" and base.cpb == 1
                        and 2 * w.z <= k4.PAIR_THREADS)
                assert (lp.route == "pair") == rule, (batch, msg_bytes, layered, group)
                assert dataclasses.replace(lp, route=base.route, threads=base.threads) == base
                if rule:
                    assert lp.threads == -(-2 * w.z // 32) * 32 <= k4.PAIR_THREADS
                    n_pair += 1
                else:
                    assert lp == base
    # NR BG1 Z=384: the served call (96 words), the bench row (128), the host
    # decode path's 512 words and every other batch take the pair route;
    # groups of several rows keep the stream route
    assert n_pair == (2 * 9 if name == "bg1_z384" else 0)
    if name == "bg1_z384":
        route = lambda b, g=1, mb=2: k4.launch_plan(w, b, mb, True, g, n_sm).route
        assert [route(b) for b in (1, 24, 96, 132, 133, 200, 512)] == ["pair"] * 7
        assert route(96, mb=4) == "pair" and route(96, g=2) == route(96, g=3) == "stream"


def test_launch_plan_refuses_what_no_route_takes():
    w = k4.wiring(tl.make_ldpc_plan(CODES["bg1_z384"](tl)), "cpu")
    assert k4.launch_plan(w, 8, 4, True, 8, 132).route == "stream"
    with pytest.raises(ValueError, match="does not fit"):
        k4.launch_plan(w, 8, 4, True, 16, 132)
    assert k4.record_stride(61, 2) == 256 + 256 and k4.record_stride(384, 4) == 3072 + 1536
