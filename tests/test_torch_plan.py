"""The port's numpy host modules against the JAX package's: bit-identical.

`srsran_ce_tpu_torch` carries its own copies of config, plan, synthetic,
oracle, ops/sequences, utils/vectors and validation/synth_vectors because the
JAX package's `__init__` imports jax, which the GPU machine does not have.
These tests hold every field and every array of the two packages' configs,
cases, plans, pilot sequences, vector parses and written vector suites equal
bit for bit (arrays compared as raw bytes, floats with ==), and prove that the
port imports no jax.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from srsran_ce_tpu.models import plan as jplan
from srsran_ce_tpu.utils import synthetic as jsyn
from srsran_ce_tpu import config as jcfg
from srsran_ce_tpu_torch.models import plan as tplan
from srsran_ce_tpu_torch.utils import synthetic as tsyn
from srsran_ce_tpu_torch.utils import oracle as toracle
from srsran_ce_tpu.utils import oracle as joracle
from srsran_ce_tpu_torch import config as tcfg

REPO = Path(__file__).resolve().parents[1]

# c0, c2, c4 of the benchmark catalog plus the geometries of
# tests/test_pallas_kernels.py::test_pallas_front_matches_xla
GEOMETRIES = [
    ("c0", dict(jsyn.BENCH_CASES["c0_baseline_52prb"], snr_db=30.0)),
    ("c2", dict(jsyn.BENCH_CASES["c2_mmse_4port_106prb"], snr_db=30.0)),
    ("c4", dict(jsyn.BENCH_CASES["c4_multihost_hopped"], snr_db=30.0)),
    ("front_4l_2cdm", dict(n_prbs=26, n_layers=4, comb=2, snr_db=30.0)),
    ("front_cfo_off", dict(n_prbs=24, n_layers=1, comb=2, snr_db=25.0, cfo_compensate=False)),
    ("front_two_hops", dict(n_prbs=12, n_layers=2, comb=2, snr_db=30.0, two_hops=True)),
    ("front_52prb", dict(n_prbs=52, n_layers=2, comb=2, snr_db=20.0, cfo_hz=200.0)),
    ("front_cnn", dict(n_prbs=24, n_layers=1, comb=2, snr_db=30.0, interp="cnn")),
]


def assert_same(a, b, path="root"):
    """Recursive bit-identity of two values built by the two packages."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__, path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            assert_same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and (a == b or (np.isnan(a) and np.isnan(b))), (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(scs_hz=30e3),
        dict(scs_hz=15e3, smoothing="wiener", cfo_compensate=False, n_symbols=14),
        dict(scs_hz=30e3, interp="cnn", cnn_alpha=0.4, matmul_precision="high",
             time_interp="linear", cfo_estimator="wls"),
    ],
)
def test_make_config_identical(kwargs):
    a, b = tcfg.make_config(**kwargs), jcfg.make_config(**kwargs)
    assert_same(a, b)
    assert hash(a) == hash(a) and a == tcfg.make_config(**kwargs)


@pytest.mark.parametrize("name,kw", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_make_case_and_plan_identical(name, kw):
    tc, jc = tsyn.make_case(seed=31, **kw), jsyn.make_case(seed=31, **kw)
    assert_same(tc, jc)
    nL = tc.pilots.shape[2]
    tp = tplan.make_plan(tc.hop1, tc.hop2, tc.config, nL)
    jp = jplan.make_plan(jc.hop1, jc.hop2, jc.config, nL)
    assert_same(tp, jp)


def test_oracle_identical():
    """The port's oracle copy gives bit-identical results on a port case."""
    kw = dict(n_prbs=16, n_layers=3, comb=2, snr_db=30.0)
    c = tsyn.make_case(seed=5, **kw)
    jc = jsyn.make_case(seed=5, **kw)
    assert_same(
        toracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config),
        joracle.estimate(jc.received_rg, jc.pilots, jc.beta, jc.hop1, jc.hop2, jc.config),
    )


@pytest.mark.parametrize(
    "kw",
    [dict(n_prbs=24, n_layers=2, pilot_source="dmrs"),
     dict(n_prbs=24, n_layers=4, pilot_source="dmrs", dmrs_type=2),
     dict(n_prbs=16, n_layers=1, pilot_source="srs", smoothing="wiener", two_hops=True),
     dict(n_prbs=5, n_layers=2, pilot_source="srs")],
    ids=["dmrs", "dmrs_type2", "srs_hopped", "srs_5prb"],
)
def test_standard_pilot_cases_identical(kw):
    """make_case with the TS 38.211 pilot sources (ops/sequences copy)."""
    tc, jc = tsyn.make_case(seed=77, **kw), jsyn.make_case(seed=77, **kw)
    assert_same(tc, jc)
    nL = tc.pilots.shape[2]
    assert_same(tplan.make_plan(tc.hop1, tc.hop2, tc.config, nL),
                jplan.make_plan(jc.hop1, jc.hop2, jc.config, nL))


def test_sequences_identical():
    from srsran_ce_tpu.ops import sequences as jseq
    from srsran_ce_tpu_torch.ops import sequences as tseq

    assert_same(tseq.gold_sequence(0x1234567, 1000), jseq.gold_sequence(0x1234567, 1000))
    assert_same(tseq.pseudo_random_qpsk(99, 64, start=5), jseq.pseudo_random_qpsk(99, 64, start=5))
    for m_zc in (30, 36, 71, 139):
        for u in (0, 7, 29):
            assert_same(tseq.low_papr_base_sequence(u, 0, m_zc), jseq.low_papr_base_sequence(u, 0, m_zc))
    for t in (1, 2):
        assert_same(tseq.dmrs_re_mask(t, 2), jseq.dmrs_re_mask(t, 2))
    assert tseq.pusch_scrambling_c_init(0x4601, 17) == jseq.pusch_scrambling_c_init(0x4601, 17)


def test_unported_pilot_sources_raise():
    """Every pilot source of make_case is ported, and so is the MIMO link case
    (ops/demap and transport are in the port): make_mimo_case draws the JAX
    package's case bit for bit instead of raising."""
    tsyn.make_case(seed=1, n_prbs=4, pilot_source="dmrs")
    assert_same(tsyn.make_mimo_case(seed=1, n_prbs=4), jsyn.make_mimo_case(seed=1, n_prbs=4))


def test_vector_suite_and_parse_identical(tmp_path):
    """generate_suite writes byte-identical files; the two parsers read them
    (and the record files) identically."""
    from srsran_ce_tpu.utils import vectors as jvec
    from srsran_ce_tpu.validation import synth_vectors as jsv
    from srsran_ce_tpu_torch.utils import vectors as tvec
    from srsran_ce_tpu_torch.validation import cli, synth_vectors as tsv

    specs = cli.SELFTEST_SPECS
    ht = tsv.generate_suite(tmp_path / "t", specs)
    hj = jsv.generate_suite(tmp_path / "j", specs)
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "t").iterdir()) and len(names) == 37
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    assert_same(tvec.parse_test_header(ht), jvec.parse_test_header(hj))
    for n in names:
        if n.endswith(".dat") and "pilots" not in n:
            assert_same(tvec.load_entries(tmp_path / "t" / n), jvec.parse_entries_np(
                (tmp_path / "j" / n).read_bytes()))
    flat = np.arange(2 * 3 * 4, dtype=np.complex64)
    assert_same(tvec.pilot_candidates(flat, 2, 3, 4), jvec.pilot_candidates(flat, 2, 3, 4))


def test_port_imports_no_jax():
    """The GPU machine has no JAX: importing the port's modules must not load it."""
    code = (
        "import sys\n"
        "import srsran_ce_tpu_torch.models.estimator, srsran_ce_tpu_torch.utils.synthetic\n"
        "import srsran_ce_tpu_torch.utils.oracle, srsran_ce_tpu_torch.entry\n"
        "import srsran_ce_tpu_torch.ops.kernels._build, srsran_ce_tpu_torch.ops.sequences\n"
        "import srsran_ce_tpu_torch.utils.vectors, srsran_ce_tpu_torch.validation.synth_vectors\n"
        "import srsran_ce_tpu_torch.validation.conformance, srsran_ce_tpu_torch.validation.cli\n"
        "import srsran_ce_tpu_torch.ops.ldpc, srsran_ce_tpu_torch.ops.nr_ldpc\n"
        "import srsran_ce_tpu_torch.transport, srsran_ce_tpu_torch.devices\n"
        "import srsran_ce_tpu_torch.ops.kernels.ldpc, srsran_ce_tpu_torch.ops.kernels.ldpc_stream\n"
        "import srsran_ce_tpu_torch.ops.equalize, srsran_ce_tpu_torch.ops.demap\n"
        "import srsran_ce_tpu_torch.models.receiver, srsran_ce_tpu_torch.ops.kernels.inpaint\n"
        "from srsran_ce_tpu_torch.validation import cli\n"
        "assert cli.main(['selftest', '--device', 'cpu']) == 0\n"
        "from srsran_ce_tpu_torch.ops import ldpc, nr_ldpc\n"
        "code = nr_ldpc.nr_base_graph(2, 16)\n"
        "res = ldpc.build_decoder(code, n_iters=2, kernels='auto', schedule='layered',\n"
        "                         device='cpu')(8.0 - 16.0 * ldpc.encode(code, [[1] * 160]))\n"
        "assert bool(res.ok.all()) and res.info.sum() == 160\n"
        "import numpy as np\n"
        "from srsran_ce_tpu_torch import serving, transport\n"
        "from srsran_ce_tpu_torch.utils import synthetic\n"
        "code = ldpc.array_code(3, 8, 13)\n"
        "coding = transport.TransportCoding(code=code, n_iters=8, early_iters=None)\n"
        "case = synthetic.make_mimo_case(seed=3, n_rx=1, modulation='qpsk', scramble=False,\n"
        "                                n_prbs=4, snr_db=30.0)\n"
        "prob = serving.Problem(case.received_rg.astype(np.complex64),\n"
        "                       case.pilots.astype(np.complex64), case.beta, case.hop1, case.hop2,\n"
        "                       case.config)\n"
        "for dev_decode in (False, True):\n"
        "    r = serving.process([prob], out='decoded', modulation='qpsk', coding=coding,\n"
        "                        decode_on_device=dev_decode, device='cpu')[0]\n"
        "    assert r.info.shape == (r.ok.shape[0], ldpc.make_ldpc_plan(code).k)\n"
        "from srsran_ce_tpu_torch.models import denoiser, estimator, tracking\n"
        "case = synthetic.make_case(seed=4, n_prbs=4, n_layers=1, smoothing='learned')\n"
        "args = (estimator.split_ri(case.received_rg), estimator.split_ri(case.pilots), case.beta)\n"
        "params = denoiser.load_shipped('1d', device='cpu')\n"
        "res = estimator.build_ri(case.hop1, case.hop2, case.config, 1)(*args, params)\n"
        "assert bool(np.isfinite(res.channel_est_rg.numpy()).all())\n"
        "assert sorted(denoiser.load_shipped('2d', device='cpu')) == sorted(\n"
        "    denoiser.PilotDenoiser2D().state_dict())\n"
        "case = synthetic.make_case(seed=4, n_prbs=4, n_layers=1)\n"
        "args = (estimator.split_ri(case.received_rg), estimator.split_ri(case.pilots), case.beta)\n"
        "fn = tracking.build_tracked_ri(case.hop1, case.hop2, case.config, 1, device='cpu')\n"
        "state = tracking.init_state(case.hop1, case.hop2, case.config, 1, device='cpu')\n"
        "for _ in range(2):\n"
        "    res, *state = fn(*args, *state)\n"
        "assert float(state[1]) == 2.0\n"
        "srv = serving.TrackedServer(batch_size=2, device='cpu')\n"
        "srv.process([prob], ['ue'], out='llrs', modulation='qpsk')\n"
        "from srsran_ce_tpu_torch.models import training\n"
        "from srsran_ce_tpu_torch.utils import debug\n"
        "from srsran_ce_tpu_torch.validation import deepfuzz, quality\n"
        "st, loss = training.train(n_steps=2, batch=8, n_re=16, log_every=0, device='cpu')\n"
        "assert st.step == 2 and np.isfinite(loss)\n"
        "assert deepfuzz.run_header_fuzz(5)['n_pass'] == 5\n"
        "assert deepfuzz.coded_trial(2, device='cpu')['ok']\n"
        "debug.checked(fn)(*args, *state)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'srsran_ce_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
