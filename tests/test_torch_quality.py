"""The port's quality sweeps against the JAX package's, on the CPU.

Every sweep of `srsran_ce_tpu_torch.validation.quality` at its smallest size
(one or two cases, <= 12 PRB, one or two SNRs) against the JAX sweep at the
same seeds and arguments, with the shipped denoisers where a learned
smoothing runs (`srsran_ce_tpu_torch/artifacts/denoiser{,2d}.npz`, the same
weights in both packages). Bounds on the linear quantity behind every dB
figure (NMSE, CFO RMS error), relative:

- 1e-9 where the whole estimate runs in float64 (measured ~1e-15);
- 1e-6 where a float32 denoiser runs inside the float64 pipeline (both
  packages cast to float32 and back; measured ~3e-8);
- 1e-5 for the serving sweep (`delay_adapt_sweep`), float32 in both
  packages (tests/test_torch_serving.py's float32 bar; measured ~3e-6);
- BER and coded-link figures (bit, word and block counts): equal.

Then `cli quality --device cpu` at a tiny size prints every table and writes
the JAX CLI's report keys, and the sweeps default to the card.
"""
import json
import math

import numpy as np
import pytest
import torch

from srsran_ce_tpu.ops import ldpc as jl
from srsran_ce_tpu.validation import quality as jq
from srsran_ce_tpu_torch.models import denoiser as dn
from srsran_ce_tpu_torch.ops import ldpc as tl
from srsran_ce_tpu_torch.validation import cli
from srsran_ce_tpu_torch.validation import quality as tq


@pytest.fixture(scope="module")
def shipped():
    """(flax params for JAX, port params) of both shipped denoisers."""
    return {kind: (dn.load_flax_npz(dn.ARTIFACTS / name), dn.load_shipped(kind, device="cpu"))
            for kind, name in dn.SHIPPED.items()}


def leaves(x, path=()):
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from leaves(x[k], path + (k,))
    else:
        yield path, x


def assert_close(got, want, rtol):
    """dB leaves compared as linear quantities within rtol; other floats
    within rtol; bools and ints equal."""
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, (bool, np.bool_, int, np.integer)) or isinstance(a, (bool, int)):
            assert a == b, path
            continue
        db = any(str(k).endswith("_db") for k in path) or path[0] in DB_TABLES
        la, lb = (10 ** (a / 10), 10 ** (b / 10)) if db else (a, b)
        assert abs(la - lb) <= rtol * max(abs(lb), 1e-300), (path, a, b)


DB_TABLES = ("filter", "learned", "none", "wiener", "mean", "linear", "learned2d",
             "flat_1tap", "default_6tap", "rich_12tap")

SWEEPS = {
    # name: (JAX call, port call, rtol); the port calls take device="cpu"
    "sweep": (lambda p: jq.sweep((0.0,), ("filter", "learned", "none"), params=p["1d"], n_cases=1,
                                 n_prbs=8, n_layers=1),
              lambda p: tq.sweep((0.0,), ("filter", "learned", "none"), params=p["1d"], n_cases=1,
                                 n_prbs=8, n_layers=1, device="cpu"), 1e-6),
    "channel_nmse_vs_truth": (
        lambda p: jq.channel_nmse_vs_truth("wiener", 5.0, n_cases=2, n_prbs=6, n_layers=2),
        lambda p: tq.channel_nmse_vs_truth("wiener", 5.0, n_cases=2, n_prbs=6, n_layers=2,
                                           device="cpu"), 1e-9),
    "geometry_sweep": (lambda p: jq.geometry_sweep(p["1d"], n_prbs_list=(4, 12), n_cases=1),
                       lambda p: tq.geometry_sweep(p["1d"], n_prbs_list=(4, 12), n_cases=1,
                                                   device="cpu"), 1e-6),
    "doppler_sweep": (lambda p: jq.doppler_sweep((0.0, 300.0), n_cases=1, n_prbs=8, params2d=p["2d"]),
                      lambda p: tq.doppler_sweep((0.0, 300.0), n_cases=1, n_prbs=8,
                                                 params2d=p["2d"], device="cpu"), 1e-6),
    "delay_adapt_sweep": (lambda p: jq.delay_adapt_sweep(n_cases=1, n_prbs=12),
                          lambda p: tq.delay_adapt_sweep(n_cases=1, n_prbs=12, device="cpu"), 1e-5),
    "tracking_sweep": (lambda p: jq.tracking_sweep(n_slots=2, n_cases=1, n_prbs=8),
                       lambda p: tq.tracking_sweep(n_slots=2, n_cases=1, n_prbs=8, device="cpu"),
                       1e-9),
    "cfo_rmse_sweep": (lambda p: jq.cfo_rmse_sweep((0.0, 10.0), n_cases=2, n_prbs=8),
                       lambda p: tq.cfo_rmse_sweep((0.0, 10.0), n_cases=2, n_prbs=8, device="cpu"),
                       1e-9),
    "ber_sweep": (lambda p: jq.ber_sweep((10.0,), n_cases=1, n_prbs=8),
                  lambda p: tq.ber_sweep((10.0,), n_cases=1, n_prbs=8, device="cpu"), 0.0),
    "coded_ber_sweep": (
        lambda p: jq.coded_ber_sweep((12.0, 20.0), n_cases=1, n_prbs=8, code=jl.array_code(4, 8, 23),
                                     n_iters=10),
        lambda p: tq.coded_ber_sweep((12.0, 20.0), n_cases=1, n_prbs=8, code=tl.array_code(4, 8, 23),
                                     n_iters=10, device="cpu"), 0.0),
}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_matches_jax(name, shipped):
    jcall, tcall, rtol = SWEEPS[name]
    want = jcall({k: v[0] for k, v in shipped.items()})
    got = tcall({k: v[1] for k, v in shipped.items()})
    if name == "channel_nmse_vs_truth":
        assert abs(got - want) <= rtol * want
        return
    assert_close(got, want, rtol)
    if name == "coded_ber_sweep":
        assert got[20.0]["coded_ber"] == 0.0 < got[12.0]["uncoded_ber"]


def test_cli_quality_prints_every_table(tmp_path, capsys):
    report = tmp_path / "q.json"
    assert cli.main(["quality", "--cases", "1", "--n-prbs", "8", "--snr", "0", "--device", "cpu",
                     "--report", str(report)]) == 0
    out = capsys.readouterr().out
    for title in ("learned-vs-filter gain", "Geometry generalization", "Doppler tracking",
                  "CFO RMS error", "Multi-slot tracking", "Auto-matched MMSE prior",
                  "Link-level uncoded BER", "Coded link", "loaded denoiser checkpoint",
                  "loaded 2-D denoiser checkpoint", "(device cpu: cpu)"):
        assert title in out, title
    rep = json.loads(report.read_text())
    assert set(rep) == {"snr", "geometry", "doppler", "cfo", "tracking", "delay_adapt", "link_ber",
                        "coded_link"}
    assert all(math.isfinite(v) for row in rep["snr"].values() for v in row.values())


def test_quality_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tq.channel_nmse_vs_truth("filter", 0.0, n_cases=1, n_prbs=4),
                 lambda: tq.tracking_sweep(n_cases=1), lambda: tq.ber_sweep(n_cases=1),
                 lambda: tq.delay_adapt_sweep(n_cases=1)):
        with pytest.raises(RuntimeError, match=r"device=cuda: no CUDA device here"):
            call()
    with pytest.raises(RuntimeError, match=r"--device cuda: no CUDA device here"):
        cli.main(["quality", "--cases", "1"])
