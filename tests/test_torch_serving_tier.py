"""The kernel tier `serving.process` builds its estimator with, on the CPU.

`estimator.served_kernels` takes the fused front K1 ("pallas_front") on a
CUDA device wherever `_front_pallas_ok` covers the plan, and "xla"
otherwise: on the CPU, and for each plan K1 cannot take (serving stages
float32 inputs alone). The rule reads only the device and the plan, so it is
checked here
without a card (a `torch.device("cuda")` is only a name until something runs
on it). The plan of the benchmark's `ce_n78_40mhz_4port_32ant` deployment is
made from its own file, as `cebench`'s chain makes it. Two of K1's refusals
have no case: the plan builder refuses more layers than the DM-RS mask has
CDM columns for (two at comb 2, so at most 4 layers), and it pairs the
layers of every CDM group.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cebench import spec
from cebench.gen import slots
from srsran_ce_tpu_torch import config as pconfig
from srsran_ce_tpu_torch import serving
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.utils import synthetic

CUDA = torch.device("cuda")


def cell_key(**config_changes):
    """(hop1, hop2, config, n_layers) of the 32-antenna cell's plan, the served
    precision ("high", as the cell runs it), with `config_changes` applied."""
    cfg = spec.read_json("configs", "ce_n78_40mhz_4port_32ant.json")
    s = slots.ce_slot(dict(cfg, n_rx=1), 2**31 + 20_020, 0)
    hop1 = pconfig.HopConfig(**dataclasses.asdict(s.hop1))
    hop2 = None if s.hop2 is None else pconfig.HopConfig(**dataclasses.asdict(s.hop2))
    conf = pconfig.EstimatorConfig(**dataclasses.asdict(s.config))
    conf = dataclasses.replace(conf, matmul_precision=cfg["matmul_precision"], **config_changes)
    return hop1, hop2, conf, int(cfg["n_layers"])


TIER_CASES = [
    # name, plan changes, layout, device, tier
    ("cell_factored_on_cuda", {}, "factored", CUDA, "pallas_front"),
    ("cell_grid_on_cuda", {}, "serve", CUDA, "pallas_front"),
    ("cell_on_cpu", {}, "factored", torch.device("cpu"), "xla"),
    ("cell_grid_on_cpu", {}, "serve", "cpu", "xla"),
    ("time_interp", dict(time_interp="linear"), "serve", CUDA, "xla"),
    ("learned", dict(smoothing="learned"), "factored", CUDA, "xla"),
    ("wiener", dict(smoothing="wiener"), "factored", CUDA, "xla"),
    ("mean", dict(smoothing="mean"), "factored", CUDA, "xla"),
    ("no_smoothing", dict(smoothing="none"), "serve", CUDA, "xla"),
    ("cnn_alpha", dict(interp="cnn", cnn_alpha=0.5), "serve", CUDA, "xla"),
    ("cfo_pair_estimator", dict(cfo_estimator="wls"), "factored", CUDA, "xla"),
    ("cfo_compensation_off", dict(cfo_compensate=False), "serve", CUDA, "pallas_front"),
]


@pytest.mark.parametrize("name,changes,layout,device,tier", TIER_CASES,
                         ids=[c[0] for c in TIER_CASES])
def test_served_tier_follows_device_and_plan(name, changes, layout, device, tier):
    key = cell_key(**changes)
    assert est.served_kernels(*key, layout, device) == tier
    if tier == "pallas_front":
        # the tier the rule takes builds: the plan is one K1 covers
        assert est.build_ri(*key, batched=True, kernels=tier, out_layout=layout).kernels == tier


def test_served_tier_is_decided_once_per_plan_key(monkeypatch):
    calls = []
    real = est._front_pallas_ok
    monkeypatch.setattr(est, "_front_pallas_ok", lambda plan: calls.append(plan) or real(plan))
    est._front_serves.cache_clear()
    key = cell_key()
    for _ in range(3):
        assert est.served_kernels(*key, "factored", CUDA) == "pallas_front"
    assert len(calls) == 1
    est._front_serves.cache_clear()


@pytest.mark.parametrize("out", ["grid", "factored"])
def test_process_on_cpu_builds_the_xla_estimator(out, monkeypatch):
    built = []
    real = est.build_ri

    def spy(*args, **kw):
        fn = real(*args, **kw)
        built.append(fn.kernels)
        return fn

    monkeypatch.setattr(est, "build_ri", spy)
    cases = [synthetic.make_case(seed=2000 + i, n_prbs=12, n_layers=2, snr_db=30.0)
             for i in range(3)]
    probs = [serving.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                             float(c.beta), c.hop1, c.hop2, c.config) for c in cases]
    res = serving.process(probs, batch_size=2, out=out, device="cpu")
    assert len(res) == 3 and built == ["xla"]
    # the same plan on the card would take K1
    c = cases[0]
    cfg = dataclasses.replace(c.config, matmul_precision="high")
    layout = "serve" if out == "grid" else "factored"
    assert est.served_kernels(c.hop1, c.hop2, cfg, 2, layout, CUDA) == "pallas_front"
