"""The port's `utils/profiling.py` against the JAX package's
`srsran_ce_tpu/utils/profiling.py`, on the CPU.

`robust_slope_stats` must return exactly the JAX function's (s_min, spread,
n_discarded, good) on the same slopes (equality, not a tolerance: both are
the same float64 arithmetic); `StructuredReport.write` must write the same
bytes. The chain (`Chain`, `chained_slope_stats`) runs its eager loop here:
its final carry equals a plain loop's bit for bit, and the stats carry the
JAX result keys. `trace` must leave a Chrome trace file, `op_stats` count the
aten ops of a small estimator call.
"""
import json

import numpy as np
import pytest
import torch

from srsran_ce_tpu.utils import profiling as jprof
from srsran_ce_tpu_torch.models import estimator as est
from srsran_ce_tpu_torch.utils import profiling as tprof
from srsran_ce_tpu_torch.utils import synthetic


def _slopes(seed):
    """Seeded slope lists of the kinds the policy must handle: honest
    estimates around 0.3 ms, a clamped fit (<= 10 ns), a 10x-low fit, a
    corroborated pair below 0.7 x the median."""
    rng = np.random.default_rng(seed)
    base = list(3e-4 * (1 + 0.2 * rng.random(int(rng.integers(2, 7)))))
    kind = seed % 4
    if kind == 1:
        base.append(float(rng.choice([1e-9, 5e-9, 1e-12, -3e-6])))  # clamped / negative
    elif kind == 2:
        base.append(base[0] * 0.1)  # uncorroborated too-fast
    elif kind == 3:
        base += [base[0] * 0.3, base[0] * 0.31]  # corroborated low pair survives
    rng.shuffle(base)
    return base


SLOPE_LISTS = [_slopes(s) for s in range(12)] + [
    [3.0e-4, 1e-9, 2.8e-4, 2.5e-5, 3.1e-4],  # tests/test_bench_stats.py's cases
    [2.0e-4, 2.2e-4, 1.9e-4],
    [2.0e-4, 2.5e-4, 2.1e-4],
    [1e-9, 1e-9],
    [],
    [5e-9],
]


@pytest.mark.parametrize("slopes", SLOPE_LISTS, ids=[f"list{i}" for i in range(len(SLOPE_LISTS))])
@pytest.mark.parametrize("floor", [1e-9, 1e-12])
def test_robust_slope_stats_identical_to_jax(slopes, floor):
    assert tprof.robust_slope_stats(slopes, floor) == jprof.robust_slope_stats(slopes, floor)


def test_robust_slope_stats_discards_broken_fits():
    s_min, spread, n_disc, good = tprof.robust_slope_stats([3.0e-4, 1e-9, 2.8e-4, 2.5e-5, 3.1e-4])
    assert (s_min, n_disc) == (2.8e-4, 2) and 2.5e-5 not in good


def test_structured_report_writes_jax_json(tmp_path):
    kw = dict(kind="scaling", device="cpu x8 processes")
    t, j = tprof.StructuredReport(**kw), jprof.StructuredReport(**kw)
    for r in (t, j):
        r.add(scenario="dp_weak", n_devices=2, s_per_step=1.25e-3, efficiency=0.9)
        r.add(scenario="dp_baselines", note="x", t1=None)
        r.meta = {"physical_cores": 8, "efficiency": {"raw": {1: 1.0, 2: 0.9}}}
    t.write(tmp_path / "t.json")
    j.write(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text())["entries"][0]["n_devices"] == 2


def _toy():
    w = torch.as_tensor(np.random.default_rng(0).standard_normal((48, 48)) / 7)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((16, 48)))
    return w, x


def test_chained_slope_stats_keys_and_positive_slope():
    w, x = _toy()
    st = tprof.chained_slope_stats(lambda a, b: a @ b, lambda c, o: torch.tanh(o), (x, w),
                                   reps_lo=4, reps_hi=12, trials=2, k=3)
    assert set(st) == {"s_per_step", "slopes", "archived_slopes", "escalations", "n_discarded",
                       "spread"}
    assert st["s_per_step"] > 0 and len(st["slopes"]) == 3 and 0 <= st["escalations"] <= 2
    assert tprof.chained_throughput(lambda a, b: a @ b, lambda c, o: torch.tanh(o), (x, w),
                                    reps_lo=4, reps_hi=12, trials=1) > 0


def test_chain_cpu_loop_is_the_plain_loop():
    w, x = _toy()
    body = lambda c: (torch.tanh(c[0] @ w), c[1] + c[0].sum())
    chain = tprof.Chain(body, (x, torch.zeros(())), unit=4)
    got = chain.run(12)
    want = (x, torch.zeros(()))
    for _ in range(12):
        want = body(want)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert chain.time(8) > 0
    with pytest.raises(ValueError, match="multiple of the chain's unit"):
        chain.run(6)


@pytest.mark.parametrize("reps,unit", [((8, 40, 72, 144, 4608), 8), ((4, 20), 4), ((4, 36), 4),
                                       ((2, 8), 2), ((16, 64), 8), ((3, 9), 3)])
def test_chain_unit(reps, unit):
    assert tprof.chain_unit(*reps) == unit


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert d == str(tmp_path / "tr") and len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_op_stats_counts_the_aten_ops_of_an_estimator_call():
    case = synthetic.make_case(seed=3, n_prbs=4, n_layers=2)
    fn = est.build_ri(case.hop1, case.hop2, case.config, 2, batched=False)
    args = (torch.as_tensor(est.split_ri(case.received_rg)), torch.as_tensor(
        est.split_ri(case.pilots)), torch.tensor(1.0, dtype=torch.float64))
    fn(*args)  # the plan's tensors are built by the first call
    ops = tprof.op_stats(lambda: fn(*args), "cpu")
    assert sum(ops.values()) > 50 and any(k.startswith("aten.mm") or k.startswith("aten.matmul")
                                          or k.startswith("aten.bmm") for k in ops)
    assert ops == tprof.op_stats(lambda: fn(*args), "cpu")  # the count of one call repeats
