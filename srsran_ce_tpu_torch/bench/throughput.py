"""Benchmark harness of the port: channel-estimation and decode throughput on
one CUDA card, the counterpart of the JAX package's `bench.py`.

    python -m srsran_ce_tpu_torch.validation.cli bench --device cuda --out PATH

Prints ONE JSON line as the last line of standard output:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
and writes the per-row details (bench.py's BENCH_DETAILS.json keys, with the
card's name and power limit in `device`) to `--out`. Progress goes to
standard error. The exit code is 1 when any row failed: an exception, or a
correctness gate (a failed gate is the row's `error`).

Rows, widths, batches, seeds, SNRs and gates are bench.py's (its line
numbers are cited at each). Headline: channel-estimate grid REs/s on the
BASELINE.json config[2] geometry (106 PRB, 4 ports, MMSE smoothing) at the
batch the sweep picks, on the "xla" tier (plain torch; bench.py's default
and `entry.entry()`'s configuration), as served: out_layout="serve",
matmul_precision="high".

Methodology, as bench.py's:
  * A row's time is the slope of chain time over chain length: a strictly
    serial chain whose next input depends on the previous call's output
    (`utils/profiling.Chain`: on the card a CUDA graph of 8 calls replayed
    back to back, timed by the host's clock around the replays and a
    synchronisation). The constant cost of a chain cancels in the slope.
  * Every call's outputs are written: a CUDA graph runs every kernel it
    captured (what `lax.optimization_barrier` ensured in JAX), and the
    feedback reads a strided sample of the output grid.
  * MIN-OF-K slopes, rows interleaved: every row takes K=3 independent slope
    estimates in interleaved passes, reports min + spread, and headlines the
    min; rows whose spread exceeds 10% move to a longer chain (at most to
    REPS_LONGER's last tier) and are flagged `spread_warn` if it stays.

Bounds (`row_bounds`): the byte floor is bench.py's count of the bytes a call
must move (the carried grid and the pilots in, the served grid out) over the
H100's 3.35 TB/s; the compute floor counts the PRODUCTS of one eager call
(`torch.utils.flop_counter.FlopCounterMode`: matmuls and convolutions, the
elementwise work is not counted; `product_flops_per_batch`) over its float32
rate outside the tensor cores, 67 TFLOP/s (NVIDIA's data sheet, SXM, 700 W;
the products run in full float32). The count is taken on the CPU, where each
CUDA kernel runs its plain version (the same products), at batch 1 and 2 and
carried linearly to the row's batch. XLA's cost analysis has no counterpart
(bench.py's `xla_bytes_*` and `all_vpu_ms`), nor has the TPU tiling of the
streamed decoder (`stream_block_b`, `z_padded_lanes`: the CUDA kernel's
launch plan stands in their place).

vs_baseline reads BASELINE_MEASURED.json (the reference's torch-CPU eager
implementation, measured on the JAX round's host; its `hardware` string is
printed beside the ratio). This program never writes that file, nor
bench.py's BENCH_DETAILS.json.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import devices
from ..utils import profiling, synthetic


def log(*a):
    print(*a, file=sys.stderr, flush=True)


BENCH_CONFIGS = {  # bench.py:66-75
    # name -> (case kwargs, batch sizes to sweep)
    "c0_baseline_52prb": (dict(n_prbs=52, n_layers=1, comb=2, scs_hz=15e3), (128, 256)),
    "c1_tensorized_52prb": (dict(n_prbs=52, n_layers=1, comb=2, scs_hz=30e3), (64, 256)),
    "c2_mmse_4port_106prb": (dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3), (128, 256)),
    "c3_cnn_273prb": (dict(n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, interp="cnn"), (64, 128)),
    # BASELINE configs[4]: 4096 concurrent (cell, UE, port) estimations
    "c4_hopped_24prb": (dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, two_hops=True), (256, 4096)),
}

HEADLINE = "c2_mmse_4port_106prb"
REPS = (8, 40, 72)
REPS_LONGER = ((8, 144, 288), (8, 576, 1152), (8, 2304, 4608))  # fast-row escalation tiers
TRIALS = 3
K_SLOPES = 3
SPREAD_WARN = 0.10

#: the peaks the bounds use: one NVIDIA H100 SXM (data sheet, dense, 700 W)
PEAKS = {"card": "NVIDIA H100 SXM (data sheet, dense, 700 W)", "hbm_bytes_per_s": 3.35e12,
         "f32_flops_per_s": 67e12}
HBM_BW = PEAKS["hbm_bytes_per_s"]
F32_FLOPS = PEAKS["f32_flops_per_s"]
#: the decode rows' LLR clip between chained calls (bench.py's feedback)
LLR_CLIP = 20.0

# THE min-of-K aggregation policy, shared with profiling.chained_slope_stats
robust_slope_stats = profiling.robust_slope_stats


class GateFailed(RuntimeError):
    """A correctness gate of a row failed: the row's numbers are withheld."""


def _gate(ok: bool, msg: str) -> None:
    if not ok:
        raise GateFailed(msg)


class SlopeRow:
    """One bench row: a chain of the row's call, measured as one slope per
    pass over REPS (bench.py:100-188). `measure_once()` is called once per
    interleaved pass."""

    def __init__(self, name, body, carry):
        self.name = name
        every = [r for tier in (REPS,) + REPS_LONGER for r in tier]
        self.chain = profiling.Chain(body, carry, profiling.chain_unit(*every))
        self.warm = set()
        self.rep_points = REPS
        self.slopes = []
        self.archived_slopes = []  # pre-escalation estimates (audit trail)
        self.escalations = 0
        self.setup_s = 0.0
        self.last_times = {}

    def measure_once(self) -> float:
        times = {}
        for reps in self.rep_points:
            if reps not in self.warm:  # the capture (first run) and a warm run
                self.chain.run(reps)
                self.warm.add(reps)
            times[reps] = min(self.chain.time(reps) for _ in range(TRIALS))
        self.last_times = times
        xs = np.array(self.rep_points, float)
        ys = np.array([times[r] for r in self.rep_points])
        return max(float(np.polyfit(xs, ys, 1)[0]), 1e-9)

    def prepare(self) -> float:
        """Capture the chain and take a pilot estimate (used for batch
        selection; not counted toward the K interleaved estimates). When the
        slope is under 30% of the longest chain's time per call, move to the
        next longer tier, up to 16x."""
        t0 = time.time()
        s = self.measure_once()
        for longer in REPS_LONGER:
            hi = self.rep_points[-1]
            if s > 0.3 * self.last_times[hi] / hi:
                break
            self.rep_points = longer
            s = self.measure_once()
        self.setup_s = time.time() - t0
        return s

    def escalate(self) -> bool:
        """Post-hoc chain-length escalation: the next longer REPS tier; the
        noisy short-chain pool is archived. False = tiers exhausted."""
        for tier in REPS_LONGER:
            if tier[-1] > self.rep_points[-1]:
                self.rep_points = tier
                self.archived_slopes += self.slopes
                self.slopes = []
                self.escalations += 1
                return True
        return False

    def release(self) -> None:
        self.chain.release()

    def stats(self) -> dict:
        s_min, spread, n_disc, _ = robust_slope_stats(self.slopes)
        return {
            "s_per_batch": s_min,
            "slope_estimates_ms": [s * 1e3 for s in self.slopes],
            "archived_slope_estimates_ms": [s * 1e3 for s in self.archived_slopes],
            "escalations": self.escalations,
            "rep_points": list(self.rep_points),
            "n_slopes_discarded": n_disc,
            "slope_spread": spread,
            "spread_warn": spread > SPREAD_WARN,
        }


def _serving_config(config):
    return dataclasses.replace(config, matmul_precision="high")


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def _nmse(got, want) -> float:
    return float(np.sum(np.abs(got - want) ** 2) / (np.sum(np.abs(want) ** 2) + 1e-30))


def _nmse_vs_oracle(case, nL, device) -> float:
    """One float32 evaluation of the configuration being benchmarked
    (matmul_precision="high") against the float64 oracle, through the
    reference-layout conformance path (bench.py:276-297)."""
    from ..models import estimator
    from ..utils import oracle

    res = estimator.estimate(
        case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
        np.float32(case.beta), case.hop1, case.hop2, _serving_config(case.config), device=device,
    )
    res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2,
                            case.config)
    return _nmse(np.asarray(res.channel_est_rg).astype(np.complex128), res_o.channel_est_rg)


def _nmse_vs_oracle_serve(case, nL, device, kernels="xla") -> float:
    """The same check through the serve-layout builder being timed
    (bench.py:300-330); kernels="pallas_front" gates the fused-front tier."""
    from ..models import estimator
    from ..utils import oracle

    fn = estimator.build_ri(case.hop1, case.hop2, _serving_config(case.config), nL,
                            out_layout="serve", kernels=kernels)
    rg = _tensor(estimator.split_ri(case.received_rg.astype(np.complex64)), device)
    pil = _tensor(estimator.split_ri(case.pilots.astype(np.complex64)), device)
    res = fn(rg, pil, torch.tensor(np.float32(case.beta), device=device))
    ch_ri = res.channel_est_rg.cpu().numpy().astype(np.float64)  # (2, nL, n_sym, n_sc)
    ch = np.transpose(ch_ri[0] + 1j * ch_ri[1], (2, 1, 0))  # (n_sc, n_sym, nL)
    res_o = oracle.estimate(case.received_rg, case.pilots, case.beta, case.hop1, case.hop2,
                            case.config)
    return _nmse(ch, res_o.channel_est_rg)


def _one_problem(case, device):
    from ..models import estimator

    rg = _tensor(estimator.split_ri(case.received_rg.astype(np.complex64)), device)
    pil = _tensor(estimator.split_ri(case.pilots.astype(np.complex64)), device)
    return rg, pil, torch.tensor(np.float32(case.beta), device=device)


def _gate_oracle_both(case, nL, params, device):
    """Modes the float64 oracle covers (wiener, time_interp): the conformance
    layout and the serve builder being timed (bench.py:353-360)."""
    r = {"nmse_vs_oracle": _nmse_vs_oracle(case, nL, device)}
    _gate(r["nmse_vs_oracle"] < 1e-6, f"quality-row conformance gate: {r}")
    r["nmse_vs_oracle_serve"] = _nmse_vs_oracle_serve(case, nL, device)
    _gate(r["nmse_vs_oracle_serve"] < 1e-6, f"quality-row serve gate: {r}")
    return r


def _gate_learned2d(case, nL, params, device):
    """learned2d has no oracle mirror: the timed "high"-precision builder
    against the "highest"-precision one, unbatched, with the same params
    (bench.py:363-387)."""
    from ..models import estimator

    rg, pil, beta = _one_problem(case, device)
    a, b = (
        estimator.build_ri(case.hop1, case.hop2, cfg, nL, out_layout="serve")(
            rg, pil, beta, params).channel_est_rg.cpu().numpy().astype(np.float64)
        for cfg in (case.config, _serving_config(case.config))
    )
    nmse = float(np.sum((a - b) ** 2) / (np.sum(a**2) + 1e-30))
    _gate(bool(np.isfinite(b).all()) and nmse < 1e-6, f"learned2d precision gate: {nmse}")
    return {"nmse_high_vs_highest": nmse}


def _gate_tracked(case, nL, params, device):
    """Slot 0 of the tracked estimator equals the plain serve estimate (w=0:
    gain 1, the first observation passes through; bench.py:395-415)."""
    from ..models import estimator, tracking

    cfg = _serving_config(case.config)
    rg, pil, beta = _one_problem(case, device)
    fn_t = tracking.build_tracked_ri(case.hop1, case.hop2, cfg, nL, batched=False,
                                     out_layout="serve", device=device)
    h0, w0 = tracking.init_state(case.hop1, case.hop2, cfg, nL, device=device)
    res_t, _, _ = fn_t(rg, pil, beta, h0, w0)
    res_p = estimator.build_ri(case.hop1, case.hop2, cfg, nL, out_layout="serve")(rg, pil, beta)
    a = res_p.channel_est_rg.cpu().numpy().astype(np.float64)
    b = res_t.channel_est_rg.cpu().numpy().astype(np.float64)
    nmse = float(np.sum((a - b) ** 2) / (np.sum(a**2) + 1e-30))
    _gate(nmse < 1e-9, f"tracked slot-0 gate (gain-1 passthrough): {nmse}")
    return {"nmse_slot0_vs_plain": nmse}


QUALITY_GATES = {  # bench.py:418-424
    "q_base_52prb_2l": _gate_oracle_both,
    "q_wiener_52prb_2l": _gate_oracle_both,
    "q_time_interp_52prb_2l": _gate_oracle_both,
    "q_tracked_52prb_2l": _gate_tracked,
    "q_learned2d_52prb": _gate_learned2d,
}


def row_specs(params2d) -> list:
    """[(row name, [make_row kwargs per candidate batch])]: bench.py's list
    (bench.py:597-672), in its order."""
    specs = []
    for name, (kwargs, batches) in BENCH_CONFIGS.items():
        specs.append((name, [dict(kwargs=kwargs, batch=b) for b in batches]))
    # factored serving output, same batch sweep as the dense rows (:605-613)
    for fname in (HEADLINE, "c3_cnn_273prb"):
        kwargs, batches = BENCH_CONFIGS[fname]
        specs.append((fname + "_factored",
                      [dict(kwargs=kwargs, batch=b, out_layout="factored") for b in batches]))
    # the joint 4 RX x 4 layer receiver, and with the 256QAM demap (:614-625)
    kwargs, _ = BENCH_CONFIGS[HEADLINE]
    specs.append(("c2_receiver_4rx4l", [dict(kwargs=kwargs, batch=b, n_rx=4) for b in (64, 128)]))
    specs.append(("c2_receiver_4rx4l_llr256",
                  [dict(kwargs=kwargs, batch=b, n_rx=4, modulation="256qam") for b in (64, 128)]))
    # the kernel tiers on the headline config (:631, :639)
    specs.append((HEADLINE + "_pallas", [dict(kwargs=kwargs, batch=128, kernels="pallas")]))
    specs.append((HEADLINE + "_pallas_front",
                  [dict(kwargs=kwargs, batch=128, kernels="pallas_front")]))
    # the quality-bearing serving modes (:642-672)
    q_kw = dict(n_prbs=52, n_layers=2, comb=2, scs_hz=30e3)
    specs.append(("q_base_52prb_2l", [dict(kwargs=q_kw, batch=128)]))
    specs.append(("q_wiener_52prb_2l", [dict(kwargs=dict(q_kw, smoothing="wiener"), batch=128)]))
    specs.append(("q_time_interp_52prb_2l",
                  [dict(kwargs=dict(q_kw, time_interp="linear", doppler_hz=300.0), batch=128)]))
    specs.append(("q_tracked_52prb_2l", [dict(kwargs=q_kw, batch=128, tracked=True)]))
    specs.append(("q_learned2d_52prb", [dict(
        kwargs=dict(q_kw, smoothing="learned2d", time_interp="linear", doppler_hz=300.0),
        batch=128, params=params2d)]))
    return specs


def row_chain(case, batch, device, out_layout="serve", n_rx=None, modulation=None,
              kernels="xla", params=None, tracked=False):
    """(body, carry) of one row's chain at `batch` on `device`: the row's
    builder on the case tiled to the batch, the next call's grid the last
    one's plus 1e-12 times a strided sum of its output (bench.py:191-273)."""
    from ..models import estimator, receiver, tracking

    nL = case.pilots.shape[2]
    cfg = _serving_config(case.config)
    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    if n_rx is not None:  # joint receiver: n_rx port grids per problem (2, n_rx, n_sc, n_sym)
        rg = np.broadcast_to(rg[:, None], (2, n_rx) + rg.shape[1:])
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    tile = lambda a: _tensor(np.broadcast_to(a, (batch,) + a.shape), device)
    rg_b, pil_b = tile(rg), tile(pil)
    beta = torch.ones(batch, dtype=torch.float32, device=device)
    sample = lambda o: o[..., 0, 0, ::127].float().sum()

    if tracked:
        fn = tracking.build_tracked_ri(case.hop1, case.hop2, cfg, nL, batched=True,
                                       out_layout="serve", device=device)
        h0, w0 = tracking.init_state(case.hop1, case.hop2, cfg, nL, batch=batch, device=device)

        def body(carry):  # the state threads through the chain: a slot per call
            rg_c, h, w = carry
            res, h_new, w_new = fn(rg_c, pil_b, beta, h, w)
            return rg_c + 1e-12 * sample(res.channel_est_rg), tuple(h_new), w_new

        return body, (rg_b, tuple(h0), w0)
    if n_rx is not None:
        fn = receiver.build_receiver_ri(case.hop1, case.hop2, cfg, nL, n_rx, batched=True,
                                        mode="factored", modulation=modulation, device=device)

        def body(rg_c):
            res = fn(rg_c, pil_b, beta)
            outs = res.llr if modulation else (res.x,)  # llr: a tuple of int8 planes
            return rg_c + 1e-12 * sum(sample(o) for o in outs)

        return body, rg_b
    fn = estimator.build_ri(case.hop1, case.hop2, cfg, nL, batched=True, kernels=kernels,
                            out_layout=out_layout)
    extra = () if params is None else (params,)

    def body(rg_c):
        res = fn(rg_c, pil_b, beta, *extra)
        if out_layout == "factored":
            s = sample(res.profiles) + res.sym_rot.sum()
        else:
            s = sample(res.channel_est_rg)
        return rg_c + 1e-12 * s

    return body, rg_b


def make_row(name, kwargs, batch, out_layout="serve", n_rx=None, modulation=None,
             kernels="xla", params=None, tracked=False, device="cuda"):
    """One SlopeRow plus its static metadata (grid REs, the byte floor;
    bench.py:438-497)."""
    case = synthetic.make_case(seed=1234, snr_db=30.0, **kwargs)
    nL = case.pilots.shape[2]
    opts = dict(out_layout=out_layout, n_rx=n_rx, modulation=modulation, kernels=kernels,
                params=params, tracked=tracked)
    row = SlopeRow(name, *row_chain(case, batch, device, **opts))

    # channel REs produced per problem; the receiver performs n_rx estimations
    grid_res = case.received_rg.size * nL * (n_rx or 1)
    # the byte floor: read the carried grid + pilots, write the output (f32 ri
    # pairs; the receiver: the symbol grid or int8 LLRs, plus per-sc SINR)
    n_sc = case.received_rg.shape[0]
    in_bytes = 2 * case.received_rg.size * 4 * (n_rx or 1) + 2 * case.pilots.size * 4
    if n_rx is not None and modulation is not None:
        from ..ops import demap

        nbits = demap.bits_per_symbol(modulation)
        out_bytes = nbits * nL * case.received_rg.size + nL * n_sc * 4
    elif n_rx is not None:
        out_bytes = 2 * nL * case.received_rg.size * 4 + nL * n_sc * 4
    elif out_layout == "factored":
        n_hops = 2 if case.hop2 is not None else 1
        out_bytes = 2 * (n_hops * nL * n_sc + 14) * 4
    else:
        out_bytes = 2 * nL * case.received_rg.size * 4
        if tracked:  # the per-hop tracked state is written too
            n_hops = 2 if case.hop2 is not None else 1
            out_bytes += 2 * n_hops * nL * case.pilots.shape[0] * 4
    meta = {
        "batch": batch, "grid_res": grid_res, "floor_s": batch * (in_bytes + out_bytes) / HBM_BW,
        "case": case, "nL": nL, "params": params, "opts": opts,
    }
    return row, meta


def product_flops(meta) -> float:
    """Products (matmuls, convolutions) of one call at the row's batch,
    counted by FlopCounterMode over one eager call on the CPU (each CUDA
    kernel runs its plain version there) at batch 1 and 2, carried linearly
    to the batch."""
    from torch.utils.flop_counter import FlopCounterMode

    opts = dict(meta["opts"])
    if opts["params"] is not None:
        opts["params"] = {k: v.cpu() for k, v in opts["params"].items()}
    counts = []
    for b in (1, 2):
        body, carry = row_chain(meta["case"], b, torch.device("cpu"), **opts)
        body(carry)  # the plan's tensors are built by the first call
        with FlopCounterMode(display=False) as fc:
            body(carry)
        counts.append(fc.get_total_flops())
    return float(counts[0] + (counts[1] - counts[0]) * (meta["batch"] - 1))


def row_bounds(meta, per_batch: float) -> dict:
    """The binding resource: the byte floor beside the product floor; bound =
    the larger; x_over_bound = measured / binding floor (1.0 = speed of
    light). Peaks: PEAKS (an H100 SXM)."""
    out = {"hbm_floor_ms": meta["floor_s"] * 1e3}
    flops = product_flops(meta)
    out["product_flops_per_batch"] = flops
    out["compute_floor_ms"] = flops / F32_FLOPS * 1e3
    binding = max((out["hbm_floor_ms"], "hbm"), (out["compute_floor_ms"], "compute"))
    out["bound"] = binding[1]
    out["x_over_bound"] = per_batch * 1e3 / max(binding[0], 1e-12)
    return out


def row_details(row: SlopeRow, meta) -> dict:
    st = row.stats()
    per_batch = st["s_per_batch"]
    batch, grid_res, floor_s = meta["batch"], meta["grid_res"], meta["floor_s"]
    return {
        "latency_ms_per_batch": per_batch * 1e3,
        "batch": batch,
        "problems_per_s": batch / per_batch,
        "res_per_s": batch * grid_res / per_batch,
        "grid_res_per_problem": grid_res,
        "slope_estimates_ms": st["slope_estimates_ms"],
        "archived_slope_estimates_ms": st["archived_slope_estimates_ms"],
        "escalations": st["escalations"],
        "rep_points": st["rep_points"],
        "n_slopes_discarded": st["n_slopes_discarded"],
        "slope_spread": st["slope_spread"],
        "spread_warn": st["spread_warn"],
        "times_s": {str(k): v for k, v in row.last_times.items()},
        "setup_s": row.setup_s,
        "x_over_hbm_floor": per_batch / floor_s,
        **row_bounds(meta, per_batch),
    }


def select_batch_rows(specs, device, details):
    """For each spec prepare a row per candidate batch and keep the best
    pilot-estimate res_per_s (bench.py:562-586). Returns {name: (row, meta)};
    a spec none of whose candidates ran gets its error in `details`."""
    winners = {}
    for name, candidates in specs:
        best, errors = None, []
        for make_kwargs in candidates:
            row = None
            try:
                row, meta = make_row(name, device=device, **make_kwargs)
                s = row.prepare()
                r = meta["batch"] * meta["grid_res"] / s
                if best is None or r > best[2]:
                    if best is not None:
                        best[0].release()  # drop the loser's graph
                    best = (row, meta, r, s)
                else:
                    row.release()
            except Exception as e:
                if row is not None:
                    row.release()
                errors.append(f"batch {make_kwargs['batch']}: {type(e).__name__}: {e}")
                log(f"{name} (batch candidate {make_kwargs['batch']}) FAILED: "
                    f"{type(e).__name__}: {e}")
        if best is not None:
            # the winner's pilot estimate is itself an independent slope sample
            best[0].slopes.append(best[3])
            winners[name] = (best[0], best[1])
        else:
            details[name] = {"error": "; ".join(errors)}
    return winners


def _card(device) -> dict:
    """The device every number ran on: name, count and, for a card,
    `nvidia-smi`'s name and power limit."""
    dev = torch.device(device)
    info = {"platform": dev.type, "name": devices.name(dev), "torch": torch.__version__}
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        info["nvidia_smi"] = smi[dev.index or 0]
        info["count"] = torch.cuda.device_count()
        info["cuda"] = torch.version.cuda
    return info


def _baseline():
    """BASELINE_MEASURED.json's results and hardware string, read-only (the
    checkout's root, beside the port package); ({}, None) when absent."""
    path = Path(__file__).resolve().parents[2] / "BASELINE_MEASURED.json"
    if not path.exists():
        return {}, None
    data = json.loads(path.read_text())
    return data.get("results", {}), data.get("hardware")


def _decode_words(code, batch, snr_db, seed=0):
    """(plan, payloads, float32 LLRs) of `batch` random words of `code` at
    `snr_db` (bench.py's BPSK-AWGN LLRs)."""
    from ..ops import ldpc

    lplan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, lplan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    snr = 10.0 ** (snr_db / 10.0)
    llr = (4 * snr * ((1 - 2.0 * cw) + rng.normal(0, np.sqrt(0.5 / snr), cw.shape))
           ).astype(np.float32)
    return lplan, u, llr


def _exact(res, u) -> bool:
    return bool(res.ok.all()) and np.array_equal(res.info.cpu().numpy(), u)


def _decoder_slope(dec, llr_t, reps_lo, reps_hi):
    """chained_slope_stats of `dec`'s posterior, the next call's LLRs the
    last posterior clipped to +-LLR_CLIP (min-sum grows the magnitudes)."""
    fb = lambda carry, out: torch.clamp(out, -LLR_CLIP, LLR_CLIP)
    return profiling.chained_slope_stats(dec.posterior, fb, (llr_t,), reps_lo=reps_lo,
                                         reps_hi=reps_hi, k=K_SLOPES)


def bench_ldpc_n976(device) -> dict:
    """QC-LDPC decode throughput: 25-sweep normalized min-sum on the rate-0.63
    n=976 code of the coded link-level eval, batch 512, on K4 ("pallas"), the
    plain "xla" tier, and layered at 13 sweeps (bench.py:792-866)."""
    from ..ops import ldpc

    code = ldpc.array_code(6, 16, 61)
    lplan, u, llr = _decode_words(code, 512, 4.0)
    llr_t = _tensor(llr, device)
    dec = ldpc.build_decoder(code, n_iters=25, kernels="pallas", device=device)
    dec_xla = ldpc.build_decoder(code, n_iters=25, device=device)
    res = dec(llr_t)
    _gate(_exact(res, u), "LDPC decode correctness gate failed on device")
    _gate(torch.equal(res.bits, dec_xla(llr_t).bits),
          "pallas decode tier diverged from the XLA tier on device")
    st = _decoder_slope(dec, llr_t, 4, 20)
    t = st["s_per_step"]
    t_xla = _decoder_slope(dec_xla, llr_t, 4, 20)["s_per_step"]
    dec_lay = ldpc.build_decoder(code, n_iters=13, kernels="pallas", schedule="layered",
                                 device=device)
    lay_ok = _exact(dec_lay(llr_t), u)
    r = {
        "latency_ms_per_batch": t * 1e3,
        "slope_spread": st["spread"],
        "xla_tier_ms_per_batch": t_xla * 1e3,
        "layered13_payload_exact": lay_ok,
        "batch": 512,
        "code": "array(6,16,61) n=976 k=%d rate=%.2f" % (lplan.k, lplan.k / code.n),
        "n_iters": 25,
        "tier": dec.tier,
        "info_bits_per_s": 512 * lplan.k / t,
        "edge_msgs_per_s": 512 * len(lplan.edges) * code.z * 25 / t,
    }
    lay_msg = "exact=False (speedup withheld)"
    if lay_ok:  # a layered number is published only from a payload-exact decode
        t_lay = _decoder_slope(dec_lay, llr_t, 16, 64)["s_per_step"]
        r["layered13_ms_per_batch"] = t_lay * 1e3
        r["layered13_info_bits_per_s"] = 512 * lplan.k / t_lay
        lay_msg = f"{t_lay*1e3:.3f} ms ({r['layered13_info_bits_per_s']/1e6:.0f} Mb/s, exact=True)"
    log(f"ldpc_decode_n976_b512: {t*1e3:.3f} ms/batch512 ({dec.tier}, spread {st['spread']:.1%}) "
        f"-> {r['info_bits_per_s']/1e6:.1f} info Mb/s; xla tier {t_xla*1e3:.3f} ms; "
        f"layered-13 {lay_msg}")
    return r


#: the NR flooding rows: name, base graph, Z, sweeps, batch, layered at half (bench.py:876-880)
NR_ROWS = (
    ("nr_bg2_z208", 2, 208, 16, 128, True),
    ("nr_bg1_z52", 1, 52, 16, 128, True),
    ("nr_bg1_z384", 1, 384, 16, 32, False),
)
#: the streamed rows: name, Z, sweeps, batch (bench.py:966-969)
STREAM_ROWS = (
    ("nr_bg1_z384_streamed", 384, 8, 128),
    ("nr_bg1_z240_streamed", 240, 8, 128),
)


def bench_nr(bname, bg, z, iters, batch, try_layered, device) -> dict:
    """NR LDPC decode on kernels="auto" (K4 for the codes within the unroll
    budget on the card, the gather tier for BG1 Z=384), and the layered
    schedule at half the sweeps, gated on the same payload (bench.py:881-954)."""
    from ..ops import ldpc, nr_ldpc

    code = nr_ldpc.nr_base_graph(bg, z)
    lplan, u, llr = _decode_words(code, batch, 3.5)
    llr_t = _tensor(llr, device)
    dec = ldpc.build_decoder(code, n_iters=iters, kernels="auto", device=device)
    _gate(_exact(dec(llr_t), u), f"{bname} decode correctness gate failed")
    st = _decoder_slope(dec, llr_t, 4, 16)
    t = st["s_per_step"]
    r = {
        "latency_ms_per_batch": t * 1e3,
        "slope_spread": st["spread"],
        "batch": batch,
        "code": f"NR BG{bg} Z={z} n={code.n} k={lplan.k}",
        "n_iters": iters,
        "tier": dec.tier,
        "info_bits_per_s": batch * lplan.k / t,
    }
    lay_msg = ""
    if try_layered:
        g_sel = ldpc.default_layered_group(code)
        dec_lay = ldpc.build_decoder(code, n_iters=iters // 2, kernels="pallas",
                                     schedule="layered", layered_group=g_sel, device=device)
        lay_ok = _exact(dec_lay(llr_t), u)
        r["layered_payload_exact"] = lay_ok
        r["layered_group"] = g_sel
        r["layered_group_rationale"] = (
            "default_layered_group, the JAX package's measured rule (sublane-z -> 1; lane-z "
            "one-register -> 2; wider -> 8), kept so that the rows decode as JAX's do"
        )
        lay_msg = f"; layered-{iters//2} exact=False (speedup withheld)"
        if lay_ok:
            t_lay = _decoder_slope(dec_lay, llr_t, 4, 16)["s_per_step"]
            r["layered_half_iters_ms_per_batch"] = t_lay * 1e3
            r["layered_info_bits_per_s"] = batch * lplan.k / t_lay
            r["layered_speedup"] = t / t_lay
            lay_msg = (f"; layered-{iters//2} {t_lay*1e3:.3f} ms "
                       f"({r['layered_info_bits_per_s']/1e6:.0f} Mb/s, "
                       f"{r['layered_speedup']:.2f}x, exact=True)")
    log(f"{bname} [{r['tier']}]: {t*1e3:.3f} ms/batch{batch} ({iters} iters, spread "
        f"{st['spread']:.1%}) -> {r['info_bits_per_s']/1e6:.1f} info Mb/s (n={code.n})" + lay_msg)
    return r


def bench_streamed(sname, z_s, iters_s, batch_s, device, details) -> dict:
    """The streamed tier (K3, layered, bfloat16 messages) reached through
    kernels="auto" with schedule="layered" on codes over the unroll budget
    (bench.py:966-1057)."""
    from ..ops import ldpc, nr_ldpc
    from ..ops.kernels import ldpc as k4

    code = nr_ldpc.nr_base_graph(1, z_s)
    _gate(ldpc._edge_z(code) > ldpc._UNROLL_EDGE_Z_BUDGET,
          f"BG1 Z={z_s} is within the unroll budget: the auto route would not stream it")
    lplan, u, llr = _decode_words(code, batch_s, 3.5)
    llr_t = _tensor(llr, device)
    g_sel = ldpc.default_layered_group(code)
    dec = ldpc.build_decoder(code, n_iters=iters_s, kernels="auto", schedule="layered",
                             layered_group=g_sel, stream_c2v_dtype="bfloat16", device=device)
    ok = _exact(dec(llr_t), u)
    _gate(ok, f"streamed BG1 Z={z_s} decode not payload-exact; withheld")
    st = _decoder_slope(dec, llr_t, 4, 16)
    t = st["s_per_step"]
    r = {
        "latency_ms_per_batch": t * 1e3,
        "slope_spread": st["spread"],
        "escalations": st["escalations"],
        "batch": batch_s,
        "code": f"NR BG1 Z={z_s} n={code.n} k={lplan.k}",
        "n_iters": iters_s,
        "schedule": "layered",
        "tier": f"{dec.tier} (kernels='auto')",
        "layered_group": g_sel,
        "stream_c2v_dtype": "bfloat16",
        "payload_exact": ok,
        "info_bits_per_s": batch_s * lplan.k / t,
    }
    if llr_t.is_cuda:
        n_sm = torch.cuda.get_device_properties(llr_t.device).multi_processor_count
        lp = k4.launch_plan(k4.wiring(lplan, llr_t.device), batch_s, 2, True, g_sel, n_sm)
        r["launch_plan"] = {"route": lp.route, "codewords_per_block": lp.cpb,
                            "blocks": lp.blocks, "smem_bytes": lp.smem}
    g = details.get("nr_bg1_z384", {}).get("info_bits_per_s")
    if g:
        r["speedup_vs_gather_tier_z384"] = r["info_bits_per_s"] / g
    log(f"{sname} [{dec.tier}/auto, layered-{iters_s}, G={g_sel}]: {t*1e3:.3f} ms/batch{batch_s} "
        f"(spread {st['spread']:.1%}) -> {r['info_bits_per_s']/1e6:.1f} info Mb/s"
        + (f" ({r['speedup_vs_gather_tier_z384']:.0f}x the z384 gather row)" if g else ""))
    return r


def bench_e2e(device) -> dict:
    """The full NR uplink chain, end to end: 273-PRB QPSK slots carrying TS
    38.212 rate-matched BG1 Z=384 words through serving.process(out=
    "decoded"), host wall clock over slot count, both decode paths,
    payload-exact on every pass (bench.py:1059-1200)."""
    from .. import serving, transport
    from ..ops import demap, ldpc, nr_ldpc

    code = nr_ldpc.nr_base_graph(1, 384)
    lplan = ldpc.make_ldpc_plan(code)
    g_sel = ldpc.default_layered_group(code)
    coding = transport.TransportCoding(
        code=code, rate_match="nr", tx_bits=2 * 8448, schedule="layered", n_iters=16,
        crc="crc24b", interleave_seed=7, layered_group=g_sel, stream_c2v_dtype="bfloat16",
    )
    nbits = demap.bits_per_symbol("qpsk")
    seed = 4242
    geo = synthetic.make_case(seed=seed, snr_db=15.0, n_prbs=273, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
    k_pay = transport.payload_bits(coding, lplan.k)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (lay.c_words, k_pay), dtype=np.uint8)
    words = transport.crc_attach(u, "crc24b")
    if coding.n_filler:
        words = np.concatenate([words, np.zeros((lay.c_words, coding.n_filler), np.uint8)], axis=1)
    bits = transport.place_codewords(lay, ldpc.encode(code, words), 1, nbits, fill_rng=rng)
    case = synthetic.make_mimo_case(seed=seed, n_rx=1, modulation="qpsk", scramble=False,
                                    bits=bits, n_prbs=273, n_layers=1, snr_db=15.0)
    prob = serving.Problem(case.received_rg.astype(np.complex64), case.pilots.astype(np.complex64),
                           case.beta, case.hop1, case.hop2, case.config)

    def run_slots(n, on_device=False):
        t0 = time.perf_counter()
        res = serving.process([prob] * n, batch_size=8, out="decoded", modulation="qpsk",
                              coding=coding, matmul_precision="high",
                              decode_on_device=on_device, device=device)
        dt = time.perf_counter() - t0
        for rr in res:  # payload-exact gate on EVERY timed pass
            _gate(bool(np.asarray(rr.ok).all()) and np.array_equal(rr.info, u),
                  "e2e decoded chain not payload-exact; throughput withheld")
        return dt

    def slopes(n_lo, n_hi, reps_inner, on_device):
        sl = []
        for _ in range(K_SLOPES):
            t_lo = min(run_slots(n_lo, on_device) for _ in range(reps_inner))
            t_hi = min(run_slots(n_hi, on_device) for _ in range(reps_inner))
            sl.append(max((t_hi - t_lo) / (n_hi - n_lo), 1e-9))
        return sl

    def measured(n_lo, n_hi, on_device):
        run_slots(n_lo, on_device)  # warm both chunk shapes
        run_slots(n_hi, on_device)
        sl = slopes(n_lo, n_hi, 2, on_device)
        t, spread, n_disc, _ = robust_slope_stats(sl)
        if spread > SPREAD_WARN:  # host-clock jitter: more inner repeats
            sl = slopes(n_lo, n_hi, 4, on_device)
            t, spread, n_disc, _ = robust_slope_stats(sl)
        return t, spread, n_disc, sl

    n_lo, n_hi = 8, 24
    t_slot, spread_e2e, n_disc_e2e, slopes_e2e = measured(n_lo, n_hi, False)
    # the device-resident chain: the LLR grid stays on the card, only decoded
    # bits come back; a wider slot range against the host clock's jitter
    t_dev, spread_dev, _, slopes_dev = measured(n_lo, 3 * n_hi, True)
    info_bits_slot = lay.c_words * k_pay
    r = {
        "latency_ms_per_slot": t_slot * 1e3,
        "slope_estimates_ms": [s * 1e3 for s in slopes_e2e],
        "slope_spread": spread_e2e,
        "n_slopes_discarded": n_disc_e2e,
        "slots": [n_lo, n_hi],
        "words_per_slot": int(lay.c_words),
        "info_bits_per_slot": int(info_bits_slot),
        "code": f"NR BG1 Z=384 rate-matched E={coding.tx_bits} crc24b",
        "schedule": f"layered-{coding.n_iters} G={g_sel} (auto -> pallas_stream)",
        "payload_exact": True,
        "info_bits_per_s": info_bits_slot / t_slot,
        "device_decode_ms_per_slot": t_dev * 1e3,
        "device_decode_spread": spread_dev,
        "device_decode_slope_estimates_ms": [s * 1e3 for s in slopes_dev],
        "device_decode_info_bits_per_s": info_bits_slot / t_dev,
        "device_decode_speedup": t_slot / t_dev,
        "note": (
            "host wall-clock slope over slot count through serving.process(out='decoded'): "
            "native packing, estimation + MMSE + demap on the device, the int8 LLR fetch, "
            "descramble / deinterleave, chunked streamed decode (K3), CRC; device_decode_* = "
            "decode_on_device=True (rate recovery and decode on the card in one CUDA graph a "
            "chunk; only decoded bits come back)"
        ),
    }
    log(f"e2e_decoded_273prb_bg1z384: {t_slot*1e3:.1f} ms/slot (spread {spread_e2e:.1%}, "
        f"{lay.c_words} words/slot) -> {info_bits_slot / t_slot / 1e6:.1f} info Mb/s end-to-end; "
        f"device-resident {t_dev*1e3:.1f} ms/slot ({t_slot/t_dev:.1f}x, spread {spread_dev:.1%})")
    return r


def _row_gates(name, r, meta, details, baseline, device) -> None:
    """The correctness gates and comparisons of one slope row (bench.py:720-782)."""
    from ..models import estimator
    from ..models.plan import make_plan

    case, nL = meta["case"], meta["nL"]
    if name in BENCH_CONFIGS:
        r["nmse_vs_oracle"] = _nmse_vs_oracle(case, nL, device)
        _gate(r["nmse_vs_oracle"] < 1e-6, f"bench correctness gate: {r['nmse_vs_oracle']}")
        r["nmse_vs_oracle_serve"] = _nmse_vs_oracle_serve(case, nL, device)
        _gate(r["nmse_vs_oracle_serve"] < 1e-6,
              f"serve correctness gate: {r['nmse_vs_oracle_serve']}")
        if name == HEADLINE:
            _gate(r["nmse_vs_oracle"] < 1e-12,
                  f"c2 conformance NMSE regression: {r['nmse_vs_oracle']}")
            _gate(r["nmse_vs_oracle_serve"] < 4e-11,
                  f"c2 serve NMSE regression: {r['nmse_vs_oracle_serve']}")
        bl = baseline.get(name, {}).get("res_per_s")
        r["vs_reference_cpu"] = (r["res_per_s"] / bl) if bl else None
    if name == HEADLINE + "_pallas":
        plan = make_plan(case.hop1, case.hop2, _serving_config(case.config), nL)
        # which route ran: the deferred batched fill (K2) or the per-problem one
        r["pallas_tier"] = ("deferred_batched_fill" if estimator._serve_pallas_deferred_ok(plan)
                            else "per_problem_fallback")
        r["xla_tier_ms_per_batch"] = details.get(HEADLINE, {}).get("latency_ms_per_batch")
    if name in QUALITY_GATES:
        r.update(QUALITY_GATES[name](case, nL, meta.get("params"), device))
        base = details.get("q_base_52prb_2l", {}).get("latency_ms_per_batch")
        if base:  # the cost multiple vs the plain serve path at the same geometry
            r["x_vs_plain_serve"] = r["latency_ms_per_batch"] / base
    if name == HEADLINE + "_pallas_front":
        r["nmse_vs_oracle_serve"] = _nmse_vs_oracle_serve(case, nL, device, kernels="pallas_front")
        _gate(r["nmse_vs_oracle_serve"] < 4e-11,
              f"pallas_front serve NMSE gate: {r['nmse_vs_oracle_serve']}")
        r["xla_tier_ms_per_batch"] = details.get(HEADLINE, {}).get("latency_ms_per_batch")


def run(device) -> dict:
    """Every row of bench.py on `device`: {"device", "peaks", "configs"}; a
    row that failed holds its "error"."""
    from ..models import denoiser

    dev = devices.resolve(device, arg="--device ")
    card = _card(dev)
    log(f"bench device: {card}")
    baseline, hardware = _baseline()
    details = {}
    t_start = time.time()

    # ---- Phase 1: build + capture every slope row (batch selection included) ----
    try:
        params2d = denoiser.load_shipped("2d", device=dev)
    except Exception as e:  # the row records why; the other rows go on
        params2d = None
        details["q_learned2d_52prb"] = {"error": f"shipped 2-D denoiser: {type(e).__name__}: {e}"}
    specs = [s for s in row_specs(params2d)
             if not (s[0] == "q_learned2d_52prb" and params2d is None)]
    rows = select_batch_rows(specs, dev, details)

    # ---- Phase 2: K interleaved measurement passes over ALL rows ----
    failed = {}
    for k in range(K_SLOPES):
        for name, (row, meta) in rows.items():
            try:
                row.slopes.append(row.measure_once())
            except Exception as e:
                failed[name] = f"pass {k}: {type(e).__name__}: {e}"
                log(f"{name} pass {k} FAILED: {type(e).__name__}: {e}")
        log(f"slope pass {k + 1}/{K_SLOPES} done")

    # ---- Phase 2.5: post-hoc chain-length escalation of noisy rows ----
    for esc in range(len(REPS_LONGER)):
        noisy = [(n, rw) for n, (rw, _m) in rows.items() if rw.slopes and rw.stats()["spread_warn"]]
        moved = []
        for name, rw in noisy:
            if not rw.escalate():
                continue  # tiers exhausted; spread_warn stands, documented
            moved.append(name)
            try:
                for _ in range(K_SLOPES):
                    rw.slopes.append(rw.measure_once())
            except Exception as e:
                failed[name] = f"escalation: {type(e).__name__}: {e}"
                log(f"{name} escalation FAILED: {type(e).__name__}: {e}")
        if not moved:
            break
        log(f"escalation round {esc + 1}: re-measured {moved} at longer chains")

    # ---- Phase 3: details + correctness gates ----
    for name, (row, meta) in rows.items():
        row.release()
        try:
            if name in failed:
                raise RuntimeError(failed[name])
            if not row.slopes:
                raise RuntimeError("no successful slope estimate")
            r = row_details(row, meta)
            _row_gates(name, r, meta, details, baseline, dev)
            if r.get("vs_reference_cpu") is not None:
                r["reference_cpu_hardware"] = hardware
            details[name] = r
            warn = " [SPREAD>10%]" if r["spread_warn"] else ""
            log(f"{name}: {r['latency_ms_per_batch']:.3f} ms/batch{r['batch']} (min of "
                f"{len(row.slopes)}, spread {r['slope_spread']:.1%}{warn}) -> "
                f"{r['res_per_s']:.3e} REs/s, {r['x_over_bound']:.1f}x its {r['bound']} bound"
                + (f", nmse {r['nmse_vs_oracle']:.1e}" if "nmse_vs_oracle" in r else ""))
        except Exception as e:  # keep the bench going; the row records its failure
            log(f"{name} FAILED: {type(e).__name__}: {e}")
            details[name] = {"error": f"{type(e).__name__}: {e}"}
    rows = None

    # ---- the decode rows and the end-to-end row ----
    def guarded(name, fn, *a):
        try:
            details[name] = fn(*a)
        except Exception as e:
            log(f"{name} FAILED: {type(e).__name__}: {e}")
            details[name] = {"error": f"{type(e).__name__}: {e}"}

    guarded("ldpc_decode_n976_b512", bench_ldpc_n976, dev)
    for spec in NR_ROWS:
        guarded(spec[0], bench_nr, *spec, dev)
    for spec in STREAM_ROWS:
        guarded(spec[0], bench_streamed, *spec, dev, details)
    guarded("e2e_decoded_273prb_bg1z384", bench_e2e, dev)
    log(f"bench wall {time.time() - t_start:.1f} s")
    return {"device": card, "peaks": PEAKS, "reference_cpu_hardware": hardware,
            "configs": details}


def headline(report: dict) -> dict:
    """The one-line JSON headline (bench.py:1210-1222)."""
    head = report["configs"].get(HEADLINE, {})
    return {
        "metric": "channel-estimate REs/s/chip (106PRB 4-port MMSE)",
        "value": head.get("res_per_s", 0.0),
        "unit": "REs/s",
        "vs_baseline": head.get("vs_reference_cpu") or 0.0,
        "baseline_hardware": report["reference_cpu_hardware"],
        "slope_spread": head.get("slope_spread"),
        "n_slope_estimates": len(head.get("slope_estimates_ms", [])),
        "device": report["device"].get("nvidia_smi", report["device"]["name"]),
    }


def failures(report: dict) -> list:
    """The names of the rows that failed (an exception or a gate)."""
    return [n for n, r in report["configs"].items() if "error" in r]


def main(device="cuda", out="chiprun_out/torch_bench_details.json") -> int:
    """Run every row, write the details to `out`, print the headline last;
    1 when any row failed."""
    report = run(device)
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, default=str))
    bad = failures(report)
    log(f"details written to {path}; rows failed: {bad or 'none'}")
    print(json.dumps(headline(report)))
    return 1 if bad else 0
