"""Multi-device scaling-efficiency benchmark of the port, the counterpart of
the JAX package's `bench_scaling.py` (BASELINE.json: '>=80% samples/s scaling
efficiency from 1 chip to N>=2 hosts').

    python -m srsran_ce_tpu_torch.validation.cli scaling --device cpu|cuda --out PATH

Rows (bench_scaling.py's, written to `--out`, never to BENCH_SCALING.json):

  dp weak scaling    batched estimation on dp meshes of 1..N ranks, 16
                     problems a rank: the step time as the slope of a chained
                     call (`utils/profiling`), the host's dispatch as a loop of
                     calls minus it; the same total batch on one rank beside
                     each (framework efficiency);
  sp wideband 273PRB one 273-PRB batch of 2 sharded over the subcarriers at
                     sp = 1/2/4/8 (every multi-shard row takes the padded
                     route: 273 = 3*7*13), with the per-shard compute proxy
                     (the same builder on a 1/n-wide band, one rank) and the
                     seam cost;
  config4 4096       BASELINE config[4]: 4096 frequency-hopped problems on
                     dp x sp meshes, with the one-rank step beside.

The port runs one process a rank (`parallel.launch.spawn_world`), where JAX
ran one program over a mesh; a step of the world ends when its last rank's
step ends (`profiling.Chain.time` waits for every rank). Worlds:

  --device cpu   gloo worlds of 1, 2, 4 and 8 CPU processes: the counterpart
                 of the JAX package's re-run on the 8-device virtual CPU
                 platform. As there, ranks beyond the cores time-slice them,
                 so the one-rank step pinned to one core (a `taskset -c 0`
                 child) normalises the efficiency
                 (`efficiency_core_normalized`, unclamped).
  --device cuda  NCCL worlds of up to `torch.cuda.device_count()` ranks, one
                 card a rank; the world sizes past the card count are listed
                 in the report's `not_run`, never run on the CPU instead.

The last line of standard output is a one-line JSON summary with the raw,
framework and core-normalised efficiencies at the largest world run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import devices
from ..utils import synthetic
from ..utils.profiling import (StructuredReport, chained_throughput, world_barrier,
                               world_seconds)

#: the world sizes of the sweep (bench_scaling.py's 1/2/4/8 devices)
WORLD_SIZES = (1, 2, 4, 8)
PER_DEVICE_BATCH = 16


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _inputs(case, batch, device):
    """The case tiled to `batch` problems as float32 ri tensors (rg, pil, beta)."""
    from ..models import estimator as est

    rg = est.split_ri(case.received_rg.astype(np.complex64))
    pil = est.split_ri(case.pilots.astype(np.complex64))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(np.broadcast_to(a, (batch,) + a.shape)),
                                  device=device)
    return t(rg), t(pil), torch.ones(batch, dtype=torch.float32, device=device)


def _chained(fn, rg, pil, beta, reps_lo, reps_hi):
    """Seconds a step of `fn` as the slope of a serial chain, the next grid
    the last plus 1e-12 times the channel summed over the layers."""

    def step(rg_c, pil_b, beta_b):
        out = fn(rg_c, pil_b, beta_b)
        return out.channel_est_rg, out.noise_est

    def feedback(carry, out):
        ch, _nz = out
        return carry + 1e-12 * ch.sum(dim=-1)

    return chained_throughput(step, feedback, (rg, pil, beta), reps_lo=reps_lo, reps_hi=reps_hi)


def _host_step(fn, args, n_iter: int, device) -> float:
    """Seconds a call of `fn(*args)` in a loop of `n_iter` calls (each a
    replay of the builder's CUDA graph on the card), the longest rank's."""
    for _ in range(2):  # a key's first call is eager, its second the capture
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    world_barrier()
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    del out
    return world_seconds((time.perf_counter() - t0) / n_iter)


def measure_dp(n_dev: int, per_device_batch: int = PER_DEVICE_BATCH, *, device):
    """(device_s_per_step, host_s_per_step, B, grid_res) on an n_dev-rank dp
    mesh (bench_scaling.py:71-118): 52 PRB x 2 layers, B = 16 n_dev."""
    from ..parallel import data_parallel, mesh as pmesh

    mesh = pmesh.make_mesh((n_dev, 1))
    case = synthetic.make_case(seed=77, n_prbs=52, n_layers=2, comb=2, scs_hz=30e3, snr_db=30.0)
    B = per_device_batch * n_dev
    fn = data_parallel.build_dp_batched(case.hop1, case.hop2, case.config, 2, mesh, device=device)
    rg, pil, beta = (fn.shard(x) for x in _inputs(case, B, device))
    dev_s = _chained(fn, rg, pil, beta, 4, 36)
    host_s = _host_step(fn, (rg, pil, beta), 30, device)
    return dev_s, host_s, B, case.received_rg.size * 2


def _sp_builder(case, mesh, batch, device):
    """The batched sp builder of a one-layer case on `mesh`, and this rank's
    blocks of the case tiled to `batch`."""
    from ..parallel import mesh as pmesh
    from ..parallel.subcarrier import build_sp_batched

    fn = build_sp_batched(case.hop1, case.hop2, case.config, 1, mesh, device=device)
    rg, pil, beta = _inputs(case, batch, device)
    rg, pil = fn.shard_inputs(rg, pil)
    return fn, rg, pil, pmesh.batch_slice(beta, mesh, "dp")


def measure_narrow(n_prbs: int, batch: int, *, device) -> float:
    """The sp rows' per-shard compute proxy: the same sharded builder on a
    one-rank mesh over an `n_prbs`-wide band (bench_scaling.py:121-151)."""
    from ..parallel import mesh as pmesh

    case = synthetic.make_case(seed=99, n_prbs=n_prbs, n_layers=1, comb=2, scs_hz=30e3,
                               snr_db=30.0)
    fn, rg, pil, beta = _sp_builder(case, pmesh.make_mesh((1, 1)), batch, device)
    return _chained(fn, rg, pil, beta, 4, 20)


def measure_sp_wideband(n_sp: int, *, device):
    """(device_s_per_step, host_s_per_step, B, grid_res): the 273-PRB batch of
    2 with each problem's subcarriers over n_sp ranks (bench_scaling.py:154-191)."""
    from ..parallel import mesh as pmesh

    case = synthetic.make_case(seed=99, n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0)
    B = 2  # fixed total batch: the scaling axis is the subcarrier split
    fn, rg, pil, beta = _sp_builder(case, pmesh.make_mesh((1, n_sp)), B, device)
    dt = _chained(fn, rg, pil, beta, 4, 20)
    host_s = _host_step(fn, (rg, pil, beta), 20, device)
    return dt, host_s, B, case.received_rg.size * 1


def measure_config4(n_dev: int, total_batch: int = 4096, *, device):
    """(device_s_per_step, total_batch, grid_res): BASELINE config[4], 4096
    frequency-hopped problems on a dp x sp mesh (bench_scaling.py:194-224)."""
    from ..parallel import mesh as pmesh

    n_sp = 2 if n_dev >= 2 else 1
    n_dp = max(1, n_dev // n_sp)
    case = synthetic.make_case(seed=88, n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0,
                               two_hops=True)
    fn, rg, pil, beta = _sp_builder(case, pmesh.make_mesh((n_dp, n_sp)), total_batch, device)
    dt = _chained(fn, rg, pil, beta, 2, 8)
    return dt, total_batch, case.received_rg.size * 1


MEASURES = {"dp": measure_dp, "narrow": measure_narrow, "sp": measure_sp_wideband,
            "config4": measure_config4}


def world_tasks(tasks, device) -> list:
    """Every rank of a spawned world runs `tasks` ([(kind, *args)]) in order:
    [("ok", result) | ("error", message)] per task (rank 0's are kept)."""
    import torch.distributed as dist

    from ..parallel import launch

    dev = launch.rank_device(device, dist.get_rank())
    out = []
    for kind, *a in tasks:
        try:
            out.append(("ok", MEASURES[kind](*a, device=dev)))
        except Exception as e:  # the report records the row's failure
            out.append(("error", f"{type(e).__name__}: {e}"))
    return out


def _one_core_baseline(device) -> float:
    """measure_dp(1) pinned to one core (a `taskset -c 0` child): the
    intra-op-parallelism-free T_1 of the core-normalised ideal; 0.0 when it
    cannot be measured (no taskset, the child failed)."""
    root = Path(__file__).resolve().parents[2]
    code = ("from srsran_ce_tpu_torch.bench import scaling\n"
            "from srsran_ce_tpu_torch.parallel import launch\n"
            "st, r = launch.spawn_world(scaling.world_tasks, 1, 'gloo', 'cpu',\n"
            "                           args=([('dp', 1)], 'cpu'))[0][0]\n"
            "print('ONECORE_T1', r[0] if st == 'ok' else 0.0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    try:
        res = subprocess.run(["taskset", "-c", "0", sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=1200, cwd=root)
    except (OSError, subprocess.TimeoutExpired) as e:
        log(f"one-core baseline not measured: {type(e).__name__}: {e}")
        return 0.0
    for line in res.stdout.splitlines():
        if line.startswith("ONECORE_T1 "):
            return float(line.split()[1])
    log(f"one-core baseline not measured: rc {res.returncode}: {res.stderr[-2000:]}")
    return 0.0


def _run_world(n: int, tasks, backend: str, device) -> list:
    """Rank 0's results of `tasks` on an n-rank world; a world that fails as
    a whole gives every task its error."""
    from ..parallel import launch

    log(f"world of {n} ({backend}, {device}): {[t[0] for t in tasks]}")
    try:
        return launch.spawn_world(world_tasks, n, backend, device, args=(tasks, device),
                                  timeout_s=900.0)[0]
    except Exception as e:
        return [("error", f"world of {n}: {type(e).__name__}: {e}")] * len(tasks)


def config4_sizes(sizes) -> list:
    """The world sizes of the config[4] rows: 1, 2 and the largest run."""
    return sorted({s for s in (1, 2, max(sizes)) if s <= max(sizes)})


def shard_prbs(n: int) -> int:
    """PRBs of one of n subcarrier shards of the 273-PRB band (its proxy's width)."""
    return max(1, -(-273 // n))


def world_plan(sizes) -> dict:
    """{world size: [task]}: every measurement of the sweep grouped by the
    world it runs in; the one-rank references (the same total dp batch on
    one rank, the per-shard proxies) run in the world of 1."""
    plan = {n: [("dp", n), ("sp", n)] + ([("config4", n)] if n in config4_sizes(sizes) else [])
            for n in sizes}
    plan[1] += [("dp", 1, PER_DEVICE_BATCH * n) for n in sizes if n > 1]
    plan[1] += [("narrow", shard_prbs(n), 2) for n in sizes]
    return plan


def run(device) -> StructuredReport:
    """The whole sweep on `device` ("cpu": gloo worlds of processes; "cuda":
    NCCL worlds, one card a rank)."""
    dev = devices.resolve(device, arg="--device ")
    platform = dev.type
    cores = os.cpu_count() or 1
    if platform == "cuda":
        n_cards = torch.cuda.device_count()
        sizes = [n for n in WORLD_SIZES if n <= n_cards]
        backend, name = "nccl", f"cuda x{n_cards} ({devices.name(dev)})"
    else:
        sizes, backend, name = list(WORLD_SIZES), "gloo", f"cpu x{max(WORLD_SIZES)} processes"
    not_run = [n for n in WORLD_SIZES if n not in sizes]
    report = StructuredReport(kind="scaling", device=name)
    c4_sizes = config4_sizes(sizes)
    plan = world_plan(sizes)
    results = {}
    for n in sizes:
        for task, res in zip(plan[n], _run_world(n, plan[n], backend, str(dev))):
            results[task] = res

    def got(task):
        st, r = results[task]
        if st != "ok":
            raise RuntimeError(r)
        return r

    # the intra-op confound, measured (CPU worlds only, as JAX)
    t1_onecore = _one_core_baseline(dev) if platform == "cpu" else 0.0
    onecore_measured = bool(t1_onecore)

    def ideal_step(t1, n):
        return t1 * max(1.0, n / cores) if platform == "cpu" else t1

    base_dev = None
    raw_effs, fw_effs, norm_effs = {}, {}, {}
    for n in sizes:
        try:
            dev_s, host_s, B, grid_res = got(("dp", n))
            thr = B * grid_res / dev_s
            if n == 1:
                base_dev = dev_s
                if not t1_onecore:
                    t1_onecore = dev_s  # pinning unavailable: fall back (confounded)
                equiv_1dev = dev_s
            else:
                # the same total batch on ONE rank: only the sharding differs
                equiv_1dev = got(("dp", 1, PER_DEVICE_BATCH * n))[0]
            eff_raw = base_dev / dev_s
            eff_fw = equiv_1dev / dev_s
            eff_norm = ideal_step(t1_onecore, n) / dev_s
            raw_effs[n], fw_effs[n], norm_effs[n] = eff_raw, eff_fw, eff_norm
            dispatch = max(host_s - dev_s, 0.0)
            report.add(
                scenario="dp_weak", n_devices=n, batch=B, s_per_step=dev_s,
                host_s_per_step=host_s, dispatch_s_per_step=dispatch, res_per_s=thr,
                efficiency=eff_raw, efficiency_core_normalized=eff_norm,
                equiv_1dev_s_per_step=equiv_1dev, framework_efficiency=eff_fw,
                ideal_s_per_step=ideal_step(t1_onecore, n),
            )
            log(f"dp={n}: device {dev_s*1e3:.3f} ms/step (+{dispatch*1e3:.3f} ms dispatch), "
                f"{thr:.3e} REs/s, eff raw {eff_raw:.2%} / core-norm {eff_norm:.2%} / "
                f"framework {eff_fw:.2%} (same work 1 rank: {equiv_1dev*1e3:.3f} ms)")
        except Exception as e:
            report.add(scenario="dp_weak", n_devices=n, error=str(e))
            log(f"dp={n} FAILED: {e}")
    report.add(
        scenario="dp_baselines", t1_s_per_step=base_dev, t1_onecore_s_per_step=t1_onecore,
        t1_onecore_measured=onecore_measured,
        intra_op_speedup=(t1_onecore / base_dev) if base_dev else None,
        note=("t1_onecore = the one-rank step pinned to one core (taskset, CPU worlds only). "
              "framework_efficiency = (same total batch on ONE rank) / T_N: same silicon, same "
              "work, only the sharding differs"),
    )

    sp_base = None
    for n in sizes:
        try:
            dt, host_s, B, grid_res = got(("sp", n))
            prbs = shard_prbs(n)
            t_shard = got(("narrow", prbs, 2))
            ideal = t_shard * max(1.0, n / cores) if platform == "cpu" else t_shard
            if n == 1:
                sp_base = dt
            seam = dt - ideal
            row = dict(
                scenario="sp_wideband_273prb", n_devices=n, batch=B, s_per_step=dt,
                host_s_per_step=host_s, dispatch_s_per_step=max(host_s - dt, 0.0),
                res_per_s=B * grid_res / dt, per_shard_prbs=prbs,
                per_shard_compute_s=t_shard, ideal_collective_free_s=ideal,
                seam_overhead_s=seam, seam_share=seam / dt, compute_fraction=ideal / dt,
            )
            if sp_base is not None:
                row["speedup_vs_1shard"] = sp_base / dt
            report.add(**row)
            log(f"sp273 n_sp={n}: {dt*1e3:.3f} ms/step"
                + (f" ({sp_base/dt:.2f}x vs 1 shard)" if sp_base else "")
                + f"; per-shard compute {t_shard*1e3:.3f} ms ({prbs} PRB), "
                f"seam {seam*1e3:+.3f} ms ({row['seam_share']:+.0%} of step)")
        except Exception as e:
            report.add(scenario="sp_wideband_273prb", n_devices=n, error=str(e))
            log(f"sp273 n_sp={n} FAILED: {e}")

    c4_base = None
    for n in c4_sizes:
        try:
            dt4, B4, res4 = got(("config4", n))
            thr4 = B4 * res4 / dt4
            if n == 1:
                c4_base = dt4
            row = dict(scenario="config4_hopped_4096", n_devices=n, batch=B4, s_per_step=dt4,
                       res_per_s=thr4)
            if c4_base is not None:
                row["speedup_vs_1dev"] = c4_base / dt4
            report.add(**row)
            log(f"config4 4096-problem (n={n}): {dt4*1e3:.1f} ms/step, {thr4:.3e} REs/s"
                + (f", {row['speedup_vs_1dev']:.2f}x vs 1 rank" if c4_base else ""))
        except Exception as e:
            report.add(scenario="config4_hopped_4096", n_devices=n, error=str(e))
            log(f"config4 (n={n}) FAILED: {e}")

    report.meta = {
        "per_device_batch": PER_DEVICE_BATCH,
        "config": "52PRB 2-layer filter+CFO (dp rows)",
        "mode": "weak-scaling (dp) + subcarrier split (sp273) + 4096-problem (config4)",
        "backend": backend,
        "world_sizes": sizes,
        "not_run": ({"world_sizes": not_run,
                     "reason": f"{torch.cuda.device_count()} CUDA device(s) here; NCCL takes "
                               "one card a rank, and no world runs on the CPU in their place"}
                    if not_run else None),
        "physical_cores": cores,
        "caveat": (
            f"CPU ranks time-slice {cores} cores; raw efficiency at N > {cores} ranks measures "
            "host saturation, not the framework. efficiency_core_normalized divides the "
            "one-core-pinned T_1 (times N/cores once oversubscribed) by T_N, unclamped"
            if platform == "cpu" else "one card a rank over NCCL"
        ),
        "efficiency": {"raw": raw_effs, "framework": fw_effs, "core_normalized": norm_effs},
    }
    return report


def summary(report: StructuredReport) -> dict:
    """The one-line JSON summary (bench_scaling.py:448-458)."""
    eff = report.meta["efficiency"]
    n_head = max(report.meta["world_sizes"])
    fw = eff["framework"].get(n_head)
    raw = eff["raw"].get(n_head)
    return {
        "metric": (f"dp weak-scaling efficiency at {n_head} ranks ({report.device}; framework = "
                   "same-work-1-rank / T_N; raw and core-normalized alongside)"),
        "value": fw,
        "value_core_normalized": eff["core_normalized"].get(n_head),
        "value_raw": raw,
        "unit": "fraction",
        "vs_baseline": fw / 0.8 if fw is not None else None,  # target is >= 80%
        "vs_baseline_raw": raw / 0.8 if raw is not None else None,
        "not_run": report.meta["not_run"],
    }


def failures(report: StructuredReport) -> list:
    return [(e["scenario"], e["n_devices"]) for e in report.entries if "error" in e]


def main(device="cuda", out="chiprun_out/torch_bench_scaling.json") -> int:
    """Run the sweep, write the report to `out`, print the summary last; 1
    when any row failed."""
    report = run(device)
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    report.write(path)
    bad = failures(report)
    log(f"report written to {path}; rows failed: {bad or 'none'}")
    print(json.dumps(summary(report)))
    return 1 if bad else 0
