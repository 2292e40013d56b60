"""The sharded paths' cases, run inside a world (`parallel.launch.spawn_world`).

    results = spawn_world(sharded.run_cases, n, args=(specs, "cpu"))

Every rank builds the same inputs from the spec's seeds (numpy), cuts its own
blocks, calls the sharded builder and joins in assembling the global result;
rank 0 returns, per spec, the global outputs as numpy arrays (the other ranks
return None). The tests hold them to the float64 oracle, the unsharded port
and the JAX package's sharded builders; with `check=True` rank 0 instead
holds them itself to the unsharded port (on the same device and dtype) and
to the float64 oracle and returns only the errors and the times (chip_smoke,
at widths whose outputs are too large to ship).

A spec is a dict: name, kind, mesh (n_dp, n_sp), dtype ("float64" default),
and per kind:

  sp            kw (synthetic.make_case), seed, layout, params (a seed: the
                perturbed denoiser of `perturbed_params`);
  sp_batched    kw, seeds (one problem each) or seed with batch (the case
                tiled), layout;
  sp_tracked    kw, seed, noise_seeds (one sounding each), layout;
  sp_receiver   kw (synthetic.make_mimo_case), seed, n_rx, batch, modulation;
  dp_batched    kw, seeds or seed with batch, layout;
  dp_receiver   kw (make_mimo_case), seed, n_rx, batch, modulation;
  dp_decoder    code ("array", mb, nb, z) or ("nr", bg, z), batch, n_iters,
                snr (the LLRs' amplitude), and decoder keywords in `dec`;
  train         two_d, batch, n_re, steps: the data-parallel step;
  dryrun        `entry.dryrun_body` (the multi-rank checklist);
  barrier       the barrier and the heartbeat;
  halo          the comm layer's collectives, both halo routes;
  p2p_probe     a halo exchange forced onto send/recv (gloo-CUDA fails);
  fuzz          draws: `deepfuzz.check_sp_case` of each draw (n_sp = |sp|).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import graphs
from ..models import estimator as est
from ..parallel import comm as _comm
from ..parallel import mesh as pmesh
from ..utils import synthetic

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def perturbed_params(seed: int, two_d: bool = False, scale: float = 0.05) -> dict:
    """The denoiser's initial params (`denoiser.init_params*`, float32) plus
    scale x N(0, 1) from numpy's generator at `seed`: a zero last layer would
    make the denoiser the identity and hide edge faults."""
    from ..models import denoiser

    p = (denoiser.init_params_2d if two_d else denoiser.init_params)(seed)
    rng = np.random.default_rng(seed + 1)
    return {k: v + torch.as_tensor(scale * rng.standard_normal(tuple(v.shape)), dtype=v.dtype)
            for k, v in p.items()}


def case_inputs(spec: dict):
    """(cases, rg_ri, pil_ri, beta) of a spec as float64 numpy: one problem
    per seed in `seeds`, or the case of `seed` tiled to `batch` (problem k
    scaled by 1 + 0.01 k, so the problems differ), or one unbatched problem."""
    kw = dict(spec.get("kw", {}))
    kw.setdefault("snr_db", 30.0)
    mimo = spec["kind"] in ("sp_receiver", "dp_receiver")
    make = (lambda s: synthetic.make_mimo_case(seed=s, n_rx=spec["n_rx"], scramble=False, **kw)
            ) if mimo else (lambda s: synthetic.make_case(seed=s, **kw))
    ri = lambda c: (est.split_ri(c.received_rg.astype(np.complex128)),
                    est.split_ri(c.pilots.astype(np.complex128)))
    if "seeds" in spec:
        cases = [make(s) for s in spec["seeds"]]
        rg = np.stack([ri(c)[0] for c in cases])
        pil = np.stack([ri(c)[1] for c in cases])
        return cases, rg, pil, np.array([c.beta for c in cases], np.float64)
    c = make(spec["seed"])
    rg, pil = ri(c)
    if "batch" not in spec:
        return [c], rg, pil, np.float64(c.beta)
    B = spec["batch"]
    scale = (1.0 + 0.01 * np.arange(B)).reshape((B,) + (1,) * rg.ndim)
    return ([c], rg[None] * scale, np.broadcast_to(pil, (B,) + pil.shape).copy(),
            np.full(B, c.beta))


def to_numpy(res) -> dict:
    """{field: numpy} of a result (a tuple field stacked on axis 1, the
    per-bit LLR planes' word order)."""
    out = {}
    for f in dataclasses.fields(res):
        v = getattr(res, f.name)
        if isinstance(v, tuple):
            v = torch.stack(list(v), dim=1)
        out[f.name] = v.detach().cpu().numpy()
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev, reps: int = 5) -> float:
    """Wall ms a call of fn() (synchronised), the best of `reps` after a warm-up."""
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)) if a.size else 0.0


def _nmse(a, b) -> float:
    return float(np.sum(np.abs(a - b) ** 2) / max(np.sum(np.abs(b) ** 2), 1e-300))


# ---------------------------------------------------------------------------
# One spec
# ---------------------------------------------------------------------------


def _estimator_spec(spec, mesh, dev, dt, check):
    from ..parallel import data_parallel as dp
    from ..parallel import subcarrier as sc

    kind = spec["kind"]
    cases, rg, pil, beta = case_inputs(spec)
    c0 = cases[0]
    nL = c0.pilots.shape[2]
    layout = spec.get("layout", "ref")
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    params = None
    if spec.get("params") is not None:
        params = {k: v.to(dev) for k, v in perturbed_params(
            spec["params"], c0.config.smoothing == "learned2d").items()}
    extra = () if params is None else (params,)
    if kind in ("dp_batched", "dp_receiver"):
        if kind == "dp_batched":
            fn = dp.build_dp_batched(c0.hop1, c0.hop2, c0.config, nL, mesh, out_layout=layout,
                                     device=dev)
        else:
            fn = dp.build_dp_receiver(c0.hop1, c0.hop2, c0.config, nL, mesh,
                                      modulation=spec.get("modulation"), device=dev)
        args = (fn.shard(t(rg)), fn.shard(t(pil)), fn.shard(t(beta))) + extra
        gather = fn.gather
    else:
        build = {"sp": sc.build_sp, "sp_batched": sc.build_sp_batched,
                 "sp_receiver": sc.build_sp_receiver}[kind]
        kw = dict(modulation=spec.get("modulation")) if kind == "sp_receiver" else dict(out_layout=layout)
        fn = build(c0.hop1, c0.hop2, c0.config, nL, mesh, device=dev, **kw)
        rg_l, pil_l = fn.shard_inputs(t(rg), t(pil))
        beta_l = t(beta)
        if fn.batched:
            beta_l = pmesh.batch_slice(beta_l, mesh, fn.dp_axis)
        args = (rg_l, pil_l, beta_l) + extra
        gather = fn.gather_outputs
    call = lambda: fn(*args)
    out = gather(call())
    if not check:
        return to_numpy(out) if dist_rank() == 0 else None
    return _check_estimator(spec, fn, call, gather, out, cases, rg, pil, beta, t, extra, dev)


def _check_estimator(spec, fn, call, gather, out, cases, rg, pil, beta, t, extra, dev):
    """Rank 0's errors against the unsharded port on the same device and dtype
    and against the float64 oracle; every rank's share of the timing."""
    from ..models import receiver as rcv
    from ..utils import oracle

    kind = spec["kind"]
    c0 = cases[0]
    nL = c0.pilots.shape[2]
    layout = spec.get("layout", "ref")
    receiver = kind.endswith("receiver")
    res = {"ms": _ms(call, dev)}
    res.update(_graph_check(call, dev))
    if dist_rank() != 0:
        return None
    batched = np.ndim(beta) == 1
    if receiver:
        fn1 = rcv.build_receiver_ri(c0.hop1, c0.hop2, c0.config, nL, spec["n_rx"], batched=True,
                                    modulation=spec.get("modulation"), device=dev)
    else:
        fn1 = est.build_ri(c0.hop1, c0.hop2, c0.config, nL, batched=batched, kernels="xla",
                           out_layout=layout)
    args1 = (t(rg), t(pil), t(beta)) + extra
    want = fn1(*args1)
    res["unsharded_ms"] = _ms(lambda: fn1(*args1), dev)
    got, ref = to_numpy(out), to_numpy(want)
    res["bit_identical"] = all(np.array_equal(got[k], ref[k], equal_nan=True) for k in ref)
    res["rel"] = {k: _rel(got[k], ref[k]) for k in ref}
    if "llr" in ref:  # int8: steps apart, and the share of entries that differ
        d = np.abs(got["llr"].astype(np.int64) - ref["llr"].astype(np.int64))
        res["llr_max_step"], res["llr_diff_share"] = int(d.max()), float((d != 0).mean())
    if not receiver and layout == "ref" and c0.config.smoothing not in ("learned", "learned2d"):
        n_o = min(spec.get("n_oracle", 2), len(beta) if batched else 1)
        worst = 0.0
        for b in range(n_o):
            c = cases[b if len(cases) > 1 else 0]
            scale = 1.0 if len(cases) > 1 or not batched else 1.0 + 0.01 * b
            o = oracle.estimate(c.received_rg * scale, c.pilots, c.beta, c.hop1, c.hop2, c.config)
            ch = est.merge_ri(got["channel_est_rg"][b] if batched else got["channel_est_rg"])
            worst = max(worst, _nmse(ch, o.channel_est_rg))
        res["nmse_vs_oracle"] = worst
    return res


def _leaves(res):
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _leaves(r)]
    if dataclasses.is_dataclass(res):
        return _leaves([getattr(res, f.name) for f in dataclasses.fields(res)])
    return [res]


def _graph_check(call, dev) -> dict:
    """On the card over NCCL (a graphed world): whether a call (after `_ms`'s
    warm-up) replayed a CUDA graph, and whether its result equals the eager
    call's bit for bit."""
    if dev.type != "cuda" or dist.get_backend() != "nccl":
        return {}
    r0 = graphs.replays
    got = call()
    replayed = graphs.replays > r0
    with graphs.eager():
        want = call()
    return {"graph_replayed": replayed,
            "graphed_equal": all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))}


def _tracked_spec(spec, mesh, dev, dt, check=False):
    from ..models import tracking
    from ..parallel import subcarrier as sc

    kw = dict(spec["kw"])
    kw.setdefault("snr_db", 0.0)
    cases = [synthetic.make_case(seed=spec["seed"], noise_seed=s, **kw) for s in spec["noise_seeds"]]
    c0 = cases[0]
    nL = c0.pilots.shape[2]
    fn = sc.build_sp_tracked(c0.hop1, c0.hop2, c0.config, nL, mesh,
                             out_layout=spec.get("layout", "ref"), device=dev)
    h, w = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL, dtype=dt, device=dev)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    _, _, h = fn.shard_inputs(t(est.split_ri(c0.received_rg)), t(est.split_ri(c0.pilots)), h)
    slots, calls = [], []
    for c in cases:
        rg_l, pil_l = fn.shard_inputs(t(est.split_ri(c.received_rg)), t(est.split_ri(c.pilots)))
        calls.append((rg_l, pil_l, t(c.beta)))
        res, h, w = fn(*calls[-1], h, w)
        g_res, g_h, g_w = fn.gather_outputs((res, h, w))
        if dist_rank() == 0:
            d = to_numpy(g_res)
            d.update({f"h{i}": x.cpu().numpy() for i, x in enumerate(g_h)}, w=g_w.cpu().numpy())
            slots.append(d)
    if not check:
        return slots if dist_rank() == 0 else None
    out = {"ms": _ms(lambda: fn(*calls[-1], h, w), dev)}
    out.update(_graph_check(lambda: fn(*calls[-1], h, w), dev))
    if dist_rank() != 0:
        return None
    # the unsharded tracker over the same soundings, the state threaded
    f1 = tracking.build_tracked_ri(c0.hop1, c0.hop2, c0.config, nL, device=dev,
                                   out_layout=spec.get("layout", "ref"))
    h1, w1 = tracking.init_state(c0.hop1, c0.hop2, c0.config, nL, dtype=dt, device=dev)
    for c in cases:
        a1 = (t(est.split_ri(c.received_rg)), t(est.split_ri(c.pilots)), t(c.beta))
        r1, h1, w1 = f1(*a1, h1, w1)
    out["unsharded_ms"] = _ms(lambda: f1(*a1, h1, w1), dev)
    ref = to_numpy(r1)
    out["rel"] = {k: _rel(slots[-1][k], ref[k]) for k in ref}
    out["rel"]["w"] = _rel(slots[-1]["w"], w1.cpu().numpy())
    out["rel"]["state"] = max(_rel(slots[-1][f"h{i}"], x.cpu().numpy()) for i, x in enumerate(h1))
    return out


def _decoder_spec(spec, mesh, dev, check):
    from ..ops import ldpc, nr_ldpc
    from ..parallel import data_parallel as dp

    kind, *a = spec["code"]
    code = ldpc.array_code(*a) if kind == "array" else nr_ldpc.nr_base_graph(*a)
    plan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(spec.get("seed", 11))
    u = rng.integers(0, 2, (spec["batch"], plan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    llr = (spec.get("snr", 4.0) * (1 - 2.0 * cw) + rng.normal(0, 0.6, cw.shape)).astype(np.float32)
    fn = dp.build_dp_decoder(code, mesh, n_iters=spec.get("n_iters", 12), device=dev,
                             **spec.get("dec", {}))
    x = fn.shard(torch.as_tensor(llr, device=dev))
    out = fn.gather(fn(x))
    if dist_rank() != 0:
        if check:
            _ms(lambda: fn(x), dev)
        return None
    got = to_numpy(out)
    got["u"] = u
    if not check:
        return got
    res = {"ms": _ms(lambda: fn(x), dev), "tier": fn.local.tier,
           "payload_exact": bool(np.array_equal(got["info"], u)), "ok": bool(got["ok"].all())}
    dec1 = ldpc.build_decoder(code, n_iters=spec.get("n_iters", 12), kernels="auto", device=dev,
                              **spec.get("dec", {}))
    x1 = torch.as_tensor(llr, device=dev)
    ref = to_numpy(dec1(x1))
    res["bit_identical"] = all(np.array_equal(got[k], ref[k]) for k in ref)
    res["unsharded_ms"] = _ms(lambda: dec1(x1), dev)
    return res


def _train_spec(spec, mesh, dev, dt, check=False):
    from ..models import denoiser, training

    two_d = spec.get("two_d", False)
    rng = np.random.default_rng(spec.get("seed", 0))
    make = denoiser.make_training_batch_2d if two_d else denoiser.make_training_batch
    state, tx = (training.init_state_2d if two_d else training.init_state)(
        seed=spec.get("seed", 0), device=dev)
    params = {k: v.to(dt) for k, v in state.params.items()}
    opt = training.fresh_adam_state(params)
    step = (training.build_train_step_2d if two_d else training.build_train_step)(tx, mesh=mesh)
    losses, batches = [], []
    sl = lambda a: pmesh.batch_slice(torch.as_tensor(a, dtype=dt, device=dev), mesh, "dp")
    for _ in range(spec.get("steps", 2)):
        batches.append(make(rng, spec["batch"], spec.get("n_re", 32)))
        params, opt, loss = step(params, opt, sl(batches[-1][0]), sl(batches[-1][1]))
        losses.append(float(loss))
    if dist_rank() != 0:
        return None
    got = dict(losses=np.array(losses), **{k: v.cpu().numpy() for k, v in params.items()})
    if not check:
        return got
    # the unsharded step on the whole batch, from the same state
    step1 = (training.build_train_step_2d if two_d else training.build_train_step)(tx)
    p1 = {k: v.to(dt) for k, v in state.params.items()}
    o1 = training.fresh_adam_state(p1)
    l1 = []
    for noisy, truth in batches:
        p1, o1, loss1 = step1(p1, o1, noisy, truth)
        l1.append(float(loss1))
    return {"loss_rel": _rel(losses, l1),
            "params_rel": max(_rel(got[k], v.cpu().numpy()) for k, v in p1.items()),
            "loss": losses[-1]}


def _barrier_spec():
    dt = pmesh.all_device_barrier()
    hb = pmesh.Heartbeat(interval_s=0.05, timeout_s=60.0).start()
    time.sleep(0.3)
    hb.stop()
    seen = []
    hb2 = pmesh.Heartbeat(interval_s=0.05, on_failure=seen.append)
    hb2._fail("injected")
    return dict(barrier_s=dt, healthy=hb.healthy, error=hb.error, rounds=hb.rounds,
                latency=hb.last_latency_s, failure=(hb2.healthy, seen))


def _halo_spec(mesh, dev, dt):
    c = pmesh.comm(mesh, "sp")
    rng = np.random.default_rng(100 + dist_rank())
    x = torch.as_tensor(rng.standard_normal((3, 2, 9)) + 1j * rng.standard_normal((3, 2, 9)),
                        device=dev).to(torch.complex128 if dt == torch.float64 else torch.complex64)
    # the route the device takes against the all_gather route (on gloo-CUDA
    # both are all_gather: gloo's send/recv take no CUDA tensor)
    auto = c.halo_exchange(x, 4)
    forced = c.halo_exchange(x, 4, route="all_gather")
    same = all(torch.equal(a, b) for a, b in zip(auto, forced))
    out = dict(x=c.all_gather(x, -1), psum=c.psum(x), auto_route=c.halo_route(dev))
    glob = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in out.items()}
    all_l = c.all_gather(auto[0][None], 0).cpu().numpy()
    all_r = c.all_gather(auto[1][None], 0).cpu().numpy()
    all_x = c.all_gather(x[None], 0).cpu().numpy()
    glob.update(same=same, lefts=all_l, rights=all_r, xs=all_x)
    return glob if dist_rank() == 0 else None


def _p2p_probe(mesh, dev) -> None:
    """A halo exchange forced onto the p2p route (send/recv) with tensors on
    `dev`: gloo takes CPU tensors; with CUDA tensors it fails, raising or
    aborting the rank from its I/O thread, so run it in a world of its own."""
    pmesh.comm(mesh, "sp").halo_exchange(torch.ones((2, 8), device=dev), 2, route="p2p")


def dist_rank() -> int:
    return dist.get_rank()


def run_spec(spec: dict, device="cpu", check: bool = False, meshes=None):
    """One spec on this rank (every rank calls it, in the same order)."""
    from . import deepfuzz

    dev = torch.device(device) if torch.device(device).type == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    dt = DTYPES[spec.get("dtype", "float64")]
    meshes = {} if meshes is None else meshes
    shape = tuple(spec.get("mesh", (1, dist.get_world_size())))
    mesh = meshes.get(shape)
    if mesh is None:
        mesh = meshes[shape] = pmesh.make_mesh(shape)
    kind = spec["kind"]
    gloo_card = dev.type == "cuda" and dist.get_backend() != "nccl"
    with graphs.eager() if gloo_card else contextlib.nullcontext():
        if kind in ("sp", "sp_batched", "sp_receiver", "dp_batched", "dp_receiver"):
            return _estimator_spec(spec, mesh, dev, dt, check)
        if kind == "sp_tracked":
            return _tracked_spec(spec, mesh, dev, dt, check)
        if kind == "dp_decoder":
            return _decoder_spec(spec, mesh, dev, check)
        if kind == "train":
            return _train_spec(spec, mesh, dev, dt, check)
        if kind == "dryrun":
            from .. import entry

            return entry.dryrun_body(dev) or None
        if kind == "barrier":
            return _barrier_spec()
        if kind == "halo":
            return _halo_spec(mesh, dev, dt)
        if kind == "p2p_probe":
            return _p2p_probe(mesh, dev)
        if kind == "fuzz":
            rows = [deepfuzz.check_sp_case(d, spec.get("seed_base", 0xCE_59), dev, mesh) for d in spec["draws"]]
            return rows if dist_rank() == 0 else None
    raise ValueError(f"unknown spec kind {kind!r}")


def run_cases(specs, device="cpu", check: bool = False) -> dict:
    """Every spec, in order, on this rank of a world; rank 0 returns {name:
    result} (and the halo routes this rank took), the others None."""
    meshes = {}
    out = {}
    t0 = time.time()
    times = {}
    for spec in specs:
        t1 = time.time()
        out[spec["name"]] = run_spec(spec, device, check, meshes)
        times[spec["name"]] = time.time() - t1
    if dist_rank() != 0:
        return None
    out["_halo_routes"] = dict(_comm.halo_routes)
    # a rank imports no JAX, nor the JAX package (the GPU machine has neither)
    out["_foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "srsran_ce_tpu"))
    out["_seconds"] = time.time() - t0
    out["_spec_seconds"] = times
    return out
