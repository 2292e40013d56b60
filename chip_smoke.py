#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure ends the run with a non-zero exit code:
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: nvcc builds every kernel from srsran_ce_tpu_torch/csrc/;
  3. K1 (fused front) against its plain PyTorch version at c2 shapes, B=128;
  4. K2 (serve fill) against its plain version, equal and unequal CDM groups;
  5. the main path: `build_ri(..., batched=True, out_layout="serve",
     kernels="pallas_front")` at c2 (106 PRB x 4 layers, batch 128,
     matmul_precision="high") against the float64 oracle, with each kernel's
     launch count of that run; then the factored layout against the serve grid;
  6. the two-hop c4 geometry (24 PRB, 1 layer) at batch 256, same checks;
  7. times with CUDA events: each kernel against its plain version, and the
     whole build_ri call, at c2 batch 128.
Then one JSON line of per-kernel results, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEEDS = (11, 12, 13, 14)  # four distinct synthetic cases, tiled to the batch
C2 = dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0)
C4 = dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0, two_hops=True)
SERVE_NMSE_BOUND = 4e-11  # the JAX package's serve bound vs the oracle (ARCHITECTURE.md)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def errs(a, b):
    """(max |a - b|, max |a - b| / max |b|) of a kernel's output against its plain version."""
    d = float((a.double() - b.double()).abs().max())
    return d, d / max(float(b.double().abs().max()), 1e-30)


def check_rtol(name, got, want, rtol, atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    if bad.any():
        i = int(np.argmax(bad))
        fail(f"{name}: {got.flat[i]!r} vs {want.flat[i]!r} (rtol {rtol}, atol {atol})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from srsran_ce_tpu_torch.models import estimator
    from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
    from srsran_ce_tpu_torch.ops.kernels import _build
    from srsran_ce_tpu_torch.ops.kernels import fill_rotate_serve as k2
    from srsran_ce_tpu_torch.ops.kernels import front as k1
    from srsran_ce_tpu_torch.utils import oracle, synthetic

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in IEEE f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"phase 1 device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s for {list(_build.SOURCES)}")
    for src, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # cases: four seeds at c2, tiled to the batch
    def tiled(kw, batch):
        cases = [synthetic.make_case(seed=s, **kw) for s in SEEDS]
        c0 = cases[0]
        cfg = dataclasses.replace(c0.config, matmul_precision="high")
        rg = np.stack([estimator.split_ri(c.received_rg) for c in cases]).astype(np.float32)
        pil = np.stack([estimator.split_ri(c.pilots) for c in cases]).astype(np.float32)
        idx = np.arange(batch) % len(cases)
        rg_t = torch.as_tensor(rg[idx], device=dev)
        pil_t = torch.as_tensor(pil[idx], device=dev)
        beta = torch.full((batch,), c0.beta, dtype=torch.float32, device=dev)
        return cases, cfg, rg_t, pil_t, beta

    def front_inputs(cases, cfg, rg_t, pil_t, batch, seed):
        """Per-hop fused-front inputs of the tiled batch, each problem perturbed
        by a seeded 1e-3 noise so that all `batch` problems differ."""
        nL = cases[0].pilots.shape[2]
        plan = make_plan(cases[0].hop1, cases[0].hop2, cfg, nL)
        pt = plan_tensors(plan, dev, torch.float32)
        rng = np.random.default_rng(seed)
        hp, ht = plan.hop1, pt["hops"][0]
        rx = estimator._gather_rx(hp, ht, rg_t)
        rx = rx + torch.as_tensor(1e-3 * rng.standard_normal(rx.shape), dtype=torch.float32, device=dev)
        pil = pil_t[:, :, :, : hp.n_dsym].permute(0, 1, 4, 3, 2).contiguous()
        mats = ht["front"]
        kw = dict(
            n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
            scs_hz=cfg.scs_hz, cfo_possible=hp.cfo_possible, cfo_compensate=cfg.cfo_compensate,
        )
        beta = torch.ones(batch, dtype=torch.float32, device=dev)
        return plan, pt, (rx.contiguous(), pil, beta, mats), kw

    # 3. K1 vs plain
    c2 = tiled(C2, 128)
    plan_c2, pt_c2, f_args, f_kw = front_inputs(*c2[:4], 128, seed=101)
    results = {}
    for label, args, kw in (("c2", f_args, f_kw), ("c4", *front_inputs(*tiled(C4, 256)[:4], 256, seed=102)[2:])):
        h_k, s_k = k1.fused_front(*args, **kw)
        h_p, s_p = k1.fused_front_plain(*args, **kw)
        torch.cuda.synchronize()
        abs_err, err = errs(h_k, h_p)
        if not err <= 1e-5:
            fail(f"K1 {label} h_s relative error {err:.3e} > 1e-5")
        s_k, s_p = s_k.cpu().numpy(), s_p.cpu().numpy()
        for col, nm in ((0, "cfo"), (2, "noise"), (3, "rsrp"), (4, "epre")):
            check_rtol(f"K1 {label} {nm}", s_k[:, col], s_p[:, col], 1e-4)
        # TA: the same bin (PyTorch divides by a scalar through its reciprocal,
        # the kernel divides, so the seconds may differ by an ulp)
        to_bin = kw["fft_size"] * kw["scs_hz"]
        bins_k, bins_p = np.rint(s_k[:, 1] * to_bin), np.rint(s_p[:, 1] * to_bin)
        if not np.array_equal(bins_k, bins_p):
            bad = np.nonzero(bins_k != bins_p)[0]
            fail(f"K1 {label} TA bin differs for problems {bad[:8].tolist()}: "
                 f"{bins_k[bad[:8]]} vs {bins_p[bad[:8]]} (a PDP near-tie?)")
        check_rtol(f"K1 {label} ta", s_k[:, 1], s_p[:, 1], 1e-6)
        results.setdefault("fused_front", abs_err)
        print(f"phase 3 K1 vs plain ({label}, B={args[0].shape[0]}): h_s max abs err {abs_err:.3e}, "
              f"rel err {err:.3e} (<= 1e-5), "
              f"scalars within rtol 1e-4, TA bins equal")

    # 4. K2 vs plain
    rng = np.random.default_rng(7)
    hp = plan_c2.hop1
    w_c2 = pt_c2["hops"][0]["interp"]
    k2_cases = (
        ("c2 nL=4, groups (0,2),(2,4)", 4, w_c2, hp.layer_slices),
        ("nL=3, groups (0,2),(2,3)", 3,
         torch.as_tensor(0.1 * rng.standard_normal(tuple(w_c2.shape)), dtype=torch.float32, device=dev),
         ((0, 2), (2, 3))),
    )
    for label, nL, w, slices in k2_cases:
        h = torch.as_tensor(rng.standard_normal((128, 2, nL, hp.n_re)), dtype=torch.float32, device=dev)
        ph = rng.uniform(-np.pi, np.pi, (128, 14))
        rot = torch.as_tensor(np.stack([np.cos(ph), np.sin(ph)], 1), dtype=torch.float32, device=dev)
        o_k = k2.fused_fill_rotate_serve(h, w, rot, layer_slices=slices)
        o_p = k2.fused_fill_rotate_serve_plain(h, w, rot, layer_slices=slices)
        torch.cuda.synchronize()
        abs_err, err = errs(o_k, o_p)
        if not err <= 1e-5:
            fail(f"K2 {label} relative error {err:.3e} > 1e-5")
        results.setdefault("fused_fill_rotate_serve", abs_err)
        print(f"phase 4 K2 vs plain ({label}, out {tuple(o_k.shape)}): max abs err {abs_err:.3e}, "
              f"rel err {err:.3e} (<= 1e-5)")
    k2_args = (torch.as_tensor(rng.standard_normal((128, 2, 4, hp.n_re)), dtype=torch.float32, device=dev),
               w_c2, rot[:, :, :14].contiguous())

    # 5 / 6. main path against the float64 oracle
    def drive(label, kw, batch):
        cases, cfg, rg_t, pil_t, beta = tiled(kw, batch)
        nL = cases[0].pilots.shape[2]
        fn = estimator.build_ri(cases[0].hop1, cases[0].hop2, cfg, nL, batched=True,
                                out_layout="serve", kernels="pallas_front")
        torch.cuda.synchronize()
        k1.launches = 0
        k2.launches = 0
        res = fn(rg_t, pil_t, beta)
        torch.cuda.synchronize()
        counts = {"fused_front": k1.launches, "fused_fill_rotate_serve": k2.launches}
        if min(counts.values()) < 1:
            fail(f"{label}: a kernel of the main path did not launch: {counts}")
        ch = res.channel_est_rg.cpu().numpy()
        if ch.shape != (batch, 2, nL, 14, cases[0].received_rg.shape[0]) or not np.isfinite(ch).all():
            fail(f"{label}: channel grid {ch.shape} not finite or of the wrong shape")
        worst = 0.0
        for i, c in enumerate(cases):
            o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
            want = o.channel_est_rg  # (n_sc, n_sym, nL)
            for b in range(i, batch, len(cases)):
                got = (ch[b, 0] + 1j * ch[b, 1]).astype(np.complex128).transpose(2, 1, 0)
                nmse = np.sum(np.abs(got - want) ** 2) / np.sum(np.abs(want) ** 2)
                worst = max(worst, nmse)
            sl = slice(i, batch, len(cases))
            check_rtol(f"{label} noise", res.noise_est[sl].cpu(), o.noise_est, 1e-3)
            check_rtol(f"{label} cfo_hz", res.cfo_hz[sl].cpu(), o.cfo_hz, 1e-3, 1e-3)
            check_rtol(f"{label} rsrp", res.rsrp[sl].cpu(), o.rsrp, 1e-5)
            check_rtol(f"{label} epre", res.epre[sl].cpu(), o.epre, 1e-5)
            check_rtol(f"{label} ta", res.time_alignment[sl].cpu(), o.time_alignment, 1e-6, 1e-15)
        if not worst < SERVE_NMSE_BOUND:
            fail(f"{label}: channel NMSE vs oracle {worst:.3e} >= {SERVE_NMSE_BOUND}")
        print(f"phase {label}: serve {tuple(ch.shape)}, worst NMSE vs float64 oracle {worst:.3e} "
              f"(< {SERVE_NMSE_BOUND}), scalars within bounds, launches {counts}")

        fac = estimator.build_ri(cases[0].hop1, cases[0].hop2, cfg, nL, batched=True,
                                 out_layout="factored", kernels="pallas_front")(rg_t, pil_t, beta)
        torch.cuda.synchronize()
        prof = estimator.merge_ri(np.moveaxis(fac.profiles.cpu().numpy(), 1, 0))
        rot = estimator.merge_ri(np.moveaxis(fac.sym_rot.cpu().numpy(), 1, 0))
        grid = estimator.reconstruct_factored(prof[: len(cases)], rot[: len(cases)],
                                              cases[0].hop1, cases[0].hop2)
        serve = (ch[: len(cases), 0] + 1j * ch[: len(cases), 1]).transpose(0, 3, 2, 1)
        err = np.abs(grid - serve).max() / np.abs(serve).max()
        if not err <= 1e-5:
            fail(f"{label}: factored layout vs serve grid rel err {err:.3e} > 1e-5")
        print(f"phase {label} factored: reconstruct_factored vs serve grid rel err {err:.3e}")
        return counts, fn, (rg_t, pil_t, beta)

    counts, fn_c2, c2_args = drive("5 c2", C2, 128)
    drive("6 c4 two hops", C4, 256)

    # 7. times (CUDA events, after warm-up), plain / kernel / kernel / plain
    # In the serve call each kernel finds L2 cold (K2 writes 72.9 MB, more than
    # the 50 MB L2), so each timed launch follows a 64 MB write; the warm
    # back-to-back figure is printed beside it.
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)

    def time_ms(fn, iters=20, cold=True):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if not cold:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(iters)]
        for start, end in evs:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    def ab(kernel, plain):
        p1, k1_, k2_, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
        return (k1_ + k2_) / 2, (p1 + p2) / 2, (p1, k1_, k2_, p2), time_ms(kernel, cold=False)

    times = {
        "fused_front": ab(lambda: k1.fused_front(*f_args, **f_kw),
                          lambda: k1.fused_front_plain(*f_args, **f_kw)),
        "fused_fill_rotate_serve": ab(
            lambda: k2.fused_fill_rotate_serve(*k2_args, layer_slices=hp.layer_slices),
            lambda: k2.fused_fill_rotate_serve_plain(*k2_args, layer_slices=hp.layer_slices)),
    }
    for kname, (ms, plain_ms, turns, warm) in times.items():
        print(f"phase 7 {kname} c2 B=128, cold L2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(turns plain/kernel/kernel/plain {[round(t, 4) for t in turns]}); "
              f"kernel back-to-back with warm L2 {warm:.4f} ms {card}")
    e2e = time_ms(lambda: fn_c2(*c2_args))
    t0 = time.perf_counter()
    for _ in range(50):
        fn_c2(*c2_args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 50 * 1e3
    print(f"phase 7 build_ri serve c2 B=128 (both kernels + plain glue): {e2e:.4f} ms/batch "
          f"on CUDA events, cold L2; {wall:.4f} ms/batch host wall clock back-to-back {card}")

    sources = {"fused_front": ("srsran_ce_tpu_torch/csrc/front.cu",
                               "srsran_ce_tpu/ops/pallas/kernels.py:639"),
               "fused_fill_rotate_serve": ("srsran_ce_tpu_torch/csrc/fill_rotate_serve.cu",
                                           "srsran_ce_tpu/ops/pallas/kernels.py:232")}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
         "launches": counts[k], "max_abs_err": results[k], "ms": times[k][0],
         "plain_ms": times[k][1]}
        for k in sources
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
