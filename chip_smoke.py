#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more, any failure ends the run with a non-zero exit code:
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: nvcc builds every kernel from srsran_ce_tpu_torch/csrc/, all at once;
  3. K1 (fused front) against its plain PyTorch version at c2 shapes, B=128;
  4. K2 (serve fill) against its plain version, equal and unequal CDM groups;
  5. `build_ri(..., batched=True, out_layout="serve", kernels="pallas_front")`
     at c2 (106 PRB x 4 layers, batch 128, matmul_precision="high") against
     the float64 oracle, with each kernel's launch count of that run; then the
     factored layout against the serve grid;
  6. the two-hop c4 geometry (24 PRB, 1 layer) at batch 256, same checks;
  7. times with CUDA events: K1 and K2 against their plain versions, and the
     whole pallas_front call, at c2 batch 128;
  8. K5 (rc_smooth) against its plain version at the c2 rows (B=128, C=8,
     n_ext=650) and at the time-interpolation row count (C=2*nL*n_dsym);
  9. K6 (fused_fill_rotate) against its plain version: c2 equal CDM groups,
     nL=3 unequal groups, the c3 inpainting operator (1638 x 3276) as W, and a
     block written into its slice of a larger grid;
 10. `kernels="pallas"` in the reference layout at c2 (B=128) and c4 (two
     hops, B=256) against the float64 oracle (NMSE < 1e-12), K5 and K6
     launched in that run;
 11. `kernels="pallas"` in the serve layout at c2: the deferred route (the
     plain front, then K2), NMSE < 4e-11;
 12. `kernels="xla"` (plain torch, `entry()`'s configuration) in the serve and
     reference layouts at c2, no kernel launched;
 13. interp="cnn" through `kernels="pallas"` serve at c3 (273 PRB, batch 16):
     K2 with the 1638 x 3276 inpainting operator, against the oracle;
 14. the port's conformance selftest on the card (float64, "xla" tier): 12/12
     within -40 dB;
 15. times with CUDA events: K5 and K6 against their plain versions, and the
     whole build_ri call at c2 batch 128 for pallas/ref, pallas/serve and
     xla/serve.
Then one JSON line of per-kernel results, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEEDS = (11, 12, 13, 14)  # four distinct synthetic cases, tiled to the batch
C2 = dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0)
C3 = dict(n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0, interp="cnn")
C4 = dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0, two_hops=True)
SERVE_NMSE_BOUND = 4e-11  # the JAX package's serve bound vs the oracle (ARCHITECTURE.md)
REF_NMSE_BOUND = 1e-12  # the JAX package's reference-layout bound (ROADMAP.md "North star")


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
    from srsran_ce_tpu_torch.ops.kernels import fill_rotate as k6
    from srsran_ce_tpu_torch.ops.kernels import fill_rotate_serve as k2
    from srsran_ce_tpu_torch.ops.kernels import front as k1
    from srsran_ce_tpu_torch.ops.kernels import rc_smooth as k5
    from srsran_ce_tpu_torch.utils import oracle, synthetic
    from srsran_ce_tpu_torch.validation import cli, conformance, synth_vectors

    kmods = {"fused_front": k1, "fused_fill_rotate_serve": k2, "rc_smooth": k5,
             "fused_fill_rotate": k6}

    def reset_counts():
        for m in kmods.values():
            m.launches = 0

    def read_counts():
        return {k: m.launches for k, m in kmods.items()}

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

    # cases: four seeds, tiled to the batch
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

    def oracle_check(label, cases, res, layout, batch, bound):
        """Every problem's grid against the float64 oracle (NMSE < bound) and
        the scalars within the float32 bounds; returns the worst NMSE."""
        nL = cases[0].pilots.shape[2]
        n_sc = cases[0].received_rg.shape[0]
        ch = res.channel_est_rg.float().cpu().numpy()
        want_shape = (batch, 2, nL, 14, n_sc) if layout == "serve" else (batch, 2, n_sc, 14, nL)
        if ch.shape != want_shape or not np.isfinite(ch).all():
            fail(f"{label}: channel grid {ch.shape} not finite or not {want_shape}")
        worst = 0.0
        for i, c in enumerate(cases):
            o = oracle.estimate(c.received_rg, c.pilots, c.beta, c.hop1, c.hop2, c.config)
            want = o.channel_est_rg  # (n_sc, n_sym, nL)
            for b in range(i, batch, len(cases)):
                got = (ch[b, 0] + 1j * ch[b, 1]).astype(np.complex128)
                if layout == "serve":
                    got = got.transpose(2, 1, 0)
                nmse = np.sum(np.abs(got - want) ** 2) / np.sum(np.abs(want) ** 2)
                worst = max(worst, nmse)
            sl = slice(i, batch, len(cases))
            check_rtol(f"{label} noise", res.noise_est[sl].cpu(), o.noise_est, 1e-3)
            check_rtol(f"{label} cfo_hz", res.cfo_hz[sl].cpu(), o.cfo_hz, 1e-3, 1e-3)
            check_rtol(f"{label} rsrp", res.rsrp[sl].cpu(), o.rsrp, 1e-5)
            check_rtol(f"{label} epre", res.epre[sl].cpu(), o.epre, 1e-5)
            check_rtol(f"{label} ta", res.time_alignment[sl].cpu(), o.time_alignment, 1e-6, 1e-15)
        if not worst < bound:
            fail(f"{label}: channel NMSE vs oracle {worst:.3e} >= {bound}")
        return worst

    def run_path(kw, batch, kernels, layout):
        """One build_ri call of a path, counts set to 0 just before and read
        just after. Returns (cases, result, counts, fn, args)."""
        cases, cfg, rg_t, pil_t, beta = tiled(kw, batch)
        nL = cases[0].pilots.shape[2]
        fn = estimator.build_ri(cases[0].hop1, cases[0].hop2, cfg, nL, batched=True,
                                out_layout=layout, kernels=kernels)
        torch.cuda.synchronize()
        reset_counts()
        res = fn(rg_t, pil_t, beta)
        torch.cuda.synchronize()
        return cases, res, read_counts(), fn, (rg_t, pil_t, beta)

    def need(label, counts, launched=(), idle=()):
        """Kernels that must have launched (>= 1) and that must not have in a run."""
        if any(counts[k] < 1 for k in launched) or any(counts[k] for k in idle):
            fail(f"{label}: launch counts {counts}, expected >= 1 for {list(launched)}, "
                 f"0 for {list(idle)}")

    # 5 / 6. the pallas_front path against the float64 oracle
    def drive(label, kw, batch):
        cases, res, counts, fn, args = run_path(kw, batch, "pallas_front", "serve")
        need(label, counts, launched=("fused_front", "fused_fill_rotate_serve"),
             idle=("rc_smooth", "fused_fill_rotate"))
        worst = oracle_check(label, cases, res, "serve", batch, SERVE_NMSE_BOUND)
        print(f"phase {label}: serve {tuple(res.channel_est_rg.shape)}, worst NMSE vs float64 "
              f"oracle {worst:.3e} (< {SERVE_NMSE_BOUND}), scalars within bounds, launches {counts}")

        cfg = dataclasses.replace(cases[0].config, matmul_precision="high")
        nL = cases[0].pilots.shape[2]
        fac = estimator.build_ri(cases[0].hop1, cases[0].hop2, cfg, nL, batched=True,
                                 out_layout="factored", kernels="pallas_front")(*args)
        torch.cuda.synchronize()
        ch = res.channel_est_rg.cpu().numpy()
        prof = estimator.merge_ri(np.moveaxis(fac.profiles.cpu().numpy(), 1, 0))
        rot = estimator.merge_ri(np.moveaxis(fac.sym_rot.cpu().numpy(), 1, 0))
        grid = estimator.reconstruct_factored(prof[: len(cases)], rot[: len(cases)],
                                              cases[0].hop1, cases[0].hop2)
        serve = (ch[: len(cases), 0] + 1j * ch[: len(cases), 1]).transpose(0, 3, 2, 1)
        err = np.abs(grid - serve).max() / np.abs(serve).max()
        if not err <= 1e-5:
            fail(f"{label}: factored layout vs serve grid rel err {err:.3e} > 1e-5")
        print(f"phase {label} factored: reconstruct_factored vs serve grid rel err {err:.3e}")
        return counts, fn, args

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

    def print_times(phase, times):
        for kname, (ms, plain_ms, turns, warm) in times.items():
            print(f"phase {phase} {kname} c2 B=128, cold L2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(turns plain/kernel/kernel/plain {[round(t, 4) for t in turns]}); "
                  f"kernel back-to-back with warm L2 {warm:.4f} ms {card}")

    def call_ms(fn, args):
        """(CUDA-event ms with a cold L2, host wall-clock ms back to back) of one call."""
        ev = time_ms(lambda: fn(*args))
        t0 = time.perf_counter()
        for _ in range(50):
            fn(*args)
        torch.cuda.synchronize()
        return ev, (time.perf_counter() - t0) / 50 * 1e3

    times = {
        "fused_front": ab(lambda: k1.fused_front(*f_args, **f_kw),
                          lambda: k1.fused_front_plain(*f_args, **f_kw)),
        "fused_fill_rotate_serve": ab(
            lambda: k2.fused_fill_rotate_serve(*k2_args, layer_slices=hp.layer_slices),
            lambda: k2.fused_fill_rotate_serve_plain(*k2_args, layer_slices=hp.layer_slices)),
    }
    print_times(7, times)
    e2e, wall = call_ms(fn_c2, c2_args)
    print(f"phase 7 build_ri pallas_front/serve c2 B=128 (both kernels + plain glue): {e2e:.4f} "
          f"ms/batch on CUDA events, cold L2; {wall:.4f} ms/batch host wall clock back-to-back {card}")

    # 8. K5 vs plain: the c2 rows of _smooth (2*nL = 8 rows of n_re + 2*n_pils)
    # and the time-interpolation rows (2*nL*n_dsym = 32)
    taps = hp.rc_taps
    n_ext = hp.n_re + 2 * hp.n_pils
    k5_inputs = {}
    for label, C in (("c2 rows", 2 * hp.n_layers), ("time-interp rows", 2 * hp.n_layers * hp.n_dsym)):
        x = torch.as_tensor(rng.standard_normal((128, C, n_ext)), dtype=torch.float32, device=dev)
        o_k = k5.rc_smooth(x, taps)
        o_p = k5.rc_smooth_plain(x, taps)
        torch.cuda.synchronize()
        abs_err, err = errs(o_k, o_p)
        if o_k.shape != (128, C, hp.n_re) or not err <= 1e-5:
            fail(f"K5 {label}: out {tuple(o_k.shape)}, relative error {err:.3e} > 1e-5")
        results.setdefault("rc_smooth", abs_err)
        k5_inputs.setdefault("c2", x)
        print(f"phase 8 K5 vs plain ({label}, x {tuple(x.shape)}, K={taps.size}): max abs err "
              f"{abs_err:.3e}, rel err {err:.3e} (<= 1e-5)")

    # 9. K6 vs plain
    case3 = synthetic.make_case(seed=3, **C3)
    plan_c3 = make_plan(case3.hop1, case3.hop2, case3.config, 1)
    hp3 = plan_c3.hop1
    w_c3 = plan_tensors(plan_c3, dev, torch.float32)["hops"][0]["interp"]  # (1, 1638, 3276)

    def rot_of(batch, n_sym):
        ph = rng.uniform(-np.pi, np.pi, (batch, n_sym))
        return torch.as_tensor(np.stack([np.cos(ph), np.sin(ph)], 1), dtype=torch.float32, device=dev)

    def h_of(batch, nL, n_re):
        return torch.as_tensor(rng.standard_normal((batch, 2, nL, n_re)), dtype=torch.float32, device=dev)

    k6_cases = (
        ("c2 nL=4, groups (0,2),(2,4)", h_of(128, 4, hp.n_re), w_c2, rot_of(128, 14), hp.layer_slices),
        ("nL=3, groups (0,2),(2,3)", h_of(128, 3, hp.n_re), k2_cases[1][2], rot_of(128, 14),
         ((0, 2), (2, 3))),
        ("c3 inpainting operator 1638x3276", h_of(16, 1, hp3.n_re), w_c3, rot_of(16, 14), ((0, 1),)),
    )
    for label, h, w, rot, slices in k6_cases:
        o_k = k6.fused_fill_rotate(h, w, rot, layer_slices=slices)
        o_p = k6.fused_fill_rotate_plain(h, w, rot, layer_slices=slices)
        torch.cuda.synchronize()
        abs_err, err = errs(o_k, o_p)
        if not err <= 1e-5:
            fail(f"K6 {label} relative error {err:.3e} > 1e-5")
        results.setdefault("fused_fill_rotate", abs_err)
        print(f"phase 9 K6 vs plain ({label}, out {tuple(o_k.shape)}): max abs err {abs_err:.3e}, "
              f"rel err {err:.3e} (<= 1e-5)")
    # a 10-symbol block at (sc 24, sym 3) of a (300, 14) grid: the rest stays as it was
    h, w, rot = h_of(8, 3, 52), torch.as_tensor(0.1 * rng.standard_normal((2, 52, 200)),
                                                dtype=torch.float32, device=dev), rot_of(8, 10)
    grid = torch.full((8, 2, 300, 14, 3), 7.0, device=dev)
    k6.fused_fill_rotate(h, w, rot, ((0, 2), (2, 3)), out=grid, sc_start=24, sym_start=3)
    want = torch.full_like(grid, 7.0)
    want[:, :, 24:224, 3:13] = k6.fused_fill_rotate_plain(h, w, rot, ((0, 2), (2, 3)))
    torch.cuda.synchronize()
    abs_err, err = errs(grid, want)
    if not err <= 1e-5:
        fail(f"K6 block into a larger grid: relative error {err:.3e} > 1e-5")
    print(f"phase 9 K6 into a (300, 14) grid at (24, 3): rel err {err:.3e} (<= 1e-5), outside untouched")

    # 10. kernels="pallas", reference layout (the conformance path) vs the oracle
    pallas_counts = None
    for label, kw, batch in (("c2", C2, 128), ("c4 two hops", C4, 256)):
        cases, res, cnt, fn, args = run_path(kw, batch, "pallas", "ref")
        need(f"pallas/ref {label}", cnt, launched=("rc_smooth", "fused_fill_rotate"),
             idle=("fused_front", "fused_fill_rotate_serve"))
        worst = oracle_check(f"pallas/ref {label}", cases, res, "ref", batch, REF_NMSE_BOUND)
        print(f"phase 10 pallas/ref {label}: ref {tuple(res.channel_est_rg.shape)}, worst NMSE vs "
              f"float64 oracle {worst:.3e} (< {REF_NMSE_BOUND}), scalars within bounds, launches {cnt}")
        if pallas_counts is None:
            pallas_counts, fn_pref, args_c2 = cnt, fn, args

    # 11. kernels="pallas", serve layout: the deferred route (plain front, then K2)
    cases, res, cnt, fn_pserve, _ = run_path(C2, 128, "pallas", "serve")
    need("pallas/serve c2", cnt, launched=("fused_fill_rotate_serve",),
         idle=("fused_front", "rc_smooth", "fused_fill_rotate"))
    worst = oracle_check("pallas/serve c2", cases, res, "serve", 128, SERVE_NMSE_BOUND)
    print(f"phase 11 pallas/serve c2: worst NMSE vs float64 oracle {worst:.3e} "
          f"(< {SERVE_NMSE_BOUND}), launches {cnt}")

    # 12. kernels="xla": plain torch, no kernel
    fns_xla = {}
    for layout, bound in (("serve", SERVE_NMSE_BOUND), ("ref", REF_NMSE_BOUND)):
        cases, res, cnt, fns_xla[layout], _ = run_path(C2, 128, "xla", layout)
        need(f"xla/{layout} c2", cnt, idle=tuple(kmods))
        worst = oracle_check(f"xla/{layout} c2", cases, res, layout, 128, bound)
        print(f"phase 12 xla/{layout} c2: worst NMSE vs float64 oracle {worst:.3e} (< {bound}), "
              f"launches {cnt}")

    # 13. interp="cnn" through kernels="pallas" serve at c3: K2 with the inpainting operator
    cases, res, cnt, _, _ = run_path(C3, 16, "pallas", "serve")
    need("cnn pallas/serve c3", cnt, launched=("fused_fill_rotate_serve",))
    worst = oracle_check("cnn pallas/serve c3", cases, res, "serve", 16, SERVE_NMSE_BOUND)
    print(f"phase 13 cnn pallas/serve c3 (273 PRB, B=16, operator {tuple(w_c3.shape[1:])}): worst "
          f"NMSE vs float64 oracle {worst:.3e} (< {SERVE_NMSE_BOUND}), launches {cnt}")

    # 14. the conformance selftest on the card (float64, the "xla" tier)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        header = synth_vectors.generate_suite(td, cli.SELFTEST_SPECS)
        report = conformance.run_suite(header, td, nmse_bound_db=-40.0, device=dev)
    worst_db = max(10 * np.log10(r["nmse"] + 1e-300) for r in report["results"])
    if report["n_pass"] != report["n_cases"] or report["n_cases"] != 12:
        bad = [(r["idx"], r["nmse"], r["message"]) for r in report["results"] if not r["passed"]]
        fail(f"selftest {report['n_pass']}/{report['n_cases']}: {bad}")
    print(f"phase 14 selftest on {dev}: {report['n_pass']}/{report['n_cases']} within -40 dB, "
          f"worst {worst_db:.1f} dB, {time.perf_counter() - t0:.1f} s")

    # 15. times: K5 and K6 vs plain, and the three build_ri calls
    x5 = k5_inputs["c2"]
    h6, w6, r6, s6 = k6_cases[0][1:]
    times.update({
        "rc_smooth": ab(lambda: k5.rc_smooth(x5, taps), lambda: k5.rc_smooth_plain(x5, taps)),
        "fused_fill_rotate": ab(lambda: k6.fused_fill_rotate(h6, w6, r6, s6),
                                lambda: k6.fused_fill_rotate_plain(h6, w6, r6, s6)),
    })
    print_times(15, {k: times[k] for k in ("rc_smooth", "fused_fill_rotate")})
    for label, fn in (("pallas/ref", fn_pref), ("pallas/serve", fn_pserve), ("xla/serve", fns_xla["serve"])):
        ev, wall = call_ms(fn, args_c2)
        print(f"phase 15 build_ri {label} c2 B=128: {ev:.4f} ms/batch on CUDA events, cold L2; "
              f"{wall:.4f} ms/batch host wall clock back-to-back {card}")

    sources = {"fused_front": ("srsran_ce_tpu_torch/csrc/front.cu",
                               "srsran_ce_tpu/ops/pallas/kernels.py:639"),
               "fused_fill_rotate_serve": ("srsran_ce_tpu_torch/csrc/fill_rotate_serve.cu",
                                           "srsran_ce_tpu/ops/pallas/kernels.py:232"),
               "rc_smooth": ("srsran_ce_tpu_torch/csrc/rc_smooth.cu",
                             "srsran_ce_tpu/ops/pallas/kernels.py:786"),
               "fused_fill_rotate": ("srsran_ce_tpu_torch/csrc/fill_rotate.cu",
                                     "srsran_ce_tpu/ops/pallas/kernels.py:70")}
    launches = dict(counts)
    launches.update({k: pallas_counts[k] for k in ("rc_smooth", "fused_fill_rotate")})
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
         "launches": launches[k], "max_abs_err": results[k], "ms": times[k][0],
         "plain_ms": times[k][1]}
        for k in sources
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
