#!/usr/bin/env python3
"""Time K1, K2, K6, K5, K3 and K4 of this checkout against those of another
checkout, in turns, on one NVIDIA GPU.

    python3 ab_kernels.py OTHER_CHECKOUT [k1|k2|k6|k5|k3|k4 ...]

OTHER_CHECKOUT holds another version of `srsran_ce_tpu_torch/csrc/` with the
same C entries (`srs_fused_front_strided_f32`, `srs_front_plan`,
`srs_fill_rotate_serve_f32`, `srs_fill_rotate_f32`, `srs_rc_smooth_f32`,
`srs_ldpc_posterior_f32`, `srs_ldpc_stream_posterior`, same argument lists;
K1's may also be the argument list it had beside its dense smoothing route,
which is told by the `pair_l` argument in the other `front.cu`), for example
the parent commit unpacked by `git archive`. Its `front.cu`,
`fill_rotate_serve.cu`, `fill_rotate.cu`, `rc_smooth.cu`, `ldpc.cu` and
`ldpc_stream.cu` are built with this checkout's nvcc flags (each includes the
headers of its own directory), all at the same time as this checkout's. Both
libraries get the same arguments (K1's on the staged form, each with the
shared memory of its own library's plan, `srs_front_plan`), except K1's
smoothing in a body with the dense route (the plan's dense operator up to
1,024 pilot REs, the taps past that) and K6's layer table: chunks of at most
two layers of a CDM group for a body before the shared tiled product (which
refuses more), whole CDM groups for this checkout's. The LDPC scratch and
delta buffers are sized for either layout (per-edge messages or per-row
records). Each library is held to the plain version first (K1 h_s relative
1e-5, the scalars within rtol 1e-4 and the same TA bins; K2, K6 and K5
relative 1e-5, K6 written at its offset into a larger grid whose rest must
stay as it was; K3 and K4 bit for bit, torch.equal on the int32 views), then
both are timed device-only (torch.profiler's CUDA kernel time over n calls,
over n) in turns other / this / this / other:
  k1  staged, at c2 (106 PRB, 4 layers, the shape of `ce40_closed4`) B=128,
      c4 (24 PRB, 1 layer) B=256 and 273 PRB, 4 layers (the shape of
      `ce100_64ant_closed2`) B=128; each library's h_s error against the
      plain version is printed and whether the two outputs are bit-identical
      (torch.equal): at 273 PRB both take the banded route and must be; at
      c2 and c4 a body with the dense route takes it there, and the two
      routes round differently in float32, so they are compared by time and
      by each one's error against the plain version, not by bits. This
      checkout's K1 on the gathered inputs must give its staged bits;
  k2  c2 B=128 (its interpolation operator, CDM groups (0,2),(2,4)), nL=3
      (groups (0,2),(2,3)) with a seeded operator of c2's shape, and the c3
      inpainting operator (1638 x 3276, B=16, one layer); the two outputs
      must be bit-identical (torch.equal) and this checkout's mean time
      over two rounds of turns within 3 % of the other's (K2's arithmetic
      did not change when its product moved into csrc/fill_common.cuh);
  k6  the same three shapes in the reference layout, and the c4 second hop
      (B=256, its 144 x 288 operator, 7 symbols written at subcarrier 336,
      symbol 7 of the (624, 14) grid);
  k5  c2 rows (128, 8, 650) and time-interpolation rows (128, 32, 650), K=15;
  k3  NR BG1 Z=384, B=128, 8 layered sweeps, bfloat16 and float32 messages;
      the e2e decode shape, B=24, 16 sweeps, bfloat16; the served call's
      shape (8 slots of 12 blocks), B=96, 16 sweeps, bfloat16; the host
      decode path's word chunk, B=512, 16 sweeps, bfloat16;
  k4  chip_smoke phase 16's six configurations: n976 B=512 flooding-25 and
      layered-13, BG2 Z=208 B=128 flooding-16 and layered-8 G=8, BG1 Z=52
      B=128 flooding-16 and layered-8 G=2.
Without kernel names, all six. Prints the card's `nvidia-smi` name and
power limit beside the numbers. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = {"k1": "front", "k2": "fill_rotate_serve", "k6": "fill_rotate", "k5": "rc_smooth",
           "k4": "ldpc", "k3": "ldpc_stream"}


def main(argv) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    picked = argv[1:] or list(SOURCES)
    if not argv or any(k not in SOURCES for k in picked):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from srsran_ce_tpu_torch.models import estimator
    from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
    from srsran_ce_tpu_torch.ops import ldpc, nr_ldpc
    from srsran_ce_tpu_torch.ops.kernels import _build, bind, launch
    from srsran_ce_tpu_torch.ops.kernels import fill_rotate as k6
    from srsran_ce_tpu_torch.ops.kernels import fill_rotate_serve as k2
    from srsran_ce_tpu_torch.ops.kernels import front as k1
    from srsran_ce_tpu_torch.ops.kernels import ldpc as k4
    from srsran_ce_tpu_torch.ops.kernels import ldpc_stream as k3
    from srsran_ce_tpu_torch.ops.kernels import rc_smooth as k5
    from srsran_ce_tpu_torch.utils import synthetic

    other_dir = Path(argv[0]).resolve() / "srsran_ce_tpu_torch" / "csrc"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in picked:
        src = SOURCES[k]
        so = _build.BUILD_DIR / f"lib{src}_other.so"
        procs[k] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(other_dir / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.build_all(tuple(SOURCES[k] for k in picked))
    other = {}
    for k, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {other_dir / SOURCES[k]}.cu:\n{log}")
        other[k] = ctypes.CDLL(str(so))

    def entry(k, symbol, argtypes):
        """(other's, this checkout's) C entry `symbol` of kernel k."""
        fn = getattr(other[k], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn, bind(SOURCES[k], symbol, argtypes)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)

    def device_ms(fn, n):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a profiler session now and then records no kernel: take another
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                     for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
            if us > 0:
                return us / n / 1e3
        raise SystemExit("the profiler saw no device time in 3 sessions")

    def turns(label, runs, n, rounds=1):
        t = [(lab, device_ms(runs[lab], n)) for lab in ("other", "this", "this", "other") * rounds]
        mean = {lab: float(np.mean([v for l_, v in t if l_ == lab])) for lab in ("other", "this")}
        print(f"{label} device-only ms, turns other/this/this/other {[round(v, 5) for _, v in t]}: "
              f"other {mean['other']:.5f}, this {mean['this']:.5f} "
              f"({mean['other'] / mean['this']:.2f}x) [{smi}]")
        return mean

    def rel_err(got, want):
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    if "k1" in picked:
        this_k1 = bind("front", "srs_fused_front_strided_f32", k1._STRIDED_ARGTYPES)
        dense_body = "const float* pair_l" in (other_dir / "front.cu").read_text()
        # the argument list of a body with the dense route: rx, its tables and
        # strides, pil and its strides, beta, pair_l, pair_r, vp, smooth,
        # smooth_vb, smooth_ve, ta_c, ta_s, two_pi_sst_d, h_out, sc_out; ten
        # ints, three floats, smem, taps, n_taps, stream
        strides_t = ctypes.POINTER(ctypes.c_longlong)
        dense_argtypes = ([ctypes.c_void_p] * 3 + [strides_t, ctypes.c_void_p, strides_t]
                          + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
                          + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        other_k1 = getattr(other["k1"], "srs_fused_front_strided_f32")
        other_k1.argtypes = dense_argtypes if dense_body else k1._STRIDED_ARGTYPES
        other_k1.restype = ctypes.c_int
        plans = dict(zip(("other", "this"), entry("k1", "srs_front_plan", k1.PLAN_ARGTYPES)))
        caps = k1.kernel_caps(dev)

        def smem_of(lab, B, hp, nL, n_taps):
            """The shared memory of library `lab`'s plan (n_taps 0: the dense route's)."""
            out = (ctypes.c_longlong * 9)()
            rc = plans[lab](out, B, hp.n_re, nL, hp.n_pils, hp.half_cp_len,
                            hp.ta_dft_cos.shape[0], (ctypes.c_int * 8)(*caps), n_taps)
            if rc != 0:
                raise SystemExit(f"K1 {lab}: srs_front_plan refused the shape ({rc})")
            return int(out[8])

        for label, kw, B in (("c2", dict(n_prbs=106, n_layers=4), 128),
                             ("c4", dict(n_prbs=24, n_layers=1, two_hops=True), 256),
                             ("273 PRB", dict(n_prbs=273, n_layers=4), 128)):
            cases = [synthetic.make_case(seed=s, comb=2, scs_hz=30e3, snr_db=30.0, **kw)
                     for s in (11, 12, 13, 14)]
            nL = cases[0].pilots.shape[2]
            plan = make_plan(cases[0].hop1, cases[0].hop2, cases[0].config, nL)
            hp, ht = plan.hop1, plan_tensors(plan, dev, torch.float32)["hops"][0]
            idx = np.arange(B) % len(cases)
            rg = torch.as_tensor(np.stack([estimator.split_ri(c.received_rg) for c in cases])[idx],
                                 dtype=torch.float32, device=dev)
            pil = torch.as_tensor(np.stack([estimator.split_ri(c.pilots) for c in cases])[idx],
                                  dtype=torch.float32, device=dev)
            rg = rg + torch.as_tensor(1e-3 * np.random.default_rng(101).standard_normal(rg.shape),
                                      dtype=torch.float32, device=dev)
            pil_staged = pil[:, :, :, : hp.n_dsym]
            beta = torch.ones(B, dtype=torch.float32, device=dev)
            mats = ht["front"]
            fkw = dict(n_samples=hp.n_samples, half_cp_len=hp.half_cp_len, fft_size=hp.fft_size,
                       scs_hz=cases[0].config.scs_hz, cfo_possible=hp.cfo_possible,
                       cfo_compensate=cases[0].config.cfo_compensate)
            rx, pil_g = k1.gather_staged(rg, pil_staged, ht["re_idx"], ht["dmrs_sym_idx"])
            h_p, s_p = k1.fused_front_plain(rx, pil_g, beta, mats, **fkw)
            n_re, n_pils, k_ta, n_taps = hp.n_re, hp.n_pils, mats["ta_c"].shape[0], hp.rc_taps.size
            h_o = torch.empty_like(h_p)
            s_o = torch.empty_like(s_p)
            rotate = fkw["cfo_possible"] and fkw["cfo_compensate"]
            sb, sri, sk, sd = rg.stride()
            pb, pri, pk, pd, pl = pil_staged.stride()
            st = lambda v: (ctypes.c_longlong * 5)(*v)
            head = (rg.data_ptr(), ht["re_idx"].data_ptr(), ht["dmrs_sym_idx"].data_ptr(),
                    st((sb, sri, 0, sd, sk)), pil_staged.data_ptr(), st((pb, pri, pl, pd, pk)),
                    beta.data_ptr())
            ptr = lambda t: None if t is None else t.data_ptr()
            vp, sst = mats["vp"] if n_pils > 1 else None, mats["two_pi_sst_d"] if rotate else None
            flt = (2.0 * np.pi * hp.n_samples, float(hp.fft_size), float(fkw["scs_hz"]))
            flags = (int(fkw["cfo_possible"]), int(fkw["cfo_compensate"]))
            dims = (B, rx.shape[2], nL, hp.n_dsym, n_re, n_pils, k_ta, hp.half_cp_len)
            this_args = (*head, ptr(vp), ptr(mats["taps"]), ptr(mats["ta_c"]), ptr(mats["ta_s"]),
                         ptr(sst), ptr(h_o), ptr(s_o), *dims, n_taps, *flags, *flt,
                         smem_of("this", B, hp, nL, n_taps))
            if not dense_body:
                other_args = this_args[:-1] + (smem_of("other", B, hp, nL, n_taps),)
            elif hp.smooth_mat is None:  # the other body's banded route
                other_args = (*head, None, None, ptr(vp), None, None, None, ptr(mats["ta_c"]),
                              ptr(mats["ta_s"]), ptr(sst), ptr(h_o), ptr(s_o), *dims, *flags,
                              *flt, smem_of("other", B, hp, nL, n_taps), ptr(mats["taps"]), n_taps)
            else:  # its dense route, the plan's operator
                t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                              device=dev)
                dm = [t(a) for a in (hp.pair_l_mat, hp.pair_r_mat, hp.smooth_mat,
                                     hp.smooth_vb_mat, hp.smooth_ve_mat)]
                other_args = (*head, ptr(dm[0]), ptr(dm[1]), ptr(vp), ptr(dm[2]), ptr(dm[3]),
                              ptr(dm[4]), ptr(mats["ta_c"]), ptr(mats["ta_s"]), ptr(sst),
                              ptr(h_o), ptr(s_o), *dims, *flags, *flt,
                              smem_of("other", B, hp, nL, 0), None, 0)
            route = {"this": "banded", "other": "dense" if dense_body and hp.smooth_mat is not None
                     else "banded"}
            runs, outs = {}, {}
            to_bin = hp.fft_size * fkw["scs_hz"]
            for lab, fn, args in (("other", other_k1, other_args), ("this", this_k1, this_args)):
                runs[lab] = (lambda fn=fn, args=args: launch("fused_front", fn, dev, *args))
                h_o.fill_(float("nan"))
                runs[lab]()
                torch.cuda.synchronize()
                err = rel_err(h_o, h_p)
                sk_, sp_ = s_o.cpu().numpy(), s_p.cpu().numpy()
                if not (err <= 1e-5 and np.array_equal(np.rint(sk_[:, 1] * to_bin),
                                                       np.rint(sp_[:, 1] * to_bin))
                        and np.allclose(sk_[:, [0, 2, 3, 4]], sp_[:, [0, 2, 3, 4]], rtol=1e-4,
                                        atol=1e-12)):
                    raise SystemExit(f"K1 {lab} at {label}: h_s rel err {err:.3e}, or the "
                                     "scalars / TA bins differ from the plain version")
                print(f"K1 {lab} ({route[lab]} route) at {label} B={B}, staged: h_s rel err vs "
                      f"plain {err:.2e}, scalars within rtol 1e-4, TA bins equal")
                outs[lab] = (h_o.clone(), s_o.clone())
            same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
            if route["other"] == "banded" and not same:
                raise SystemExit(f"K1 at {label}: both on the banded route, not bit-identical "
                                 f"(h_s max abs diff "
                                 f"{float((outs['other'][0] - outs['this'][0]).abs().max()):.3e})")
            h_g, s_g = k1.fused_front(rx, pil_g, beta, mats, **fkw)
            if not (torch.equal(h_g, outs["this"][0]) and torch.equal(s_g, outs["this"][1])):
                raise SystemExit(f"K1 this gathered at {label}: not bit-identical to this staged")
            print(f"K1 at {label} B={B}: other and this bit-identical: {same}; this gathered "
                  f"bit-identical to this staged")
            turns(f"K1 {label} B={B} ({route['other']} / {route['this']})", runs, 50)

    fill_rows = ()
    if "k2" in picked or "k6" in picked:
        # (label, B, nL, W, CDM groups, symbols, grid (sc, sym), block at (sc0, sy0))
        case = synthetic.make_case(seed=11, n_prbs=106, n_layers=4, comb=2, scs_hz=30e3,
                                   snr_db=30.0)
        w_c2 = plan_tensors(make_plan(case.hop1, case.hop2, case.config, 4), dev,
                            torch.float32)["hops"][0]["interp"]
        case4 = synthetic.make_case(seed=11, n_prbs=24, n_layers=1, comb=2, scs_hz=30e3,
                                    snr_db=30.0, two_hops=True)
        plan4 = make_plan(case4.hop1, case4.hop2, case4.config, 1)
        w_c4 = plan_tensors(plan4, dev, torch.float32)["hops"][1]["interp"]
        hop4 = plan4.hop2
        rng = np.random.default_rng(7)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        fill_rows = (
            ("c2 nL=4 groups (0,2),(2,4)", 128, 4, w_c2, ((0, 2), (2, 4)), 14, (1272, 14), (0, 0)),
            ("nL=3 groups (0,2),(2,3)", 128, 3, t(0.1 * rng.standard_normal(tuple(w_c2.shape))),
             ((0, 2), (2, 3)), 14, (1272, 14), (0, 0)),
            ("c3 operator 1638 x 3276, B=16", 16, 1, t(0.05 * rng.standard_normal((1, 1638, 3276))),
             ((0, 1),), 14, (3276, 14), (0, 0)),
            ("c4 second hop, B=256", 256, 1, w_c4, hop4.layer_slices, hop4.n_alloc_syms,
             (case4.received_rg.shape[0], 14), (hop4.sc_start, hop4.sym_start)))

    def fill_inputs(B, nL, w, n_sym):
        h = t(rng.standard_normal((B, 2, nL, w.shape[1])))
        ph = rng.uniform(-np.pi, np.pi, (B, n_sym))
        return h, t(np.stack([np.cos(ph), np.sin(ph)], 1))

    if "k2" in picked:
        fns = dict(zip(("other", "this"), entry("k2", "srs_fill_rotate_serve_f32", k2._ARGTYPES)))
        for label, B, nL, w, slices, _, _, _ in fill_rows[:3]:
            h, rot = fill_inputs(B, nL, w, 14)
            want = k2.fused_fill_rotate_serve_plain(h, w, rot, slices)
            out = torch.empty_like(want)
            tab = k2.chunk_table(k2.chunks_of(slices, nL, w.shape[0]))
            runs, outs = {}, {}
            for lab, fn in fns.items():
                runs[lab] = (lambda fn=fn: launch(
                    "fused_fill_rotate_serve", fn, dev, h.data_ptr(), w.data_ptr(), rot.data_ptr(),
                    out.data_ptr(), B, nL, w.shape[1], w.shape[2], 14, ctypes.byref(tab)))
                out.fill_(float("nan"))
                runs[lab]()
                torch.cuda.synchronize()
                err = rel_err(out, want)
                if not err <= 1e-5:
                    raise SystemExit(f"K2 {lab} at {label}: relative error {err:.3e} > 1e-5")
                outs[lab] = out.clone()
                print(f"K2 {lab} at {label}: rel err vs plain {err:.2e}")
            if not torch.equal(outs["this"], outs["other"]):
                raise SystemExit(f"K2 at {label}: this checkout's output differs from the other's "
                                 f"(max abs {float((outs['this'] - outs['other']).abs().max()):.3e})")
            print(f"K2 at {label}: this checkout's output bit-identical to the other's")
            mean = turns(f"K2 {label}", runs, 200, rounds=2)
            if not mean["this"] <= 1.03 * mean["other"]:
                raise SystemExit(f"K2 at {label}: this checkout {mean['this']:.5f} ms, more than 3 % "
                                 f"over the other's {mean['other']:.5f}")

    if "k6" in picked:
        fns = dict(zip(("other", "this"), entry("k6", "srs_fill_rotate_f32", k6._ARGTYPES)))
        for label, B, nL, w, slices, n_sym, (g_sc, g_sym), (sc0, sy0) in fill_rows:
            h, rot = fill_inputs(B, nL, w, n_sym)
            n_cdm, n_re, n_sc = w.shape
            want = k6.fused_fill_rotate_plain(h, w, rot, slices)
            out = torch.empty((B, 2, g_sc, g_sym, nL), dtype=torch.float32, device=dev)
            blk = out[:, :, sc0:sc0 + n_sc, sy0:sy0 + n_sym]
            tabs = {"other": k2.chunk_table(k2.chunks_of(slices, nL, n_cdm)),
                    "this": k2.chunk_table(k6.fill_chunks(slices, nL, n_cdm))}
            runs = {}
            for lab, fn in fns.items():
                runs[lab] = (lambda fn=fn, tab=tabs[lab]: launch(
                    "fused_fill_rotate", fn, dev, h.data_ptr(), w.data_ptr(), rot.data_ptr(),
                    out.data_ptr(), B, nL, n_re, n_sc, n_sym, g_sc, g_sym, sc0, sy0,
                    ctypes.byref(tab)))
                out.fill_(float("nan"))
                runs[lab]()
                torch.cuda.synchronize()
                err = rel_err(blk, want)
                untouched = int(out.isnan().sum()) == out.numel() - blk.numel()
                if not (err <= 1e-5 and untouched):
                    raise SystemExit(f"K6 {lab} at {label}: relative error {err:.3e} (> 1e-5?) or "
                                     "the grid outside the block was written")
                print(f"K6 {lab} at {label}: rel err vs plain {err:.2e}, grid outside the block "
                      "untouched")
            turns(f"K6 {label}", runs, 50)

    if "k5" in picked:
        case = synthetic.make_case(seed=11, n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0)
        hp = make_plan(case.hop1, case.hop2, case.config, 4).hop1
        taps, n_ext = hp.rc_taps, hp.n_re + 2 * hp.n_pils
        tab = k5.taps_struct(taps)
        fns = dict(zip(("other", "this"), entry("k5", "srs_rc_smooth_f32", k5._ARGTYPES)))
        rng = np.random.default_rng(5)
        for C in (8, 32):
            x = torch.as_tensor(rng.standard_normal((128, C, n_ext)), dtype=torch.float32, device=dev)
            out = torch.empty((128, C, n_ext - tab.k + 1), dtype=torch.float32, device=dev)
            want = k5.rc_smooth_plain(x, taps)
            runs = {}
            for label, fn in fns.items():
                runs[label] = (lambda fn=fn: launch("rc_smooth", fn, dev, x.data_ptr(), out.data_ptr(),
                                                    128 * C, n_ext, tab))
                out.zero_()
                runs[label]()
                torch.cuda.synchronize()
                err = float((out.double() - want.double()).abs().max() / want.double().abs().max())
                if not err <= 1e-5:
                    raise SystemExit(f"{label} K5 at (128, {C}, {n_ext}): relative error {err:.3e}")
                print(f"K5 {label} at (128, {C}, {n_ext}), K={tab.k}: rel err vs plain {err:.2e}")
            turns(f"K5 (128, {C}, {n_ext})", runs, 200)

    def words(code, batch, snr_db, seed=0):
        """(plan, float32 LLRs on the card) of `batch` encoded words through BPSK + AWGN."""
        plan = ldpc.make_ldpc_plan(code)
        r = np.random.default_rng(seed)
        cw = ldpc.encode(code, r.integers(0, 2, (batch, plan.k), dtype=np.uint8))
        snr = 10.0 ** (snr_db / 10)
        llr = 4 * snr * ((1 - 2.0 * cw) + r.normal(0, np.sqrt(0.5 / snr), cw.shape))
        return plan, torch.as_tensor(llr.astype(np.float32), device=dev)

    def ldpc_ab(k, label, fns, plan, ch, want, msg_bytes, args_of):
        """Hold both LDPC libraries to the plain version, then time them in turns."""
        w = k4.wiring(plan, dev)
        B = ch.shape[0]
        # scratch for either layout: per-edge messages or per-row records; a
        # delta buffer for the per-edge layout's groups
        nbytes = max(B * w.n_edges * w.z * msg_bytes,
                     B * k4.record_stride(w.z, msg_bytes) * w.mb)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        delta = torch.empty((B, w.mb * w.d * w.z), dtype=torch.float32, device=dev)
        out = torch.empty_like(ch)
        runs = {}
        for lab, fn in fns.items():
            args = args_of(w, B)
            runs[lab] = (lambda fn=fn, args=args: launch(
                label, fn, dev, ch.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                delta.data_ptr(), w.table.data_ptr(), B, w.n_edges, w.mb, w.nb, w.z, w.d, *args))
            out.fill_(float("nan"))
            runs[lab]()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"{k} {lab} {label}: max abs diff "
                                 f"{float((out - want).abs().max()):.3e} vs plain, expected bit-identical")
            print(f"{k} {lab} {label}: bit-identical to plain")
        turns(f"{k} {label}", runs, 20)

    if "k3" in picked:
        fns = dict(zip(("other", "this"), entry("k3", "srs_ldpc_stream_posterior", k3._ARGTYPES)))
        code = nr_ldpc.nr_base_graph(1, 384)
        for B, sweeps, c2v in ((128, 8, "bfloat16"), (128, 8, None), (24, 16, "bfloat16"),
                               (96, 16, "bfloat16"), (512, 16, "bfloat16")):
            plan, ch = words(code, B, 3.5)
            want = k3.ldpc_stream_posterior_plain(ch, plan, sweeps, 0.75, 1, c2v)
            bf16 = int(c2v == "bfloat16")
            ldpc_ab("K3", f"BG1 Z=384 B={B} layered-{sweeps} G=1 {c2v or 'float32'}", fns, plan, ch,
                    want, 2 if bf16 else 4,
                    lambda w, B_, s=sweeps, b=bf16: (0.75, s, 1, b))
    if "k4" in picked:
        fns = dict(zip(("other", "this"), entry("k4", "srs_ldpc_posterior_f32", k4._ARGTYPES)))
        rows = (("n976", ldpc.array_code(6, 16, 61), 512, 4.0, 25, 13),
                ("BG2 Z=208", nr_ldpc.nr_base_graph(2, 208), 128, 3.5, 16, 8),
                ("BG1 Z=52", nr_ldpc.nr_base_graph(1, 52), 128, 3.5, 16, 8))
        for row, code, B, snr_db, it_f, it_l in rows:
            plan, ch = words(code, B, snr_db)
            g = ldpc.default_layered_group(code)
            for sched, iters, grp in (("flooding", it_f, 1), ("layered", it_l, g)):
                want = k4.ldpc_posterior_plain(ch, plan, iters, 0.75, sched, grp)
                ldpc_ab("K4", f"{row} B={B} {sched}-{iters} G={grp}", fns, plan, ch, want, 4,
                        lambda w, B_, i=iters, s=sched, gg=grp: (i, 0.75, int(s == "layered"),
                                                                 min(gg, w.mb)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
