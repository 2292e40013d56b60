#!/usr/bin/env python3
"""Time K5, K3 and K4 of this checkout against those of another checkout, in
turns, on one NVIDIA GPU.

    python3 ab_kernels.py OTHER_CHECKOUT [k5|k3|k4 ...]

OTHER_CHECKOUT holds another version of `srsran_ce_tpu_torch/csrc/` with the
same C entries (`srs_rc_smooth_f32`, `srs_ldpc_posterior_f32`,
`srs_ldpc_stream_posterior`, same argument lists), for example the parent
commit unpacked by `git archive`. Its `rc_smooth.cu`, `ldpc.cu` and
`ldpc_stream.cu` are built with this checkout's nvcc flags (each includes
the `ldpc_common.cuh` of its own directory), all at the same time as this
checkout's. Both libraries get the same arguments; the LDPC scratch and
delta buffers are sized for either layout (per-edge messages or per-row
records). Each library is held to the plain version first (K5 relative
1e-5; K3 and K4 bit for bit, torch.equal on the int32 views), then both are
timed device-only (torch.profiler's CUDA kernel time over n calls, over n)
in turns other / this / this / other:
  k5  c2 rows (128, 8, 650) and time-interpolation rows (128, 32, 650), K=15;
  k3  NR BG1 Z=384, B=128, 8 layered sweeps, bfloat16 and float32 messages;
      the e2e decode shape, B=24, 16 sweeps, bfloat16;
  k4  chip_smoke phase 16's six configurations: n976 B=512 flooding-25 and
      layered-13, BG2 Z=208 B=128 flooding-16 and layered-8 G=8, BG1 Z=52
      B=128 flooding-16 and layered-8 G=2.
Without kernel names, all three. Prints the card's `nvidia-smi` name and
power limit beside the numbers. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCES = {"k5": "rc_smooth", "k4": "ldpc", "k3": "ldpc_stream"}


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
    from srsran_ce_tpu_torch.models.plan import make_plan
    from srsran_ce_tpu_torch.ops import ldpc, nr_ldpc
    from srsran_ce_tpu_torch.ops.kernels import _build, bind, launch
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

    def turns(label, runs, n):
        t = [(lab, device_ms(runs[lab], n)) for lab in ("other", "this", "this", "other")]
        mean = {lab: float(np.mean([v for l_, v in t if l_ == lab])) for lab in ("other", "this")}
        print(f"{label} device-only ms, turns other/this/this/other {[round(v, 5) for _, v in t]}: "
              f"other {mean['other']:.5f}, this {mean['this']:.5f} "
              f"({mean['other'] / mean['this']:.2f}x) [{smi}]")

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
        for B, sweeps, c2v in ((128, 8, "bfloat16"), (128, 8, None), (24, 16, "bfloat16")):
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
