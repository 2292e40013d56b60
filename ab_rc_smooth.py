#!/usr/bin/env python3
"""Time K5 (`rc_smooth`) of this checkout against the K5 of another checkout
on one NVIDIA GPU.

    python3 ab_rc_smooth.py OTHER_CHECKOUT

OTHER_CHECKOUT holds another version of
`srsran_ce_tpu_torch/csrc/rc_smooth.cu` with the same C entry
(`srs_rc_smooth_f32`), for example the parent commit unpacked by
`git archive`. Both sources are built with this checkout's nvcc flags, at
the same time. At the c2 rows (128, 8, 650) and the time-interpolation rows
(128, 32, 650), with the c2 plan's K = 15 taps, each kernel is held to the
plain version (relative 1e-5), then timed device-only (torch.profiler's
CUDA kernel time over 200 calls, over 200) in turns other / this / this /
other. Prints the card's `nvidia-smi` name and power limit beside the
numbers. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def main(argv) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_rc_smooth: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from srsran_ce_tpu_torch.models.plan import make_plan
    from srsran_ce_tpu_torch.ops.kernels import _build, bind, launch
    from srsran_ce_tpu_torch.ops.kernels import rc_smooth as k5
    from srsran_ce_tpu_torch.utils import synthetic

    other_src = Path(argv[0]).resolve() / "srsran_ce_tpu_torch" / "csrc" / "rc_smooth.cu"
    other_so = _build.BUILD_DIR / "librc_smooth_other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(other_so),
                             str(other_src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    _build.build_all(("rc_smooth",))
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {other_src}:\n{log}")
    other = ctypes.CDLL(str(other_so)).srs_rc_smooth_f32
    other.argtypes = k5._ARGTYPES
    other.restype = ctypes.c_int
    this = bind("rc_smooth", "srs_rc_smooth_f32", k5._ARGTYPES)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    case = synthetic.make_case(seed=11, n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0)
    hp = make_plan(case.hop1, case.hop2, case.config, 4).hop1
    taps, n_ext = hp.rc_taps, hp.n_re + 2 * hp.n_pils
    tab = k5.taps_struct(taps)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)

    def device_ms(fn, n=200):
        for _ in range(5):
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

    for C in (8, 32):
        x = torch.as_tensor(rng.standard_normal((128, C, n_ext)), dtype=torch.float32, device=dev)
        out = torch.empty((128, C, n_ext - tab.k + 1), dtype=torch.float32, device=dev)
        want = k5.rc_smooth_plain(x, taps)
        runs = {}
        for label, fn in (("other", other), ("this", this)):
            runs[label] = (lambda fn=fn: launch("rc_smooth", fn, dev, x.data_ptr(), out.data_ptr(),
                                                128 * C, n_ext, tab))
            out.zero_()
            runs[label]()
            torch.cuda.synchronize()
            err = float((out.double() - want.double()).abs().max() / want.double().abs().max())
            if not err <= 1e-5:
                raise SystemExit(f"{label} K5 at (128, {C}, {n_ext}): relative error {err:.3e}")
            print(f"K5 {label} at (128, {C}, {n_ext}), K={tab.k}: rel err vs plain {err:.2e}")
        turns = [(label, device_ms(runs[label])) for label in ("other", "this", "this", "other")]
        mean = {lab: np.mean([t for l_, t in turns if l_ == lab]) for lab in ("other", "this")}
        print(f"K5 (128, {C}, {n_ext}) device-only ms, turns other/this/this/other "
              f"{[round(t, 5) for _, t in turns]}: other {mean['other']:.5f}, this "
              f"{mean['this']:.5f} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
