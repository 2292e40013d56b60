#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more, any failure ends the run with a non-zero exit code:
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: nvcc builds every kernel from srsran_ce_tpu_torch/csrc/, all at once;
     each instantiation's registers and static shared memory are printed, and
     ptxas must report no spills for any K1, K2, K6, K5, K7, K4 or K3
     instantiation; K1's, K2's and K6's launch plans at c2, c4 / c2, nL=3, c3
     / c2, nL=3, c3, the c4 second hop, nL=8, each held to the kernel's own
     plan, and K1's cluster capacities;
  3. K1 (fused front) against its plain PyTorch version at c2 shapes, B=128;
  4. K2 (serve fill) against its plain version, equal and unequal CDM groups;
  5. `build_ri(..., batched=True, out_layout="serve", kernels="pallas_front")`
     at c2 (106 PRB x 4 layers, batch 128, matmul_precision="high") against
     the float64 oracle, with each kernel's launch count of that run; then the
     factored layout against the serve grid;
  6. the two-hop c4 geometry (24 PRB, 1 layer) at batch 256, same checks;
  7. times with CUDA events: K1 and K2 against their plain versions, and the
     whole pallas_front call, at c2 batch 128, with the call's device busy
     time, idle share and heaviest device operations (torch.profiler);
  8. K5 (rc_smooth) against its plain version at the c2 rows (B=128, C=8,
     n_ext=650) and at the time-interpolation row count (C=2*nL*n_dsym);
  9. K6 (fused_fill_rotate) against its plain version: c2 equal CDM groups,
     nL=3 unequal groups, the c3 inpainting operator (1638 x 3276) as W, nL=8
     (groups (0,4),(4,8)), the c4 second hop written at (336, 7) into its
     (624, 14) grid, and a block written into its slice of a larger grid,
     the rest of each grid untouched;
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
     xla/serve, with the pallas/ref and pallas/serve calls' device busy
     time, idle share and heaviest device operations (torch.profiler);
 16. K4 (ldpc_posterior) against its plain version at the JAX bench's decode
     rows (array_code(6,16,61) B=512, NR BG2 Z=208 and BG1 Z=52 at B=128),
     flooding and layered at the row's default layered_group: bit-identical
     (the plain flooding is the "xla" tier), payload-exact, with each launch
     plan (route, codewords a block, dynamic shared memory);
 17. K3 (ldpc_stream_posterior) against its plain version at NR BG1 Z=384
     (n = 26112), B=128, 8 layered sweeps, float32 and bfloat16 messages, and
     at the e2e decode shape (B=24, 16 sweeps, bfloat16): bit-identical
     (int32 views), payload-exact;
 18. `ops.ldpc.build_decoder(kernels="auto")` on the card for the bench's
     five decode rows: the tier taken, K3/K4 launches of one call (counts set
     to 0 just before it), payload-exactness, ms per batch;
 19. a coded-transport round trip at BG1 Z=384: CRC24B, NR rate matching at
     rate 1/2 onto a 273-PRB single-hop QPSK grid, Gaussian LLRs at 3.5 dB,
     extract_streams, the auto decoder (K3, bfloat16 messages), every CRC ok;
 20. times with CUDA events: K3 and K4 against their plain versions at the
     rows above (K3 also at the e2e shape), with their device-only times
     from the profiler, K1's and K2's device-only times beside their cold-L2
     events, K5's one-call PyTorch counterpart (F.conv1d), K5 and
     F.conv1d three ways (cold-L2 events, device-only kernel time from the
     profiler, host us per call), K2's and K6's one-call yardstick (one
     torch.einsum over the ri operands, held to the plain version at
     relative 1e-5), K6's and the einsums' device-only times beside their
     cold-L2 events, every kernel's bound (the larger of its bytes over
     3.35 TB/s and its float32 operations over 67 TFLOP/s), and at the A/B
     script's other shapes (K1 at c4; K2 and K6 at nL=3 and the c3
     operator; K6 at the c4 second hop) kernel, plain, bound and einsum;
 21. K7 (inpaint_stack) against its plain version at the JAX test's shapes
     (n, comb) = (48, 2) and (96, 4), the estimator's chain regime (11 PRB,
     nL=4, B=128), c3 width (n=3276, 409 iterations, B=16; and at row
     counts more than the SMs), every route boundary of its route table,
     n = 3, an odd n and an all-known row:
     bit-identical (torch.equal); then its own entry once at c3 with the
     count set to 0 (no estimator path reaches K7, in the JAX package
     neither);
 22. the receiver `build_receiver_ri` at the bench's c2_receiver_4rx4l width
     (106 PRB, 4 RX x 4 layers, batch 128, make_mimo_case inputs), modes
     auto (factored) and dense, kernels "xla" and "pallas" with K5/K2 launch
     counts, against the port's float64 CPU run of the first 4 problems
     (x NMSE <= 1e-9, SINR max |error| / max |SINR| <= 1e-4); the 256QAM LLR
     row (int8 planes within one step on <= 0.1 %); a 30 dB QPSK link's
     (4 RX x 2 layers) hard-decision BER on the scored REs: 0;
 23. `serving.process` over heterogeneous lists on the card, every output
     ("grid", "factored", "equalized", "llrs") against single calls of the
     port's build functions; tail padding through one receiver per signature;
 24. the e2e decoded row (bench.py:1075-1120): 273 PRB QPSK slots carrying
     CRC24B, NR-rate-matched BG1 Z=384 words at 15 dB through
     `process(out="decoded", batch_size=8)` on the host path and with
     decode_on_device=True, 8 and 24 slots: every word ok and payload-exact,
     both paths identical, K3 launched in every decode call;
 25. times: K7 (kernel, plain, bound, and its one-call counterpart, the
     operator matmul; K7 and the matmul at c3 and in the chain regime three
     ways, as in phase 20), the receiver's ms per batch (CUDA events, both
     modes, both tiers), the e2e ms per slot (host wall clock over the 8 ->
     24 slot slope, both paths, with the CRC as the bit-serial register
     that the port ran before and as the port's byte table, the two taking
     turns call by call), the CRC's share of one device-path call (cProfile,
     both forms) and the
     functions with the most own time, K7's ns per pass at c3 width (one
     block a row), and the device busy time and idle share of one e2e
     device-path call with K3's share of the busy time (torch.profiler);
 26. tracked serve (`models.tracking.build_tracked_ri`, the plain tier) at c2
     and at the bench's q_tracked_52prb_2l (52 PRB x 2 layers), B=128: slot 0
     against the plain build_ri serve (NMSE <= 1e-9, bench.py's
     _gate_tracked bound, w = 1), no kernel launched; eight soundings of a
     static channel at 0 dB, the channel NMSE against the truth falling
     (slope < 0, the last sounding 4 dB below the first); a slot's time
     (CUDA events, wall) and idle share;
 27. the tracked receiver at c2_receiver_4rx4l (4 RX x 4 layers, B=128, QPSK
     LLRs): slot 0 against the plain factored receiver (LLRs within one
     step on <= 0.1 %, SINR relative 1e-5); four static soundings at 0 dB,
     the post-MMSE SINR measured on the equalized symbols against the sent
     ones growing; time and idle share;
 28. `serving.TrackedServer` on the card against the same calls on the CPU
     (float32): 3 streams, 4 soundings, a mode switch that resets;
 29. learned serve at c2 with the shipped 1-D checkpoint (`denoiser.
     load_shipped`), xla/serve, pallas/serve (K2 launched) and pallas/ref
     (K6 launched), against the port's float64 CPU run of the first four
     problems (NMSE <= 1e-9); times and idle shares;
 30. learned2d at the bench's q_learned2d_52prb (52 PRB x 2 layers,
     time_interp="linear", Doppler 300 Hz, the shipped 2-D checkpoint) on
     both tiers, the same checks;
 31. `serving.process(out="grid", params=...)` against single build_ri calls;
 32. `cli train` at its defaults (1-D, batch 256, n_re 128, 500 steps,
     cosine lr) on the card: its first 5 steps against the CPU's (loss
     relative 1e-4, params within 5 x 2 lr), the last logged loss below the
     first, ms a step (CUDA events, batch on the card), device busy time and
     the forward + backward bound; the multi-geometry cycle (24, 128, 1638);
     `cli train --model 2d` at batch 128, n_re 128, n_dsym 4, the same
     checks; a save -> `--resume` (the Adam count goes on);
 33. `cli quality --device cuda --cases 2` with the shipped checkpoints:
     every table printed, learned below filter at 0 dB, tracked 8 slots
     below single slot, its wall time;
 34. `selftest --deep --device cuda` at geometry 20, coded 9, header 120, sp 0 (each
     cut printed): all pass, the geometry NMSE max, K4's launches over the
     run (counts set to 0 just before) and over each decode path;
 35. `validate --debug-case` on a synthesized suite whose golden carries an
     injected 0.8 at 37 degrees gain: the gain recovered;
 36. the native batch packer (`srsran_ce_tpu_torch/native`, g++): it must
     build; the c2 B=128 chunk packed by it equal to numpy's (np.array_equal),
     the serve grid merged equal; the host's ms a chunk, numpy branch against
     native, and packed + staged to the card before (numpy + a fresh pinned
     copy) and after (native into a pinned buffer); a `serving.process` run
     must count native packs and merges;
 37. one CUDA graph per builder call (`graphs.py`): for pallas_front/serve
     c2, pallas/ref c2 and c4 (two hops, B=256), pallas/serve c2, xla/serve
     and xla/ref c2, learned c2 pallas/serve, tracked serve c2 (3 slots with
     the state threaded), the receiver at c2_receiver_4rx4l and the e2e
     decoded device path over 8 slots: the replay bit-identical to the eager
     call (torch.equal; payloads and ok for the e2e path), the kernels of one
     replay (torch.profiler, by name) and the launch counters equal to the
     eager call's, a result held across the next call unchanged, and wall
     (back to back), CUDA-event ms, device busy and idle share before
     (eager) and after (graphed); the time of a replay's output clone; the
     cuDNN kernels frozen into the learned call's graph;
 38. `serving.process` on the card, graphed against eager (`graphs.eager()`):
     each route called once (each key's first call is eager), then again with
     every graphed call a replay: grid, factored and decoded (host and device
     paths) bit-identical field by field, the scalars included;
 39. `cli diagnose --device cuda`, per problem and `--batched --kernels
     pallas_front`: exit 0, graph_count: 1 for each call, replays
     bit-identical;
 40. a traffic mix through `serving.process`: 11 signatures, a Zipf share
     each, 1-48 requests a call, so bucket sizes vary; its wall graphed
     against eager over the same calls, in turn, three times each; the
     share of graphed calls that replayed a kept graph, and the captures.
 41. the sharded paths (`srsran_ce_tpu_torch/parallel/`) over NCCL at world
     size 1 in this process (`parallel.mesh.multihost_initialize` on a free
     localhost port), float32 on the card: build_dp_batched at c2 B=128 (ref
     and factored), build_dp_receiver at c2_receiver_4rx4l B=128 with 16QAM
     LLRs, build_dp_decoder at the e2e decode shape (BG1 Z=384, layered,
     bfloat16, B=24: K3) and n976 B=512 (K4), build_sp_batched at BASELINE
     config[4] (c4_hopped_24prb, B=4096) and sp_wideband_273prb (B=2),
     build_sp at 273 PRB, the factored SP layout at c2, build_sp_receiver
     (c2_receiver_4rx4l, QPSK, B=16), build_sp_tracked (c2, 3 slots), the
     data-parallel training step and `entry.dryrun_body`: each against the
     unsharded port on the same card and dtype (bit-identical where the
     sharded body is the unsharded code: the DP builders and the hopped
     route; relative 1e-4 otherwise, LLRs within one step on <= 0.1 %),
     the float64 oracle (NMSE < 1e-12), its graphed replay against eager
     bit for bit, ms a call beside the unsharded builder's; the DP decoder's
     K3 / K4 launches of one call (counts set to 0 just before it), added to
     the kernels line;
 42. spawned gloo worlds of 2 and 4 ranks, every rank on cuda:0 (NCCL
     refuses two ranks on one card; gloo's send/recv take no CUDA tensor,
     so the halos go by all_gather), eagerly: build_sp at 273 PRB (padded
     over 4 shards) in float64 (relative 1e-12 against the unsharded
     float64 port, NMSE < 1e-18 against the oracle) and float32 (NMSE
     < 1e-12), config[4] at B=4096 on a (2, 2) and a (1, 2) mesh, the
     hopped route in float64, DP c2, the DP decoder (K4 and K3) and the
     dry run, with ms a call beside the unsharded builder's;
 43. all_device_barrier and Heartbeat over NCCL and gloo, and
     `selftest --deep --sp-n 6` (the sharded deep-fuzz sweep, a spawned
     world per shard count) on the card: 6/6 pass;
 44. `cli bench --device cuda` whole (`srsran_ce_tpu_torch/bench/
     throughput.py`, bench.py's rows at their widths): exit 0, every row of
     bench.py's list present with no error (every gate passed), the headline
     JSON parsed, K1, K2, K4 and K3 launched during the run (counts set to 0
     just before it; K5 is on no bench row: bench.py's `_pallas` row takes
     the deferred route, whose front is the plain tier), each row's numbers
     printed with the card;
 45. `cli scaling --device cuda` (NCCL worlds of up to the card count, a
     world of 1 on one card): exit 0, the dp, sp and config[4] rows of every
     world run present, the world sizes not run named in the report.
Then one JSON line of per-kernel results, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import cProfile
import contextlib
import dataclasses
import io
import json
import pstats
import re
import shutil
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


def _crc_bits_serial(bits, kind):
    """The CRC as a bit-serial register over the message, as the port computed
    it before its byte table (and as the JAX package does): phase 25's
    "before" of the e2e slopes and of the CRC's share of a device-path call."""
    from srsran_ce_tpu_torch.transport import _CRC_POLYS

    deg, poly = _CRC_POLYS[kind]
    b = np.asarray(bits, np.uint8)
    lead = b.shape[:-1]
    b = b.reshape(-1, b.shape[-1])
    reg = np.zeros(b.shape[0], np.uint64)
    gen, top = np.uint64(poly), np.uint64(1) << np.uint64(deg - 1)
    mask = (np.uint64(1) << np.uint64(deg)) - np.uint64(1)
    for j in range(b.shape[1]):
        fb = ((reg & top) != 0).astype(np.uint64) ^ b[:, j].astype(np.uint64)
        reg = ((reg << np.uint64(1)) & mask) ^ (fb * gen)
    out = np.empty(b.shape[:1] + (deg,), np.uint8)
    for i in range(deg):
        out[:, i] = ((reg >> np.uint64(deg - 1 - i)) & np.uint64(1)).astype(np.uint8)
    return out.reshape(lead + (deg,))


def ptxas_kernels(log):
    """(kernel, registers, static shared memory bytes, spill line) of each
    entry function in an nvcc -Xptxas -v report, names demangled by c++filt."""
    rows, name, regs, smem = [], None, None, 0
    spill = ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, regs, smem, spill = m.group(1), None, 0, ""
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            smem = int(sm.group(1)) if sm else 0
            rows.append([name, regs, smem, spill])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, nm in zip(rows, names):
                r[0] = nm
    return rows


def check_rtol(name, got, want, rtol, atol=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    if bad.any():
        i = int(np.argmax(bad))
        fail(f"{name}: {got.flat[i]!r} vs {want.flat[i]!r} (rtol {rtol}, atol {atol})")


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from srsran_ce_tpu_torch import transport
    from srsran_ce_tpu_torch.models import estimator
    from srsran_ce_tpu_torch.models.plan import make_plan, plan_tensors
    from srsran_ce_tpu_torch.ops.kernels import _build
    from srsran_ce_tpu_torch.ops.kernels import fill_rotate as k6
    from srsran_ce_tpu_torch.ops.kernels import fill_rotate_serve as k2
    from srsran_ce_tpu_torch.ops.kernels import front as k1
    from srsran_ce_tpu_torch.ops import ldpc, nr_ldpc
    from srsran_ce_tpu_torch.ops.kernels import ldpc as k4
    from srsran_ce_tpu_torch.ops.kernels import ldpc_stream as k3
    from srsran_ce_tpu_torch.ops.kernels import inpaint as k7
    from srsran_ce_tpu_torch.ops.kernels import rc_smooth as k5
    from srsran_ce_tpu_torch import serving
    from srsran_ce_tpu_torch.models import receiver
    from srsran_ce_tpu_torch.ops import demap, dsp
    from srsran_ce_tpu_torch.utils import oracle, synthetic
    from srsran_ce_tpu_torch.validation import cli, conformance, synth_vectors

    kmods = {"fused_front": k1, "fused_fill_rotate_serve": k2, "rc_smooth": k5,
             "fused_fill_rotate": k6, "ldpc_posterior": k4, "ldpc_stream_posterior": k3,
             "inpaint_stack": k7}

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
    # every kernel keeps every instantiation in registers: a library built
    # before this run left no ptxas report here, so it is rebuilt to give one
    checked = _build.SOURCES
    unlogged = [src for src in checked if src not in _build.build_logs]
    if unlogged:
        _build.build_all(unlogged, force=True)
        print(f"phase 2 build: rebuilt {unlogged} for their ptxas reports")
    for src, log in _build.build_logs.items():
        for kern, regs, smem_s, spill in ptxas_kernels(log):
            print(f"  ptxas {src}: {kern}: {regs} registers, {smem_s} B static smem, {spill}")
    for src in checked:
        log = _build.build_logs.get(src)
        if not log or "registers" not in log:
            fail(f"no ptxas report for {src}")
        spills = [ln.strip() for ln in log.splitlines()
                  if any(int(b) for b in re.findall(r"(\d+) bytes spill", ln))]
        if spills:
            fail(f"ptxas spills in {src}: {spills}")
    print("phase 2 ptxas: no spills in any front (K1), fill_rotate_serve (K2), fill_rotate (K6), "
          "rc_smooth (K5), inpaint (K7), ldpc (K4) or ldpc_stream (K3) instantiation (this run's "
          "ptxas reports read)")
    # K1's, K2's and K6's launch plans at the shapes the main path gives them,
    # each held to the kernel's own (srs_front_plan, srs_fill_rotate_serve_plan,
    # srs_fill_rotate_plan)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    caps = k1.kernel_caps(dev)
    print(f"phase 2 K1 cluster capacity (clusters of 1..8 blocks resident at once): {list(caps)}")
    for label, B_, n_re_, nL_, np_, hcp_, kta_ in (("c2", 128, 636, 4, 7, 144, 636),
                                                    ("c4", 256, 144, 1, 7, 144, 144)):
        lp = k1.launch_plan(B_, n_re_, nL_, np_, hcp_, kta_, caps)
        if k1.kernel_plan(B_, n_re_, nL_, np_, hcp_, kta_, caps) != lp:
            fail(f"K1 launch_plan differs from the kernel's plan at {label}: {lp}")
        print(f"phase 2 K1 plan {label} B={B_}: {lp.P} problems x {lp.S} blocks a cluster, "
              f"{lp.blocks} blocks, Mpad {lp.Mpad}, RN {lp.RN}, K tile {lp.KT}, {lp.NS} columns / "
              f"{lp.TS} bins a block, {lp.smem} B shared memory (as the kernel's own plan)")
    for label, B_, nL_, slices, n_re_, n_sc_ in (
            ("c2", 128, 4, ((0, 2), (2, 4)), 636, 1272), ("nL=3", 128, 3, ((0, 2), (2, 3)), 636, 1272),
            ("c3", 16, 1, ((0, 1),), 1638, 3276)):
        chunks = k2.chunks_of(slices, nL_, len(slices))
        lp = k2.launch_plan(B_, chunks, n_re_, n_sc_, n_sm)
        if k2.kernel_plan(B_, nL_, chunks, n_re_, n_sc_, n_sm) != lp:
            fail(f"K2 launch_plan differs from the kernel's plan at {label}: {lp}")
        print(f"phase 2 K2 plan {label} B={B_}: {lp.tiles} tiles, {lp.KS} blocks a tile, "
              f"{lp.clusters} persistent clusters, {lp.blocks} blocks, {lp.smem} B shared memory "
              "(as the kernel's own plan)")
    for label, B_, nL_, slices, n_re_, n_sc_, n_sym_ in (
            ("c2", 128, 4, ((0, 2), (2, 4)), 636, 1272, 14),
            ("nL=3", 128, 3, ((0, 2), (2, 3)), 636, 1272, 14),
            ("c3", 16, 1, ((0, 1),), 1638, 3276, 14), ("c4 second hop", 256, 1, ((0, 1),), 144, 288, 7),
            ("nL=8", 128, 8, ((0, 4), (4, 8)), 636, 1272, 14)):
        chunks = k6.fill_chunks(slices, nL_, len(slices))
        lp = k6.launch_plan(B_, nL_, chunks, n_re_, n_sc_, n_sym_, n_sm)
        if k6.kernel_plan(B_, nL_, chunks, n_re_, n_sc_, n_sym_, n_sm) != lp:
            fail(f"K6 launch_plan differs from the kernel's plan at {label}: {lp}")
        print(f"phase 2 K6 plan {label} B={B_}: {lp.P} problems a tile, {lp.tiles} tiles, {lp.KS} "
              f"blocks a tile, {lp.clusters} persistent clusters, {lp.blocks} blocks, {lp.smem} B "
              "shared memory (as the kernel's own plan)")

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
    f4_args, f4_kw = front_inputs(*tiled(C4, 256)[:4], 256, seed=102)[2:]
    for label, args, kw in (("c2", f_args, f_kw), ("c4", f4_args, f4_kw)):
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

    def kernel_ms(fn, n=50, activities=(ProfilerActivity.CUDA,)):
        """ms a call of each device kernel, by name: torch.profiler over n calls
        after a warm-up; {} when no session recorded one (a session now and
        then records no kernel: up to three are taken). A user annotation's
        device range (torch.optim's "Optimizer.step#...") spans kernels
        already counted, so it is left out."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=list(activities)) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            ms = {e.key: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                  / n / 1e3 for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}
            if sum(ms.values()) > 0:
                return ms
        return {}

    def device_ms(fn, n=50):
        """Device-only ms of one call: the profiler's CUDA kernel time over n
        calls, over n (no host time, whatever the L2 holds)."""
        ms = kernel_ms(fn, n)
        if not ms:
            fail("the profiler saw no device time in 3 sessions")
        return sum(ms.values())

    def host_us(fn, n=1000):
        """Host us per call: perf_counter over n calls without a synchronise
        (the synchronise after them is not timed)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    def three(fn, iters=20):
        """(cold-L2 event ms, device-only ms, host us per call) of one call."""
        return time_ms(fn, iters), device_ms(fn), host_us(fn)

    def print_three(phase, label, t):
        print(f"phase {phase} {label}: cold-L2 events {t[0]:.4f} ms, device-only {t[1]:.4f} ms, "
              f"host {t[2]:.2f} us/call {card}")

    def ab(kernel, plain, iters=20):
        p1, k1_, k2_, p2 = (time_ms(plain, iters), time_ms(kernel, iters), time_ms(kernel, iters),
                            time_ms(plain, iters))
        return (k1_ + k2_) / 2, (p1 + p2) / 2, (p1, k1_, k2_, p2), time_ms(kernel, iters, cold=False)

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
    def print_busy(phase, label, fn, args, wall, n=20):
        """A call's device busy time and idle share (torch.profiler over n
        calls, against its unprofiled back-to-back wall time), with the device
        time of its heaviest operations; `label` names the call and its shape."""
        dev_ms = kernel_ms(lambda: fn(*args), n, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
        busy = sum(dev_ms.values())
        if busy > 0:
            top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:5]
            print(f"phase {phase} {label}: device busy {busy:.4f} ms of "
                  f"{wall:.4f} ms back-to-back wall, idle share {100 * (1 - busy / wall):.1f} % "
                  f"(torch.profiler, {n} calls); heaviest: " + ", ".join(
                      f"{k[:40]} {ms:.4f} ms" for k, ms in top) + f" {card}")
        else:
            print(f"phase {phase} {label} idle share: not measured (the profiler saw no device time)")

    print_busy(7, "build_ri pallas_front/serve c2 B=128", fn_c2, c2_args, wall)

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
        ("nL=8, groups (0,4),(4,8)", h_of(128, 8, hp.n_re),
         k2_cases[1][2], rot_of(128, 14), ((0, 4), (4, 8))),
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
    # the c4 second hop: 7 symbols of 288 subcarriers at (336, 7) of its (624, 14) grid, B=256
    case4 = synthetic.make_case(seed=SEEDS[0], **C4)
    plan4 = make_plan(case4.hop1, case4.hop2, case4.config, 1)
    hp4, w_c4 = plan4.hop2, plan_tensors(plan4, dev, torch.float32)["hops"][1]["interp"]
    h, rot = h_of(256, 1, hp4.n_re), rot_of(256, hp4.n_alloc_syms)
    grid = torch.full((256, 2, case4.received_rg.shape[0], 14, 1), 7.0, device=dev)
    k6.fused_fill_rotate(h, w_c4, rot, hp4.layer_slices, out=grid, sc_start=hp4.sc_start,
                         sym_start=hp4.sym_start)
    want = torch.full_like(grid, 7.0)
    want[:, :, hp4.sc_start:hp4.sc_start + hp4.n_sc_hop,
         hp4.sym_start:hp4.sym_start + hp4.n_alloc_syms] = \
        k6.fused_fill_rotate_plain(h, w_c4, rot, hp4.layer_slices)
    torch.cuda.synchronize()
    abs_err, err = errs(grid, want)
    if not err <= 1e-5:
        fail(f"K6 c4 second hop into its grid: relative error {err:.3e} > 1e-5")
    k6_c4 = (h, w_c4, rot, hp4.layer_slices, grid, hp4.sc_start, hp4.sym_start)
    print(f"phase 9 K6 c4 second hop (B=256, W {tuple(w_c4.shape[1:])}) into a {tuple(grid.shape[2:4])} "
          f"grid at ({hp4.sc_start}, {hp4.sym_start}): max abs err {abs_err:.3e}, rel err {err:.3e} "
          "(<= 1e-5), outside untouched")

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
        if label != "xla/serve":
            print_busy(15, f"build_ri {label} c2 B=128", fn, args_c2, wall)

    # 16. K4 vs plain at the bench's decode rows (bench.py:792-984): same seed,
    # same words, same SNR; flooding and layered at the row's default G
    def words(code, batch, snr_db, seed=0):
        """(plan, info bits, float32 LLRs on the card) of `batch` encoded words
        through BPSK + AWGN at `snr_db`, made as the JAX bench makes them."""
        plan = ldpc.make_ldpc_plan(code)
        r = np.random.default_rng(seed)
        u = r.integers(0, 2, (batch, plan.k), dtype=np.uint8)
        cw = ldpc.encode(code, u)
        snr = 10.0 ** (snr_db / 10)
        llr = 4 * snr * ((1 - 2.0 * cw) + r.normal(0, np.sqrt(0.5 / snr), cw.shape))
        return plan, u, torch.as_tensor(llr.astype(np.float32), device=dev)

    def payload_exact(post, plan, u):
        """Every word's parity satisfied and its systematic bits equal to `u`."""
        w = k4.wiring(plan, dev)
        bits = (post < 0).to(torch.uint8)
        return bool(ldpc._parity_ok(bits, w).all()) and np.array_equal(
            bits[:, w.info_cols].cpu().numpy(), u)

    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan_text(plan, batch, msg_bytes, layered, group):
        """The K3/K4 launch plan of a call: route, codewords a block, threads, smem."""
        lp = k4.launch_plan(k4.wiring(plan, dev), batch, msg_bytes, layered,
                            min(group, plan.code.n_check_blocks), n_sms)
        return (f"route {lp.route}, {lp.cpb} codeword(s) a block, {lp.blocks} blocks of "
                f"{lp.threads} threads, {lp.smem} B dynamic smem (<= {k4.SMEM_LIMIT})"
                + (f", {lp.scratch} B of records per codeword in L2" if lp.scratch else ""))

    def ldpc_ops(plan, batch, iters, schedule):
        """float32 operations of min-sum on these words: per edge lane and sweep,
        flooding 8 (the posterior add; v = L - c2v, |v|, its sign, the two-min
        compare and min; norm * m, the sign) plus the final posterior add,
        layered 9 (the same 5 + 2, then stored - old and the L update)."""
        lanes = len(plan.edges) * plan.code.z * batch
        return lanes * (8 * iters + 1 if schedule == "flooding" else 9 * iters)

    PEAK_BPS, PEAK_F32 = 3.35e12, 67e12  # H100 SXM: HBM3 bytes/s, float32 FLOP/s outside the tensor cores

    def bound(nbytes, ops):
        """(ms, "bytes" or "operations", bytes ms, operations ms): the least
        time the card could take, the larger of the two."""
        tb, to = nbytes / PEAK_BPS * 1e3, ops / PEAK_F32 * 1e3
        return (tb, "bytes", tb, to) if tb >= to else (to, "operations", tb, to)

    ldpc_rows = (  # name, code, batch, SNR dB, flooding sweeps, layered sweeps
        ("ldpc_decode_n976_b512", ldpc.array_code(6, 16, 61), 512, 4.0, 25, 13),
        ("nr_bg2_z208", nr_ldpc.nr_base_graph(2, 208), 128, 3.5, 16, 8),
        ("nr_bg1_z52", nr_ldpc.nr_base_graph(1, 52), 128, 3.5, 16, 8),
    )
    k4_cfgs = []
    for row, code, batch, snr_db, it_f, it_l in ldpc_rows:
        plan, u, ch = words(code, batch, snr_db)
        g = ldpc.default_layered_group(code)
        for sched, iters, grp in (("flooding", it_f, 1), ("layered", it_l, g)):
            got = k4.ldpc_posterior(ch, plan, iters, 0.75, sched, grp)
            want = k4.ldpc_posterior_plain(ch, plan, iters, 0.75, sched, grp)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K4 {row} {sched}: max abs diff {float((got - want).abs().max()):.3e} vs plain, "
                     "expected bit-identical")
            if not payload_exact(got, plan, u):
                fail(f"K4 {row} {sched}-{iters} G={grp}: not payload-exact")
            label = f"{row} {sched}-{iters} G={grp} B={batch}"
            k4_cfgs.append((label, plan, ch, iters, sched, grp))
            print(f"phase 16 K4 vs plain ({label}, z={code.z}, {len(plan.edges)} edges): "
                  f"bit-identical, payload-exact; {plan_text(plan, batch, 4, sched == 'layered', grp)}")

    # 17. K3 vs plain at the largest NR code block, and at the e2e decode shape
    code384 = nr_ldpc.nr_base_graph(1, 384)
    plan384, u384, ch384 = words(code384, 128, 3.5)
    _, u24w, ch24 = words(code384, 24, 3.5, seed=1)
    k3_err = 0.0
    for ch_, u_, sweeps, c2v in ((ch384, u384, 8, None), (ch384, u384, 8, "bfloat16"),
                                 (ch24, u24w, 16, "bfloat16")):
        got = k3.ldpc_stream_posterior(ch_, plan384, sweeps, 0.75, 1, c2v)
        want = k3.ldpc_stream_posterior_plain(ch_, plan384, sweeps, 0.75, 1, c2v)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"K3 B={ch_.shape[0]} c2v={c2v}: max abs diff {float((got - want).abs().max()):.3e} "
                 "vs plain, expected bit-identical")
        if not payload_exact(got, plan384, u_):
            fail(f"K3 B={ch_.shape[0]} c2v={c2v}: not payload-exact")
        k3_err = max(k3_err, float((got - want).abs().max()))
        print(f"phase 17 K3 vs plain (NR BG1 Z=384 n={code384.n}, B={ch_.shape[0]}, layered-{sweeps} "
              f"G=1, c2v {c2v or 'float32'}): posterior bit-identical (int32 views), payload-exact; "
              f"{plan_text(plan384, ch_.shape[0], 4 if c2v is None else 2, True, 1)}")
    results["ldpc_posterior"] = 0.0
    results["ldpc_stream_posterior"] = k3_err

    # 18. build_decoder(kernels="auto") on the bench's five decode rows
    auto_rows = (  # name, code, batch, SNR dB, decoder arguments, tier, expected (K4, K3) launches
        ("ldpc_decode_n976_b512", ldpc_rows[0][1], 512, 4.0, dict(n_iters=25), "pallas", (1, 0)),
        ("nr_bg2_z208", ldpc_rows[1][1], 128, 3.5, dict(n_iters=16), "pallas", (1, 0)),
        ("nr_bg1_z52", ldpc_rows[2][1], 128, 3.5, dict(n_iters=16), "pallas", (1, 0)),
        ("nr_bg1_z384", code384, 32, 3.5, dict(n_iters=16), "xla_gather", (0, 0)),
        ("nr_bg1_z384_streamed", code384, 128, 3.5,
         dict(n_iters=8, schedule="layered", layered_group=ldpc.default_layered_group(code384),
              stream_c2v_dtype="bfloat16"), "pallas_stream", (0, 1)),
    )
    ldpc_launches = {"ldpc_posterior": 0, "ldpc_stream_posterior": 0}
    for row, code, batch, snr_db, kw, tier, want_n in auto_rows:
        plan, u, ch = words(code, batch, snr_db)
        dec = ldpc.build_decoder(code, kernels="auto", device=dev, **kw)
        if dec.tier != tier:
            fail(f"auto {row}: tier {dec.tier}, the JAX package takes {tier}")
        torch.cuda.synchronize()
        reset_counts()
        res = dec(ch)
        torch.cuda.synchronize()
        cnt = read_counts()
        got_n = (cnt["ldpc_posterior"], cnt["ldpc_stream_posterior"])
        if got_n != want_n or any(cnt[k] for k in kmods if not k.startswith("ldpc")):
            fail(f"auto {row}: launch counts {cnt}, expected (K4, K3) = {want_n}")
        for k in ldpc_launches:
            ldpc_launches[k] += cnt[k]
        if not (bool(res.ok.all()) and np.array_equal(res.info.cpu().numpy(), u)):
            fail(f"auto {row}: not payload-exact")
        ms = time_ms(lambda: dec(ch), iters=5)
        print(f"phase 18 auto {row} ({tier}, {kw}): launches K4 {got_n[0]}, K3 {got_n[1]}, "
              f"payload-exact, {ms:.4f} ms/batch{batch} on CUDA events, cold L2 "
              f"({batch * plan.k / ms / 1e3:.1f} info Mb/s) {card}")

    # 19. coded transport at BG1 Z=384 (bench.py:1075-1095 without the receiver)
    geo = synthetic.make_case(seed=4242, snr_db=15.0, n_prbs=273, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    coding = transport.TransportCoding(
        code=code384, rate_match="nr", tx_bits=2 * 8448, schedule="layered", n_iters=16,
        crc="crc24b", interleave_seed=7, layered_group=ldpc.default_layered_group(code384),
        stream_c2v_dtype="bfloat16")
    nbits = 2
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, nbits)
    k_pay = transport.payload_bits(coding, plan384.k)
    r = np.random.default_rng(4242)
    u = r.integers(0, 2, (lay.c_words, k_pay), dtype=np.uint8)
    tx = transport.place_codewords(lay, ldpc.encode(code384, transport.crc_attach(u, "crc24b")), 1,
                                   nbits, fill_rng=r)
    snr = 10.0 ** 0.35
    llr_grid = (4 * snr * ((1 - 2.0 * tx) + r.normal(0, np.sqrt(0.5 / snr), tx.shape))).astype(np.float32)
    streams = transport.extract_streams(lay, llr_grid)
    dec = ldpc.build_decoder(code384, n_iters=coding.n_iters, norm=coding.norm, kernels=coding.kernels,
                             schedule=coding.schedule, layered_group=coding.layered_group,
                             stream_c2v_dtype=coding.stream_c2v_dtype, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    res = dec(streams)
    torch.cuda.synchronize()
    cnt = read_counts()
    info = res.info.cpu().numpy()
    crc_ok = transport.crc_check(info, "crc24b")
    if cnt["ldpc_stream_posterior"] != 1 or not (crc_ok.all() and bool(res.ok.all())
                                                 and np.array_equal(info[:, :k_pay], u)):
        fail(f"transport round trip: CRC {crc_ok.tolist()}, parity {res.ok.tolist()}, launches {cnt}")
    print(f"phase 19 coded transport BG1 Z=384 ({lay.c_words} words of E={lay.tx_bits} bits on a "
          f"{n_sc}x{n_sym} QPSK grid, tier {dec.tier}): every CRC24B ok, parity ok, payload-exact, "
          f"launches K3 {cnt['ldpc_stream_posterior']}")

    # 20. times and bounds
    # K4 and K3: cold-L2 events against the plain version, device-only beside them
    for label, plan, ch, iters, sched, grp in k4_cfgs:
        fn = lambda: k4.ldpc_posterior(ch, plan, iters, 0.75, sched, grp)
        t = ab(fn, lambda: k4.ldpc_posterior_plain(ch, plan, iters, 0.75, sched, grp), iters=5)
        b_ms, b_by, tb, to = bound(2 * ch.numel() * 4, ldpc_ops(plan, ch.shape[0], iters, sched))
        times.setdefault("ldpc_posterior", t + (b_ms, b_by))
        print(f"phase 20 K4 {label}: kernel {t[0]:.4f} ms, device-only {device_ms(fn, 20):.4f} ms, "
              f"plain {t[1]:.4f} ms, bound {b_ms:.4f} ms ({b_by}; bytes {tb:.4f}, operations "
              f"{to:.4f}), cold L2 {card}")
    for ch_, sweeps, c2v in ((ch384, 8, "bfloat16"), (ch384, 8, None), (ch24, 16, "bfloat16")):
        B_ = ch_.shape[0]
        fn = lambda: k3.ldpc_stream_posterior(ch_, plan384, sweeps, 0.75, 1, c2v)
        t = ab(fn, lambda: k3.ldpc_stream_posterior_plain(ch_, plan384, sweeps, 0.75, 1, c2v),
               iters=5)
        b_ms, b_by, tb, to = bound(2 * ch_.numel() * 4, ldpc_ops(plan384, B_, sweeps, "layered"))
        times.setdefault("ldpc_stream_posterior", t + (b_ms, b_by))
        print(f"phase 20 K3 BG1 Z=384 B={B_} layered-{sweeps} G=1 c2v {c2v or 'float32'}: kernel "
              f"{t[0]:.4f} ms, device-only {device_ms(fn, 20):.4f} ms, plain {t[1]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; bytes {tb:.4f}, operations {to:.4f}), cold L2 {card}")

    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    rx, pil_f, beta_f, mats = f_args
    nL_f = pil_f.shape[2]
    rows_of = {"pair_l": 2, "pair_r": 2, "smooth": 2, "smooth_vb": 2, "smooth_ve": 2, "ta_c": 2,
               "ta_s": 2, "vp": 4}  # rows of each product, in units of nL (vp: 2 fits x 2 ends)
    f_ops = sum(2 * rx.shape[0] * r_ * nL_f * mats[k].numel() for k, r_ in rows_of.items() if k in mats)
    f_ops += 10 * rx.numel()  # the elementwise front, about 10 operations per received value
    dev_only = {}
    B2, nL2, n_re2 = k2_args[0].shape[0], k2_args[0].shape[2], k2_args[0].shape[3]
    n_sc2 = k2_args[1].shape[-1]
    fill_ops = lambda B_, nL_, n_re_, n_sc_: 4 * B_ * nL_ * n_re_ * n_sc_ + 6 * B_ * nL_ * 14 * n_sc_
    B6, nL6, n_re6 = h6.shape[0], h6.shape[2], h6.shape[3]
    M5 = x5.shape[-1] - taps.size + 1
    bounds = {
        "fused_front": bound(nbytes(rx, pil_f, beta_f, *[m for m in mats.values() if torch.is_tensor(m)])
                             + rx.shape[0] * (2 * nL_f * hp.n_re + 8) * 4, f_ops),
        "fused_fill_rotate_serve": bound(nbytes(*k2_args) + B2 * 2 * nL2 * 14 * n_sc2 * 4,
                                         fill_ops(B2, nL2, n_re2, n_sc2)),
        "rc_smooth": bound(nbytes(x5) + x5.shape[0] * x5.shape[1] * M5 * 4,
                           2 * taps.size * x5.shape[0] * x5.shape[1] * M5),
        "fused_fill_rotate": bound(nbytes(h6, w6, r6) + B6 * 2 * w6.shape[-1] * 14 * nL6 * 4,
                                   fill_ops(B6, nL6, n_re6, w6.shape[-1])),
    }
    for k, v in bounds.items():
        times[k] = times[k] + v[:2]
    # K1, K2 and K6 device-only (the profiler's kernel time) beside their cold-L2 events
    for k, fn in (("fused_front", lambda: k1.fused_front(*f_args, **f_kw)),
                  ("fused_fill_rotate_serve",
                   lambda: k2.fused_fill_rotate_serve(*k2_args, layer_slices=hp.layer_slices)),
                  ("fused_fill_rotate", lambda: k6.fused_fill_rotate(h6, w6, r6, s6))):
        dev_only[k] = device_ms(fn)
        print(f"phase 20 {k} c2 B=128: cold-L2 events {times[k][0]:.4f} ms, device-only "
              f"{dev_only[k]:.4f} ms, bound {times[k][4]:.4f} ms ({times[k][5]}) {card}")
    # K5's one-call PyTorch counterpart: a valid cross-correlation with the flipped taps
    w5 = torch.as_tensor(np.ascontiguousarray(taps[::-1]), dtype=torch.float32, device=dev).view(1, 1, -1)
    conv = lambda: torch.nn.functional.conv1d(x5.reshape(-1, 1, x5.shape[-1]), w5)
    lib_out = conv().reshape(x5.shape[0], x5.shape[1], -1)
    _, lib_err = errs(lib_out, k5.rc_smooth_plain(x5, taps))
    if not lib_err <= 1e-5:
        fail(f"F.conv1d vs K5's plain version: relative error {lib_err:.3e}")
    # K5 and F.conv1d side by side: cold-L2 events (host time shows through
    # when the host takes longer than the flush), device-only, host per call
    t_conv = three(conv)
    print_three(20, "K5 rc_smooth c2 rows (128, 8, 650) K=15", three(lambda: k5.rc_smooth(x5, taps)))
    print_three(20, "F.conv1d same rows and taps", t_conv)
    library = {k: None for k in times}
    library["rc_smooth"] = t_conv[0]

    # K2's and K6's one-call yardstick: one einsum over the ri operands, the
    # complex product as a fixed (2, 2, 2) tensor (out c from h a and rot d),
    # the CDM groups equal at c2 so W stacks per group
    cprod = torch.zeros((2, 2, 2), dtype=torch.float32, device=dev)
    cprod[0, 0, 0], cprod[0, 1, 1], cprod[1, 0, 1], cprod[1, 1, 0] = 1.0, -1.0, 1.0, 1.0
    for k, mod, plain, args, spec in (
            ("fused_fill_rotate_serve", k2, k2.fused_fill_rotate_serve_plain, k2_args,
             "cad,baglp,gpt,bdy->bcglyt"),
            ("fused_fill_rotate", k6, k6.fused_fill_rotate_plain, (h6, w6, r6),
             "cad,baglp,gpt,bdy->bctygl")):
        h_, w_, r_ = args
        G = w_.shape[0]
        h_g = h_.reshape(h_.shape[0], 2, G, h_.shape[2] // G, h_.shape[3])
        ein = lambda: torch.einsum(spec, cprod, h_g, w_, r_)
        want = plain(h_, w_, r_, hp.layer_slices)
        got = ein().reshape(want.shape)
        _, e_err = errs(got, want)
        if not e_err <= 1e-5:
            fail(f"einsum vs {k}'s plain version: relative error {e_err:.3e} > 1e-5")
        library[k] = time_ms(ein)
        print(f"phase 20 {k} one-call yardstick torch.einsum('{spec}') c2 B=128: rel err vs plain "
              f"{e_err:.2e}, cold-L2 events {library[k]:.4f} ms (device-only {device_ms(ein):.4f}), "
              f"kernel {times[k][0]:.4f} ms (device-only {dev_only[k]:.4f}) {card}")
    for k in ("fused_front", "fused_fill_rotate_serve", "rc_smooth", "fused_fill_rotate"):
        ms, plain_ms, _, _, b_ms, b_by = times[k]
        print(f"phase 20 {k} c2 B=128: kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; bytes "
              f"{bounds[k][2]:.4f}, operations {bounds[k][3]:.4f}), "
              f"library call {'not one' if library[k] is None else f'{library[k]:.4f} ms'} {card}")

    # The A/B script's other shapes: K1 at c4 (one hop, B=256); K2 and K6 at
    # nL=3 (groups (0,2),(2,3)) and the c3 operator, K6 also at the c4 second
    # hop (written into its grid): kernel (cold-L2 events, device-only), plain
    # (events), bound and, for K2 and K6, one einsum over the ri operands with
    # W taken per layer (W[c(l)], stacked before the timed call; the groups
    # are unequal at nL=3). The einsum returns a strided view, the same
    # memory for either layout.
    h4_k, s4_k = k1.fused_front(*f4_args, **f4_kw)
    rx4, pil4, _, mats4 = f4_args
    f4_ops = sum(2 * rx4.shape[0] * r_ * pil4.shape[2] * mats4[k].numel()
                 for k, r_ in rows_of.items() if k in mats4) + 10 * rx4.numel()
    b4 = bound(nbytes(*f4_args[:3], *[m for m in mats4.values() if torch.is_tensor(m)], h4_k, s4_k),
               f4_ops)
    t4 = ab(lambda: k1.fused_front(*f4_args, **f4_kw), lambda: k1.fused_front_plain(*f4_args, **f4_kw))
    print(f"phase 20 fused_front c4 B=256 (one hop): kernel {t4[0]:.4f} ms, device-only "
          f"{device_ms(lambda: k1.fused_front(*f4_args, **f4_kw)):.4f} ms, plain {t4[1]:.4f} ms, "
          f"bound {b4[0]:.4f} ms ({b4[1]}; bytes {b4[2]:.4f}, operations {b4[3]:.4f}) {card}")
    for label, (h_, w_, r_, sl_), grid_at in (
            ("nL=3 B=128", k6_cases[1][1:], None), ("c3 operator B=16", k6_cases[2][1:], None),
            ("c4 second hop B=256", k6_c4[:4], k6_c4[4:])):
        B_, nL_, n_re_ = h_.shape[0], h_.shape[2], h_.shape[3]
        n_sc_, n_sym_ = w_.shape[-1], r_.shape[-1]
        w_l = w_[[c for c, (l0, l1) in enumerate(sl_) for _ in range(l0, l1)]].contiguous()
        for k, mod, plain, run, spec in (
                ("fused_fill_rotate_serve", k2, k2.fused_fill_rotate_serve_plain,
                 lambda: k2.fused_fill_rotate_serve(h_, w_, r_, sl_), "bclyt"),
                ("fused_fill_rotate", k6, k6.fused_fill_rotate_plain,
                 (lambda: k6.fused_fill_rotate(h_, w_, r_, sl_)) if grid_at is None else
                 (lambda: k6.fused_fill_rotate(h_, w_, r_, sl_, out=grid_at[0],
                                               sc_start=grid_at[1], sym_start=grid_at[2])),
                 "bctyl")):
            if grid_at is not None and mod is k2:
                continue  # the c4 row is K6's
            ein = lambda: torch.einsum(f"cad,balp,lpt,bdy->{spec}", cprod, h_, w_l, r_)
            want = plain(h_, w_, r_, sl_)
            _, e_err = errs(ein(), want)
            if not e_err <= 1e-5:
                fail(f"einsum vs {k}'s plain version at {label}: relative error {e_err:.3e} > 1e-5")
            b_ = bound(nbytes(h_, w_, r_) + B_ * 2 * nL_ * n_sym_ * n_sc_ * 4,
                       4 * B_ * nL_ * n_re_ * n_sc_ + 6 * B_ * nL_ * n_sym_ * n_sc_)
            t_ = ab(run, lambda: plain(h_, w_, r_, sl_))
            print(f"phase 20 {k} {label}: kernel {t_[0]:.4f} ms, device-only {device_ms(run):.4f} ms, "
                  f"plain {t_[1]:.4f} ms, bound {b_[0]:.4f} ms ({b_[1]}; bytes {b_[2]:.4f}, operations "
                  f"{b_[3]:.4f}), torch.einsum cold-L2 events {time_ms(ein):.4f} ms, device-only "
                  f"{device_ms(ein):.4f} ms (rel err vs plain {e_err:.2e}) {card}")

    # 21. K7 vs plain at the JAX test's shapes, the chain regime and c3 width
    def k7_inputs(B, C, n, comb, seed):
        known = np.zeros(n, dtype=bool)
        known[::comb] = True
        x = np.where(known, np.random.default_rng(seed).standard_normal((B, C, n)), 0.0)
        return known, torch.as_tensor(x, dtype=torch.float32, device=dev)

    k7_shapes = (  # label, B, C = 2 nL, n, comb, iterations (max(6, n // 8), plan.py:323)
        ("JAX test (48, comb 2)", 2, 4, 48, 2, 6),
        ("JAX test (96, comb 4)", 2, 4, 96, 4, 12),
        ("chain regime 11 PRB nL=4 B=128", 128, 8, 132, 2, 16),
        ("c3 273 PRB nL=1 B=16", 16, 2, 3276, 2, 409),
    )
    k7_err = 0.0
    for i, (label, B, C, n, comb, iters) in enumerate(k7_shapes):
        known, x = k7_inputs(B, C, n, comb, seed=210 + i)
        got = k7.inpaint_stack(x, known, iters)
        want = k7.inpaint_stack_plain(x, known, iters)
        torch.cuda.synchronize()
        abs_err, err = errs(got, want)
        if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
            fail(f"K7 {label}: not bit-identical to plain (max abs err {abs_err:.3e}) or not finite")
        k7_err = max(k7_err, abs_err)
        print(f"phase 21 K7 vs plain ({label}, x {tuple(x.shape)}, {iters} iterations, route "
              f"{k7.ROUTES[k7.route_for(n)]}): bit-identical (torch.equal)")
    k7_c3 = (x, known, iters)
    # c3 width at more rows than the SMs
    rows = n_sms + 8
    known, x = k7_inputs(rows // 2, 2, 3276, 2, seed=rows)
    got = k7.inpaint_stack(x, known, 409)
    want = k7.inpaint_stack_plain(x, known, 409)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"K7 c3 width, {rows} rows: max abs err {float((got - want).abs().max()):.3e} vs plain")
    print(f"phase 21 K7 vs plain (c3 width, {rows} rows): bit-identical (torch.equal)")
    # every route boundary (the last n a route holds and the first it hands
    # on), n = 3, an odd n, and a row with every position known
    edge_ns = sorted({c + d for r in range(len(k7.ROUTES)) for d in (0, 1)
                      for c in (k7.capacity(r),) if c + d <= k7.MAX_N} | {3, 1001})
    for i, n in enumerate(edge_ns):
        known, x = k7_inputs(2, 2, n, 2 + i % 3, seed=230 + i)
        got = k7.inpaint_stack(x, known, max(6, n // 8))
        want = k7.inpaint_stack_plain(x, known, max(6, n // 8))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K7 n={n}: max abs err {float((got - want).abs().max()):.3e} vs plain")
        k7_err = max(k7_err, errs(got, want)[0])
    x = torch.as_tensor(np.random.default_rng(229).standard_normal((2, 4, 48)), dtype=torch.float32,
                        device=dev)
    if not torch.equal(k7.inpaint_stack(x, np.ones(48, bool), 6), x):
        fail("K7 with every position known: the row is not returned as it was")
    results["inpaint_stack"] = k7_err
    print(f"phase 21 K7 vs plain at n = {edge_ns} (combs 2-4, max(6, n // 8) iterations) and an "
          "all-known row: bit-identical (torch.equal)")
    reset_counts()
    k7.inpaint_stack(*k7_c3)
    torch.cuda.synchronize()
    k7_launches = read_counts()["inpaint_stack"]
    if k7_launches != 1:
        fail(f"K7 entry at c3: {k7_launches} launches, expected 1")
    print(f"phase 21 K7 entry `ops.kernels.inpaint.inpaint_stack` at c3: launches {k7_launches}")

    # 22. the receiver at the bench's c2_receiver_4rx4l width
    C2_RX = dict(n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0)
    B_RX, N_RX = 128, 4

    def mimo_batch(modulation, batch, seeds=SEEDS, **kw):
        """(cases, config at "high", rg, pil, beta on the card) of make_mimo_case
        links tiled to the batch."""
        cases = [synthetic.make_mimo_case(seed=s, n_rx=N_RX, modulation=modulation, **kw)
                 for s in seeds]
        cfg = dataclasses.replace(cases[0].config, matmul_precision="high")
        rg = np.stack([estimator.split_ri(c.received_rg) for c in cases])
        pil = np.stack([estimator.split_ri(c.pilots) for c in cases])
        idx = np.arange(batch) % len(cases)
        t32 = lambda a: torch.as_tensor(a[idx], dtype=torch.float32, device=dev)
        return cases, cfg, t32(rg), t32(pil), torch.ones(batch, dtype=torch.float32, device=dev)

    rx_cases, rx_cfg, rx_rg, rx_pil, rx_beta = mimo_batch("256qam", B_RX, **C2_RX)
    c0 = rx_cases[0]
    n_ref = len(rx_cases)
    ref_args = tuple(a[:n_ref].double().cpu() for a in (rx_rg, rx_pil, rx_beta))
    rx_fns = {}
    for mode, kern in (("auto", "xla"), ("dense", "xla"), ("auto", "pallas"), ("dense", "pallas")):
        fn = receiver.build_receiver_ri(c0.hop1, c0.hop2, rx_cfg, 4, N_RX, batched=True, mode=mode,
                                        kernels=kern, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        res = fn(rx_rg, rx_pil, rx_beta)
        torch.cuda.synchronize()
        cnt = read_counts()
        if kern == "xla":
            need(f"receiver {mode}/{kern}", cnt, idle=tuple(kmods))
        else:
            need(f"receiver {mode}/{kern}", cnt, launched=("rc_smooth",) + (
                ("fused_fill_rotate_serve",) if mode == "dense" else ()),
                 idle=("fused_front", "fused_fill_rotate") + (
                ("fused_fill_rotate_serve",) if mode == "auto" else ()))
        want = fn(*ref_args)  # the same receiver on CPU float64 tensors: the plain tier
        x = res.x[:n_ref].double().cpu()
        if tuple(res.x.shape) != (B_RX, 2, 4, 14, c0.received_rg.shape[1]) or not bool(
                torch.isfinite(res.x).all()):
            fail(f"receiver {mode}/{kern}: x {tuple(res.x.shape)} not finite or wrong shape")
        nmse = ((x - want.x) ** 2).sum(dim=(1, 2, 3, 4)) / (want.x**2).sum(dim=(1, 2, 3, 4))
        _, s_err = errs(res.sinr[:n_ref].cpu(), want.sinr)
        s_elem = float(((res.sinr[:n_ref].double().cpu() - want.sinr).abs()
                        / want.sinr.abs().clamp_min(1e-30)).max())
        if not (float(nmse.max()) <= 1e-9 and s_err <= 1e-4):
            fail(f"receiver {mode}/{kern}: x NMSE {nmse.tolist()} (<= 1e-9), SINR rel {s_err:.3e}")
        check_rtol(f"receiver {mode}/{kern} noise", res.noise_est[:n_ref].cpu(), want.noise_est, 1e-4)
        rx_fns[(mode, kern)] = fn
        print(f"phase 22 receiver c2_receiver_4rx4l {mode}/{kern} (B={B_RX}, {N_RX} RX x 4 layers, "
              f"sinr {tuple(res.sinr.shape)}): x NMSE vs float64 CPU {float(nmse.max()):.3e} "
              f"(<= 1e-9), SINR max err / max {s_err:.3e} (<= 1e-4; elementwise worst "
              f"{s_elem:.3e}), launches {cnt}")

    fn256 = receiver.build_receiver_ri(c0.hop1, c0.hop2, rx_cfg, 4, N_RX, batched=True,
                                       modulation="256qam", device=dev)
    res = fn256(rx_rg, rx_pil, rx_beta)
    torch.cuda.synchronize()
    want = fn256(*ref_args)
    d = torch.stack([(p[:n_ref].cpu().to(torch.int16) - q.to(torch.int16)).abs()
                     for p, q in zip(res.llr, want.llr)])
    frac = float((d > 0).double().mean())
    if int(d.max()) > 1 or frac > 1e-3:
        fail(f"receiver llr256: int8 planes differ by up to {int(d.max())} on {frac:.2e} of entries")
    rx_fns["llr256"] = fn256
    print(f"phase 22 receiver c2_receiver_4rx4l_llr256 (8 int8 planes {tuple(res.llr[0].shape)}): "
          f"within one step of the float64 run, {frac:.2e} of entries off by one (<= 1e-3)")

    # 4 RX x 2 layers: at 4 x 4 a 30 dB uncoded link has errors of its own
    # (deep fades of a square channel; BER ~1e-3 in the float64 run too)
    q_cases, q_cfg, q_rg, q_pil, q_beta = mimo_batch("qpsk", n_ref, **dict(C2_RX, n_layers=2))
    fnq = receiver.build_receiver_ri(q_cases[0].hop1, q_cases[0].hop2, q_cfg, 2, N_RX, batched=True,
                                     modulation="qpsk", device=dev)
    res = fnq(q_rg, q_pil, q_beta)
    n_err = n_bits = 0
    for i, c in enumerate(q_cases):
        llr = np.stack([p[i].cpu().numpy() for p in res.llr], axis=-1)  # (nL, n_sym, n_sc, 2)
        llr = demap.descramble_llrs(np.transpose(llr, (2, 1, 0, 3)), c.scramble_c)
        hard = (llr < 0).astype(np.uint8)
        n_err += int((hard[c.data_mask] != c.bits[c.data_mask]).sum())
        n_bits += int(c.bits[c.data_mask].size)
    if n_err:
        fail(f"QPSK 30 dB link: {n_err} bit errors in {n_bits}")
    print(f"phase 22 QPSK 30 dB link (4 RX x 2 layers, 106 PRB, scrambled): BER 0 over {n_bits} "
          "scored bits")

    # 23. serving.process over heterogeneous lists (tests/test_serving.py shapes)
    def prob_of(c, rg=None):
        return serving.Problem((c.received_rg if rg is None else rg).astype(np.complex64),
                               c.pilots.astype(np.complex64), float(c.beta), c.hop1, c.hop2,
                               c.config)

    specs = [dict(n_prbs=24, n_layers=1), dict(n_prbs=24, n_layers=2),
             dict(n_prbs=12, n_layers=1, two_hops=True),
             dict(n_prbs=24, n_layers=1, time_interp="linear", doppler_hz=250.0)]
    g_cases = [synthetic.make_case(seed=37 + 10 * j + i, snr_db=30.0, **sp)
               for j, sp in enumerate(specs) for i in range(3)]
    t_rel = 0.0
    for out in ("grid", "factored"):
        cs = [c for c in g_cases if out == "grid" or c.config.time_interp == "none"]
        res = serving.process([prob_of(c) for c in cs], batch_size=4, out=out, device=dev)
        for c, r in zip(cs, res):
            nL = c.pilots.shape[2]
            one = estimator.build_ri(c.hop1, c.hop2, dataclasses.replace(c.config, matmul_precision="high"),
                                     nL, out_layout="serve" if out == "grid" else "factored")(
                torch.as_tensor(estimator.split_ri(c.received_rg.astype(np.complex64)), device=dev),
                torch.as_tensor(estimator.split_ri(c.pilots.astype(np.complex64)), device=dev),
                torch.tensor(float(c.beta), device=dev))
            if out == "grid":
                want = estimator.merge_ri(one.channel_est_rg.cpu().numpy()).transpose(2, 1, 0)
                got = r.channel_est_rg
            else:
                want = estimator.merge_ri(one.profiles.cpu().numpy())
                got = r.profiles
            e = np.abs(got - want).max() / np.abs(want).max()
            t_rel = max(t_rel, e)
            if not e <= 1e-5:
                fail(f"process({out}) vs a single build_ri call: rel err {e:.3e}")
            check_rtol(f"process({out}) noise", r.noise_est, float(one.noise_est), 1e-5)
    rx_specs = [dict(n_rx=1, kw=dict(n_prbs=24, n_layers=1)),
                dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2)),
                dict(n_rx=2, kw=dict(n_prbs=24, n_layers=2, time_interp="linear")),
                dict(n_rx=2, kw=dict(n_prbs=12, n_layers=1, two_hops=True))]
    e_cases, e_rgs = [], []
    for j, sp in enumerate(rx_specs):
        for i in range(3):
            ports = [synthetic.make_case(seed=300 + 10 * j + i, noise_seed=500 + r, snr_db=30.0,
                                         **sp["kw"]) for r in range(sp["n_rx"])]
            e_cases.append(ports[0])
            e_rgs.append(np.stack([p.received_rg for p in ports]))
    order = np.random.default_rng(1).permutation(len(e_cases))
    e_cases = [e_cases[i] for i in order]
    e_rgs = [e_rgs[i] for i in order]
    probs = [prob_of(c, rg) for c, rg in zip(e_cases, e_rgs)]
    receiver._build_receiver_cached.cache_clear()
    res_e = serving.process(probs, batch_size=2, out="equalized", data_beta=1.1, device=dev)
    misses = receiver._build_receiver_cached.cache_info().misses
    if misses != len(rx_specs):
        fail(f"process(equalized): {misses} receiver builds for {len(rx_specs)} signatures")
    res_l = serving.process(probs, batch_size=2, out="llrs", modulation="16qam", device=dev)
    eq_nmse, n_off, n_all = 0.0, 0, 0
    for c, rg, re_, rl in zip(e_cases, e_rgs, res_e, res_l):
        nL = c.pilots.shape[2]
        cfg = dataclasses.replace(c.config, matmul_precision="high")
        args = (torch.as_tensor(estimator.split_ri(rg.astype(np.complex64)), device=dev),
                torch.as_tensor(estimator.split_ri(c.pilots.astype(np.complex64)), device=dev),
                torch.tensor(float(c.beta), device=dev))
        one = receiver.build_receiver_ri(c.hop1, c.hop2, cfg, nL, rg.shape[0], data_beta=1.1,
                                         device=dev)(*args)
        want = estimator.merge_ri(one.x.cpu().numpy()).transpose(2, 1, 0)
        eq_nmse = max(eq_nmse, float(np.sum(np.abs(re_.x - want) ** 2) / np.sum(np.abs(want) ** 2)))
        one_l = receiver.build_receiver_ri(c.hop1, c.hop2, cfg, nL, rg.shape[0], modulation="16qam",
                                           device=dev)(*args)
        want_l = np.stack([p.cpu().numpy() for p in one_l.llr]).transpose(3, 2, 1, 0)
        dl = np.abs(rl.llr.astype(np.int16) - want_l.astype(np.int16))
        if dl.max() > 1:
            fail(f"process(llrs) vs a single receiver call: int8 LLRs differ by {dl.max()}")
        n_off += int((dl > 0).sum())
        n_all += dl.size
    if eq_nmse > 1e-7 or n_off > 1e-3 * n_all:
        fail(f"process(equalized) NMSE {eq_nmse:.3e} (<= 1e-7) or llrs off on {n_off}/{n_all}")
    print(f"phase 23 serving.process on {dev}: grid/factored vs single build_ri calls rel err "
          f"{t_rel:.3e} (<= 1e-5); equalized ({len(probs)} problems, 4 signatures, 1 and 2 RX, "
          f"batch 2 with tail padding, {misses} receiver builds) vs single build_receiver_ri "
          f"calls NMSE {eq_nmse:.3e} (<= 1e-7); llrs 16QAM {n_off}/{n_all} entries off by one")

    # 24. the e2e decoded row at its bench width (bench.py:1075-1120)
    lplan = ldpc.make_ldpc_plan(code384)
    e2e_coding = transport.TransportCoding(
        code=code384, rate_match="nr", tx_bits=2 * 8448, schedule="layered", n_iters=16,
        crc="crc24b", interleave_seed=7, layered_group=ldpc.default_layered_group(code384),
        stream_c2v_dtype="bfloat16")
    seed = 4242
    geo = synthetic.make_case(seed=seed, snr_db=15.0, n_prbs=273, n_layers=1)
    n_sc, n_sym = geo.received_rg.shape
    lay = transport.layout(e2e_coding, geo.hop1, geo.hop2, n_sc, n_sym, 1, 2)
    k_pay = transport.payload_bits(e2e_coding, lplan.k)
    rng24 = np.random.default_rng(seed)
    u24 = rng24.integers(0, 2, (lay.c_words, k_pay), dtype=np.uint8)
    bits = transport.place_codewords(
        lay, ldpc.encode(code384, transport.crc_attach(u24, "crc24b")), 1, 2, fill_rng=rng24)
    case = synthetic.make_mimo_case(seed=seed, n_rx=1, modulation="qpsk", scramble=False,
                                    bits=bits, n_prbs=273, n_layers=1, snr_db=15.0)
    e2e_prob = prob_of(case)

    def run_slots(n, on_device):
        t0 = time.perf_counter()
        res = serving.process([e2e_prob] * n, batch_size=8, out="decoded", modulation="qpsk",
                              coding=e2e_coding, matmul_precision="high",
                              decode_on_device=on_device, device=dev)
        dt = time.perf_counter() - t0
        for r in res:
            if not (bool(np.all(r.ok)) and np.array_equal(r.info, u24)):
                fail(f"e2e decoded ({'device' if on_device else 'host'} path, {n} slots): "
                     f"not payload-exact, ok {np.asarray(r.ok).tolist()}")
        return dt, res

    e2e_out = {}
    for on_device in (False, True):
        for n in (8, 24):
            reset_counts()
            _, res = run_slots(n, on_device)
            torch.cuda.synchronize()
            cnt = read_counts()
            n_calls = n // 8 if on_device else 1  # decode calls: one per chunk / one per process
            if cnt["ldpc_stream_posterior"] < n_calls:
                fail(f"e2e {n} slots {'device' if on_device else 'host'}: K3 launches "
                     f"{cnt['ldpc_stream_posterior']} < {n_calls} decode calls")
            e2e_out[(on_device, n)] = res
            print(f"phase 24 e2e decoded 273 PRB BG1 Z=384 {'device' if on_device else 'host'} path, "
                  f"{n} slots x {lay.c_words} words: every CRC24B ok, payload-exact, launches {cnt}")
    for n in (8, 24):
        for rh, rd in zip(e2e_out[(False, n)], e2e_out[(True, n)]):
            if not (np.array_equal(rh.info, rd.info) and np.array_equal(rh.ok, rd.ok)):
                fail(f"e2e {n} slots: host and device paths differ")
    print("phase 24 host and device paths identical (info, ok) on 8 and 24 slots")

    # 25. times: K7, the receiver, the e2e row, the idle share of one e2e call
    x7, known7, it7 = k7_c3
    times["inpaint_stack"] = ab(lambda: k7.inpaint_stack(x7, known7, it7),
                                lambda: k7.inpaint_stack_plain(x7, known7, it7), iters=5)
    B7, C7, n7 = x7.shape
    n_tr = len(dsp.make_inpaint_schedule(known7, it7)[0])
    passes = it7 + 2  # transient + steady = the iterations, then the 2-pass low-pass
    b7 = bound(2 * x7.numel() * 4 + n7 * 4 + n_tr * 2 * n7 * 4, 6 * B7 * C7 * n7 * passes)
    times["inpaint_stack"] += b7[:2]
    w_op = dsp.inpaint_operator(known7, it7, torch.float32, dev)  # (n_known, n)
    xk = x7[..., torch.as_tensor(np.nonzero(known7)[0], device=dev)].reshape(B7 * C7, -1)
    lib_out = torch.matmul(xk, w_op)
    _, lib_err = errs(lib_out.reshape(B7, C7, n7), k7.inpaint_stack_plain(x7, known7, it7))
    t_mm = three(lambda: torch.matmul(xk, w_op), iters=10)
    library["inpaint_stack"] = t_mm[0]
    ms7, plain7, turns7, warm7 = times["inpaint_stack"][:4]
    print(f"phase 25 K7 c3 (B={B7}, C={C7}, n={n7}, {it7} iterations, {n_tr} transient), cold L2: "
          f"kernel {ms7:.4f} ms, plain {plain7:.4f} ms (turns {[round(t, 4) for t in turns7]}), "
          f"warm back-to-back {warm7:.4f} ms; bound {b7[0]:.4f} ms ({b7[1]}; bytes {b7[2]:.4f}, "
          f"operations {b7[3]:.4f}); library call torch.matmul by the {tuple(w_op.shape)} operator "
          f"{library['inpaint_stack']:.4f} ms (the known-value gather excluded; rel err vs plain "
          f"{lib_err:.2e}) {card}")
    known_c, x_c = k7_inputs(128, 8, 132, 2, seed=212)
    t_chain = ab(lambda: k7.inpaint_stack(x_c, known_c, 16),
                 lambda: k7.inpaint_stack_plain(x_c, known_c, 16), iters=10)
    print(f"phase 25 K7 chain regime (B=128, C=8, n=132, 16 iterations), cold L2: kernel "
          f"{t_chain[0]:.4f} ms, plain {t_chain[1]:.4f} ms {card}")
    # K7 and its one-call counterpart side by side, three ways each
    w_op_c = dsp.inpaint_operator(known_c, 16, torch.float32, dev)  # (66, 132)
    xk_c = x_c[..., torch.as_tensor(np.nonzero(known_c)[0], device=dev)].reshape(128 * 8, -1)
    print_three(25, f"K7 c3 ({B7}, {C7}, {n7}), {it7} iterations",
                three(lambda: k7.inpaint_stack(x7, known7, it7), iters=10))
    print_three(25, f"torch.matmul c3 {tuple(xk.shape)} @ {tuple(w_op.shape)}", t_mm)
    print_three(25, "K7 chain (128, 8, 132), 16 iterations",
                three(lambda: k7.inpaint_stack(x_c, known_c, 16), iters=10))
    print_three(25, f"torch.matmul chain {tuple(xk_c.shape)} @ {tuple(w_op_c.shape)}",
                three(lambda: torch.matmul(xk_c, w_op_c), iters=10))
    # K7 at c3 width (32 rows of 3276, one 16-warp block a row): ns per steady
    # pass (the slope from 2400 to 4800 passes) and the rest of a call,
    # through the C entry (warm L2); and rows of 960, one 4-warp block a row
    # (a pass's latency with most of the SM's issue slots free)
    from srsran_ce_tpu_torch.ops.kernels import bind, launch as c_launch
    k7_c = bind("inpaint", "srs_inpaint_f32", k7._ARGTYPES)
    for n_s in (3276, 960):
        x_s = torch.randn(32, n_s, device=dev)
        out_s = torch.empty_like(x_s)
        known_s = torch.as_tensor((np.arange(n_s) % 2 == 0).astype(np.float32), device=dev)
        t_s = {st: time_ms(lambda: c_launch("inpaint_stack", k7_c, dev, x_s.data_ptr(),
                                            known_s.data_ptr(), 0, 32, n_s, 0, st,
                                            k7.route_for(n_s), out_s.data_ptr()),
                           iters=10, cold=False)
               for st in (48, 2400, 4800)}
        per = (t_s[4800] - t_s[2400]) / 2400
        print(f"phase 25 K7 32 rows of {n_s}, one block a row: {per * 1e6:.1f} ns per steady "
              f"pass, {(t_s[48] - 48 * per) * 1e3:.2f} us the rest of a call (slope over 2400 -> "
              f"4800 passes, warm L2) {card}")
    for key, fn in rx_fns.items():
        ev, wall = call_ms(fn, (rx_rg, rx_pil, rx_beta))
        label = "/".join(key) if isinstance(key, tuple) else key
        print(f"phase 25 receiver c2_receiver_4rx4l {label} B={B_RX}: {ev:.4f} ms/batch on CUDA "
              f"events, cold L2; {wall:.4f} ms/batch host wall clock back-to-back {card}")
    # the e2e slope of each path with the CRC as the bit-serial register (the
    # port's form before) and as the port's transport.crc_bits, the rest of
    # the path unchanged. The two take turns call by call (8 slots, then 24;
    # six rounds, which form goes first alternating), so a slow spell of the
    # host falls on both alike
    crc_port = transport.crc_bits
    forms = {"bit-serial": _crc_bits_serial, "byte table": crc_port}
    for on_device in (False, True):
        path = "device" if on_device else "host"
        t_call = {(form, n): [] for form in forms for n in (8, 24)}
        for rnd in range(6):
            for n in (8, 24):
                for form in sorted(forms, reverse=bool(rnd % 2)):
                    transport.crc_bits = forms[form]
                    try:
                        t_call[(form, n)].append(run_slots(n, on_device)[0])
                    finally:
                        transport.crc_bits = crc_port
        for form in forms:
            lo, hi = t_call[(form, 8)], t_call[(form, 24)]
            print(f"phase 25 e2e decoded {path} path, CRC {form}: "
                  f"{(min(hi) - min(lo)) / 16 * 1e3:.3f} ms/slot (host wall clock, slope 8 -> 24 "
                  f"slots over the min of 6: {min(lo) * 1e3:.1f} ms / {min(hi) * 1e3:.1f} ms; over "
                  f"the medians {(np.median(hi) - np.median(lo)) / 16 * 1e3:.3f}) {card}")
        if on_device:
            wall8 = min(t_call[("byte table", 8)])
    # the CRC's share of one device-path call (8 slots), cProfile: the
    # bit-serial register and the port's transport.crc_bits
    for form, fn in (("bit-serial", _crc_bits_serial), ("byte table", crc_port)):
        transport.crc_bits = fn
        try:
            run_slots(8, True)  # warm: the generator matrix is built once per (kind, length)
            prof_c = cProfile.Profile()
            t0 = time.perf_counter()
            prof_c.enable()
            run_slots(8, True)
            prof_c.disable()
            wall_c = time.perf_counter() - t0
        finally:
            transport.crc_bits = crc_port
        stats = pstats.Stats(prof_c).stats
        crc_s = sum(st[3] for key, st in stats.items()
                    if key[2] == "crc_check" and key[0].endswith("transport.py"))
        print(f"phase 25 e2e device path, 8 slots, cProfile: CRC ({form}) {crc_s * 1e3:.2f} ms "
              f"cumulative of the call's {wall_c * 1e3:.1f} ms ({100 * crc_s / wall_c:.1f} %) {card}")
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:6]  # the byte-table run: own time
    print("phase 25 e2e device path, 8 slots, cProfile, most own time: " + ", ".join(
        f"{key[2]} ({key[0].rsplit('/', 1)[-1]}:{key[1]}) {st[2] * 1e3:.2f} ms" for key, st in top))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_slots(8, True)
        torch.cuda.synchronize()
    dev_us = {e.key: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
              for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    busy_us = sum(dev_us.values())
    k3_us = sum(us for key, us in dev_us.items() if "layered_kernel" in key)  # K3's kernels
    if busy_us > 0:
        print(f"phase 25 e2e device path, 8 slots: device busy {busy_us / 1e3:.3f} ms of "
              f"{wall8 * 1e3:.1f} ms unprofiled wall, idle share "
              f"{100 * (1 - busy_us / 1e3 / (wall8 * 1e3)):.1f} %; K3 {k3_us / 1e3:.3f} ms of the "
              f"busy time ({100 * k3_us / busy_us:.1f} %) (torch.profiler) {card}")
    else:
        print("phase 25 e2e idle share: not measured (the profiler saw no device time)")

    # 26. tracked serve (models/tracking.build_tracked_ri, the plain tier) at c2
    # and at the bench's q_tracked_52prb_2l (bench.py:660-663)
    from srsran_ce_tpu_torch.models import denoiser, tracking

    Q52 = dict(n_prbs=52, n_layers=2, comb=2, scs_hz=30e3, snr_db=30.0)
    tracked_fns = {}

    def nmse_of(got, want, dims):
        got, want = got.double().cpu(), want.double().cpu()
        return ((got - want) ** 2).sum(dim=dims) / (want**2).sum(dim=dims)

    for label, kw in (("c2", C2), ("q_tracked_52prb_2l", Q52)):
        cases_t, cfg_t, rg_t, pil_t, beta_t = tiled(kw, 128)
        ct, nL_t = cases_t[0], cases_t[0].pilots.shape[2]
        fn_t = tracking.build_tracked_ri(ct.hop1, ct.hop2, cfg_t, nL_t, batched=True,
                                         out_layout="serve", device=dev)
        state0 = tracking.init_state(ct.hop1, ct.hop2, cfg_t, nL_t, batch=128, device=dev)
        plain = estimator.build_ri(ct.hop1, ct.hop2, cfg_t, nL_t, batched=True,
                                   out_layout="serve")(rg_t, pil_t, beta_t)
        torch.cuda.synchronize()
        reset_counts()
        res_t, h_t, w_t = fn_t(rg_t, pil_t, beta_t, *state0)
        torch.cuda.synchronize()
        cnt = read_counts()
        need(f"tracked {label}", cnt, idle=tuple(kmods))
        n0 = float(nmse_of(res_t.channel_est_rg, plain.channel_est_rg, (1, 2, 3, 4)).max())
        if not (n0 <= 1e-9 and bool((w_t == 1.0).all())):
            fail(f"tracked {label} slot 0: NMSE vs plain serve {n0:.3e} (<= 1e-9), "
                 f"w {w_t.unique().tolist()} (1)")
        # eight soundings of a static channel (no CFO, as tests/test_tracking.py),
        # 0 dB, fresh noise each; the channel NMSE against the truth of the four
        # distinct problems
        skw = dict(kw, snr_db=0.0, cfo_hz=0.0, cfo_compensate=False)
        c_s = synthetic.make_case(seed=SEEDS[0], **skw)
        fn_s = tracking.build_tracked_ri(c_s.hop1, c_s.hop2, dataclasses.replace(
            c_s.config, matmul_precision="high"), nL_t, batched=True, out_layout="serve",
            device=dev)
        st = tracking.init_state(c_s.hop1, c_s.hop2, c_s.config, nL_t, batch=128, device=dev)
        curve = []
        for k in range(8):
            cs = [synthetic.make_case(seed=s, noise_seed=1000 + k, **skw) for s in SEEDS]
            idx = np.arange(128) % len(cs)
            t32 = lambda a: torch.as_tensor(np.stack(a)[idx], dtype=torch.float32, device=dev)
            res_s, *st = fn_s(t32([estimator.split_ri(c.received_rg) for c in cs]),
                              t32([estimator.split_ri(c.pilots) for c in cs]),
                              torch.full((128,), c_s.beta, dtype=torch.float32, device=dev), *st)
            ch = res_s.channel_est_rg[: len(cs)].double().cpu().numpy()
            grid = (ch[:, 0] + 1j * ch[:, 1]).transpose(0, 3, 2, 1)  # (4, n_sc, n_sym, nL)
            truth = np.stack([c.true_channel for c in cs])
            curve.append(float(np.sum(np.abs(grid - truth) ** 2) / np.sum(np.abs(truth) ** 2)))
        db = 10 * np.log10(np.asarray(curve))
        slope = float(np.polyfit(np.arange(8), db, 1)[0])
        if not (slope < 0 and db[-1] < db[0] - 4.0 and db[-1] <= db[:4].min()):
            fail(f"tracked {label}: channel NMSE over 8 soundings {db.round(2).tolist()} dB does "
                 f"not fall (slope {slope:.3f} dB a sounding)")
        ev, wall = call_ms(fn_t, (rg_t, pil_t, beta_t) + tuple(state0))
        tracked_fns[label] = (fn_t, (rg_t, pil_t, beta_t) + tuple(state0), wall)
        print(f"phase 26 tracked serve {label} B=128 (nL={nL_t}): slot 0 vs plain build_ri serve "
              f"NMSE {n0:.3e} (<= 1e-9), w 1; 8 static soundings at 0 dB, channel NMSE vs truth "
              f"{db.round(2).tolist()} dB (slope {slope:.3f} dB a sounding, w "
              f"{float(st[1].min()):.0f}); launches {cnt} (the plain tier); a slot {ev:.4f} ms on "
              f"CUDA events, cold L2, {wall:.4f} ms host wall clock back-to-back {card}")
        print_busy(26, f"tracked serve {label} B=128", fn_t,
                   (rg_t, pil_t, beta_t) + tuple(state0), wall)

    # 27. the tracked receiver at c2_receiver_4rx4l (4 RX x 4 layers, B=128, QPSK LLRs)
    tr_cases, tr_cfg, tr_rg, tr_pil, tr_beta = mimo_batch("qpsk", B_RX, **C2_RX)
    c0 = tr_cases[0]
    fn_tr = receiver.build_tracked_receiver_ri(c0.hop1, c0.hop2, tr_cfg, 4, N_RX, batched=True,
                                               modulation="qpsk", device=dev)
    fn_pr = receiver.build_receiver_ri(c0.hop1, c0.hop2, tr_cfg, 4, N_RX, batched=True,
                                       modulation="qpsk", device=dev)
    h0, w0 = tracking.init_state(c0.hop1, c0.hop2, tr_cfg, 4, batch=N_RX, device=dev)
    st0 = (tuple(h.expand((B_RX,) + h.shape).contiguous() for h in h0),
           w0.expand(B_RX, N_RX).contiguous())
    reset_counts()
    res_tr, *_ = fn_tr(tr_rg, tr_pil, tr_beta, *st0)
    torch.cuda.synchronize()
    cnt = read_counts()
    need("tracked receiver", cnt, idle=tuple(kmods))
    res_pr = fn_pr(tr_rg, tr_pil, tr_beta)
    d = torch.stack([(a.to(torch.int16) - b.to(torch.int16)).abs()
                     for a, b in zip(res_tr.llr, res_pr.llr)])
    _, s_err = errs(res_tr.sinr, res_pr.sinr)
    if int(d.max()) > 1 or float((d > 0).double().mean()) > 1e-3 or s_err > 1e-5:
        fail(f"tracked receiver slot 0 vs the plain factored receiver: LLRs differ by "
             f"{int(d.max())}, SINR rel {s_err:.3e}")
    # four soundings of the static channel at 0 dB, fresh noise each: the
    # post-MMSE SINR measured on the equalized data symbols against the sent
    # ones (x = g s + e per layer, SINR = |g|^2 sum|s|^2 / sum|x - g s|^2 over the
    # data REs of the four distinct problems); the receiver's own SINR output
    # is an estimate from the estimated channel and the single-slot noise
    fn_tx = receiver.build_tracked_receiver_ri(c0.hop1, c0.hop2, tr_cfg, 4, N_RX, batched=True,
                                               device=dev)

    def measured_sinr_db(x, cs):
        num = den = 0.0
        for i, c in enumerate(cs):
            xr = x[i].double().cpu().numpy()
            xc = (xr[0] + 1j * xr[1]).transpose(2, 1, 0)  # (n_sc, n_sym, nL)
            for l in range(xc.shape[2]):
                xs, sent = xc[:, :, l][c.data_mask], c.payload[:, :, l][c.data_mask]
                g = np.vdot(sent, xs) / np.vdot(sent, sent)
                num += abs(g) ** 2 * np.sum(np.abs(sent) ** 2)
                den += np.sum(np.abs(xs - g * sent) ** 2)
        return float(10 * np.log10(num / den))

    sinr_db = []
    st = st0
    for k in range(4):
        rc = [synthetic.make_mimo_case(seed=s, n_rx=N_RX, modulation="qpsk", noise_seed=700 + k,
                                       **dict(C2_RX, snr_db=0.0)) for s in SEEDS]
        idx = np.arange(B_RX) % len(rc)
        t32 = lambda a: torch.as_tensor(np.stack(a)[idx], dtype=torch.float32, device=dev)
        res_k, *st = fn_tx(t32([estimator.split_ri(c.received_rg) for c in rc]),
                           t32([estimator.split_ri(c.pilots) for c in rc]), tr_beta, *st)
        sinr_db.append(measured_sinr_db(res_k.x[: len(rc)], rc))
    sinr_db = np.asarray(sinr_db)
    if not (np.polyfit(np.arange(4), sinr_db, 1)[0] > 0 and np.all(sinr_db[1:] > sinr_db[0])):
        fail(f"tracked receiver: measured post-MMSE SINR over 4 soundings "
             f"{sinr_db.round(3).tolist()} dB does not grow")
    ev, wall = call_ms(fn_tr, (tr_rg, tr_pil, tr_beta) + tuple(st0))
    print(f"phase 27 tracked receiver c2_receiver_4rx4l B={B_RX} QPSK LLRs: slot 0 vs the plain "
          f"factored receiver LLRs off by one on {float((d > 0).double().mean()):.2e} of entries, "
          f"SINR rel {s_err:.3e} (<= 1e-5); 4 static soundings at 0 dB, measured post-MMSE SINR "
          f"{sinr_db.round(3).tolist()} dB (w {float(st[1].min()):.0f}); launches {cnt} (the plain tier); a slot {ev:.4f} ms "
          f"on CUDA events, cold L2, {wall:.4f} ms host wall clock back-to-back {card}")
    print_busy(27, f"tracked receiver c2_receiver_4rx4l B={B_RX}", fn_tr,
               (tr_rg, tr_pil, tr_beta) + tuple(st0), wall)

    # 28. serving.TrackedServer on the card against the same calls on the CPU
    # (float32 both): 3 streams, 4 soundings, then a mode switch that resets
    srv = {d_: serving.TrackedServer(batch_size=2, device=d_) for d_ in (dev, "cpu")}
    skw = dict(n_prbs=24, n_layers=2, snr_db=10.0)
    srv_err = 0.0
    for k in range(4):
        cs = [synthetic.make_case(seed=80 + j, noise_seed=900 + k, **skw) for j in range(3)]
        out = {d_: srv[d_].process([prob_of(c) for c in cs], ["a", "b", "c"]) for d_ in srv}
        for g, w in zip(out[dev], out["cpu"]):
            srv_err = max(srv_err, float(np.abs(g.channel_est_rg - w.channel_est_rg).max()
                                         / np.abs(w.channel_est_rg).max()))
            check_rtol("TrackedServer noise", g.noise_est, w.noise_est, 1e-4)
    m = synthetic.make_mimo_case(seed=92, n_rx=2, modulation="qpsk", n_prbs=24, n_layers=2)
    out = {d_: srv[d_].process([prob_of(m)], ["a"], out="equalized") for d_ in srv}
    eq = float(np.sum(np.abs(out[dev][0].x - out["cpu"][0].x) ** 2)
               / np.sum(np.abs(out["cpu"][0].x) ** 2))
    keys = {d_: sorted((k[1], k[-1]) for k in srv[d_]._state) for d_ in srv}
    ws = {d_: sorted((k[1], float(np.max(v[1]))) for k, v in srv[d_]._state.items()) for d_ in srv}
    want_ws = [("a", 1.0), ("b", 4.0), ("c", 4.0)]
    if srv_err > 1e-5 or eq > 1e-7 or keys[dev] != keys["cpu"] or ws[dev] != want_ws \
            or ws["cpu"] != want_ws:
        fail(f"TrackedServer card vs CPU: grid rel {srv_err:.3e} (<= 1e-5), equalized NMSE "
             f"{eq:.3e} (<= 1e-7), states {keys}, weights {ws} (want {want_ws})")
    print(f"phase 28 TrackedServer on {dev} vs device='cpu' (float32 both, 3 streams of 24 PRB x "
          f"2 layers, batch 2 with tail padding, 4 soundings): grid rel err {srv_err:.3e} "
          f"(<= 1e-5), weights equal; stream 'a' switched to out='equalized': reset on both "
          f"(w 1), x NMSE {eq:.3e} (<= 1e-7)")

    # 29. learned serve at c2 with the shipped 1-D checkpoint, xla and pallas
    # tiers (pallas serve: the deferred K2 fill; pallas ref: K6), against the
    # port's float64 CPU run of the first four problems
    params1 = denoiser.load_shipped("1d", device=dev)
    params1_cpu = denoiser.load_shipped("1d", device="cpu")
    params2 = denoiser.load_shipped("2d", device=dev)
    params2_cpu = denoiser.load_shipped("2d", device="cpu")
    learned_times = {}

    def learned_path(phase, label, kw, params, params_cpu, kern, layout, launched, idle):
        cases_l, cfg_l, rg_l, pil_l, beta_l = tiled(kw, 128)
        cl, nL_l = cases_l[0], cases_l[0].pilots.shape[2]
        fn = estimator.build_ri(cl.hop1, cl.hop2, cfg_l, nL_l, batched=True, kernels=kern,
                                out_layout=layout)
        args = (rg_l, pil_l, beta_l, params)
        fn(*args)
        torch.cuda.synchronize()
        reset_counts()
        res = fn(*args)
        torch.cuda.synchronize()
        cnt = read_counts()
        need(f"{label} {kern}/{layout}", cnt, launched=launched, idle=idle)
        n = len(cases_l)
        want = fn(*(a[:n].double().cpu() for a in (rg_l, pil_l, beta_l)), params_cpu)
        if not bool(torch.isfinite(res.channel_est_rg).all()):
            fail(f"{label} {kern}/{layout}: grid not finite")
        worst = float(nmse_of(res.channel_est_rg[:n], want.channel_est_rg, (1, 2, 3, 4)).max())
        if not worst <= 1e-9:
            fail(f"{label} {kern}/{layout}: NMSE vs the float64 CPU run {worst:.3e} > 1e-9")
        check_rtol(f"{label} {kern}/{layout} noise", res.noise_est[:n].cpu(), want.noise_est, 1e-4)
        ev, wall = call_ms(fn, args)
        learned_times[(label, kern, layout)] = (ev, wall)
        print(f"phase {phase} {label} {kern}/{layout} B=128 (nL={nL_l}, grid "
              f"{tuple(res.channel_est_rg.shape)}): NMSE vs the float64 CPU run {worst:.3e} "
              f"(<= 1e-9), launches {cnt}; {ev:.4f} ms/batch on CUDA events, cold L2, "
              f"{wall:.4f} ms host wall clock back-to-back {card}")
        print_busy(phase, f"{label} {kern}/{layout} B=128", fn, args, wall)

    C2L = dict(C2, smoothing="learned")
    learned_path(29, "learned c2", C2L, params1, params1_cpu, "xla", "serve", (), tuple(kmods))
    learned_path(29, "learned c2", C2L, params1, params1_cpu, "pallas", "serve",
                 ("fused_fill_rotate_serve",),
                 ("fused_front", "rc_smooth", "fused_fill_rotate", "inpaint_stack"))
    learned_path(29, "learned c2", C2L, params1, params1_cpu, "pallas", "ref",
                 ("fused_fill_rotate",),
                 ("fused_front", "rc_smooth", "fused_fill_rotate_serve", "inpaint_stack"))

    # the denoiser alone at the c2 shape (128 x 4 rows of 636 pilots, three
    # cuDNN convolutions, 21.1 GFLOP): device-only time against its bound,
    # the convolution kernels by full name; then the xla/serve call once
    # more, after the pallas calls, with its convolution kernels
    def conv_kernels(fn, n=20):
        ms = kernel_ms(fn, n)
        return sum(ms.values()), {k: v for k, v in ms.items() if "fprop" in k or "conv" in k}

    h_dn = torch.randn(128, 4, 636, dtype=torch.complex64, device=dev)
    dn_flop = 2 * 13 * (2 * 48 + 48 * 48 + 48 * 2) * 128 * 4 * 636
    dn_busy, dn_conv = conv_kernels(lambda: denoiser.apply_complex(params1, h_dn))
    print(f"phase 29 denoiser alone c2 shape (128, 4, 636): device-only {dn_busy:.4f} ms, bound "
          f"{dn_flop / 67e12 * 1e3:.4f} ms ({dn_flop / 1e9:.2f} GFLOP over 67 TFLOP/s); "
          "convolutions: " + ", ".join(f"{k} {v:.4f} ms" for k, v in dn_conv.items()) + f" {card}")
    cases_x, cfg_x, rg_x, pil_x, beta_x = tiled(C2L, 128)
    fn_x = estimator.build_ri(cases_x[0].hop1, cases_x[0].hop2, cfg_x, 4, batched=True,
                              out_layout="serve")
    x_busy, x_conv = conv_kernels(lambda: fn_x(rg_x, pil_x, beta_x, params1))
    print(f"phase 29 learned c2 xla/serve again, after the pallas calls: device busy "
          f"{x_busy:.4f} ms; convolutions: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in x_conv.items()) + f" {card}")

    # 30. learned2d at the bench's q_learned2d_52prb (bench.py:664-672): 52 PRB x 2
    # layers, time_interp="linear", Doppler 300 Hz, the shipped 2-D checkpoint;
    # the time-interpolated fill is plain on every tier, as in JAX
    Q2D = dict(Q52, smoothing="learned2d", time_interp="linear", doppler_hz=300.0)
    for kern in ("xla", "pallas"):
        learned_path(30, "q_learned2d_52prb", Q2D, params2, params2_cpu, kern, "serve", (),
                     tuple(kmods))

    # 31. serving.process(out="grid", params=...) on the card against single
    # build_ri calls: learned problems of two signatures, batch 4 with tail padding
    lp_cases = [synthetic.make_case(seed=60 + i, snr_db=20.0, smoothing="learned", **sp)
                for sp in (dict(n_prbs=24, n_layers=2), dict(n_prbs=12, n_layers=1, two_hops=True))
                for i in range(5)]
    res = serving.process([prob_of(c) for c in lp_cases], batch_size=4, params=params1,
                          device=dev)
    lp_err = 0.0
    for c, r in zip(lp_cases, res):
        one = estimator.build_ri(c.hop1, c.hop2, dataclasses.replace(c.config, matmul_precision="high"),
                                 c.pilots.shape[2], out_layout="serve")(
            torch.as_tensor(estimator.split_ri(c.received_rg.astype(np.complex64)), device=dev),
            torch.as_tensor(estimator.split_ri(c.pilots.astype(np.complex64)), device=dev),
            torch.tensor(float(c.beta), device=dev), params1)
        want = estimator.merge_ri(one.channel_est_rg.cpu().numpy()).transpose(2, 1, 0)
        lp_err = max(lp_err, float(np.abs(r.channel_est_rg - want).max() / np.abs(want).max()))
        check_rtol("process(params) noise", r.noise_est, float(one.noise_est), 1e-5)
    if not lp_err <= 1e-5:
        fail(f"process(out='grid', params=...) vs single build_ri calls: rel err {lp_err:.3e}")
    print(f"phase 31 serving.process(out='grid', params=shipped 1-D) on {dev}: {len(lp_cases)} "
          f"learned problems, 2 signatures, batch 4 with tail padding, vs single build_ri calls "
          f"rel err {lp_err:.3e} (<= 1e-5)")

    # 32. `cli train` at its full defaults on the card (1-D, batch 256, n_re 128,
    # 500 steps, cosine lr), its first 5 steps held to the CPU's, ms a step,
    # the multi-geometry cycle, train2d at its CLI width, a save -> resume
    from srsran_ce_tpu_torch.models import training

    def run_cli(argv):
        """(rc, stdout, wall s) of one CLI call, its output echoed."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(buf.getvalue(), end="")
        return rc, buf.getvalue(), wall

    def logged_losses(out):
        return [float(m) for m in re.findall(r"^step +\d+ .*nmse ([0-9.e+-]+)$", out, re.M)]

    def train_flop(two_d, positions):
        """Forward + backward float32 operations of one training step: every
        layer's weight gradient, every layer's input gradient but the first's."""
        m = denoiser.PilotDenoiser2D() if two_d else denoiser.PilotDenoiser()
        per = [2 * c.weight.numel() for c in m.convs]  # 2 x MACs a position
        return (2 * sum(per) + sum(per[1:])) * positions

    def first_steps_vs_cpu(two_d, B, n_re):
        init = training.init_state_2d if two_d else training.init_state
        make = denoiser.make_training_batch_2d if two_d else denoiser.make_training_batch
        out = {}
        for d_ in (dev, "cpu"):
            st, _ = init(0, device=d_)
            step = (training.build_train_step_2d if two_d else training.build_train_step)(
                training.make_optimizer(1e-3, decay_steps=500))
            rng_t = np.random.default_rng(0)
            p_, o_, losses = st.params, st.opt_state, []
            for _ in range(5):
                p_, o_, loss = step(p_, o_, *make(rng_t, B, n_re))
                losses.append(float(loss))
            out[d_] = (p_, losses)
        l_err = max(abs(a - b) / b for a, b in zip(out[dev][1], out["cpu"][1]))
        p_err = max(float((out[dev][0][k].cpu() - v).abs().max()) for k, v in out["cpu"][0].items())
        # Adam moves a parameter by ~lr * sign(g): a gradient element near zero
        # whose sign differs between the two summation orders moves it by 2 lr,
        # at most once a step
        if not (l_err <= 1e-4 and p_err <= 1e-2):
            fail(f"train{' 2-D' if two_d else ''}: 5 steps on the card vs the CPU: loss rel "
                 f"{l_err:.3e} (<= 1e-4), params max abs {p_err:.3e} (<= 1e-2 = 5 x 2 lr)")
        return l_err, p_err

    def step_ms(two_d, B, n_re, n=50):
        """CUDA-event ms of one training step (forward, backward, AdamW, lr
        step) on batches already on the card, and its device busy time and
        idle share (torch.profiler)."""
        init = training.init_state_2d if two_d else training.init_state
        make = denoiser.make_training_batch_2d if two_d else denoiser.make_training_batch
        st, tx = init(0, device=dev)
        trainer = training._Trainer(st.params, st.opt_state, tx, two_d)
        batch = [torch.as_tensor(a, device=dev) for a in make(np.random.default_rng(1), B, n_re)]
        ev = time_ms(lambda: trainer.step(*batch), iters=n, cold=False)
        ms = kernel_ms(lambda: trainer.step(*batch), 20, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
        top = sorted(ms.items(), key=lambda kv: -kv[1])[:3]
        return ev, sum(ms.values()), ", ".join(f"{k[:60]} {v:.4f} ms" for k, v in top)

    td32 = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        l_err, p_err = first_steps_vs_cpu(False, 256, 128)
        rc, out, wall1 = run_cli(["train", "--device", "cuda", "--checkpoint", str(td32 / "d.npz")])
        losses = logged_losses(out)
        if rc != 0 or len(losses) < 2 or not losses[-1] < losses[0]:
            fail(f"cli train: rc {rc}, logged losses {losses} (the last must be below the first)")
        ev1, busy1, top1 = step_ms(False, 256, 128)
        flop1 = train_flop(False, 256 * 128)
        print(f"phase 32 cli train (1-D, batch 256, n_re 128, 500 steps, cosine lr) on {dev}: "
              f"loss {losses[0]:.4e} -> {losses[-1]:.4e}; first 5 steps vs the CPU: loss rel "
              f"{l_err:.3e} (<= 1e-4), params max abs {p_err:.3e} (<= 1e-2); {wall1:.2f} s wall "
              f"({wall1 / 500 * 1e3:.3f} ms a step with the host's batches); a step on the card "
              f"{ev1:.4f} ms on CUDA events (batch on the card), device busy {busy1:.4f} ms, bound "
              f"{flop1 / 67e12 * 1e3:.4f} ms ({flop1 / 1e9:.3f} GFLOP forward + backward over "
              f"67 TFLOP/s); heaviest: {top1} {card}")
        st, loss = training.train(n_steps=6, batch=256, n_re=(24, 128, 1638), log_every=1,
                                  device=dev)
        if not (st.step == 6 and np.isfinite(loss)):
            fail(f"multi-geometry train: step {st.step}, loss {loss}")
        t0 = time.perf_counter()
        training.train(n_steps=6, batch=256, n_re=(24, 128, 1638), log_every=0, device=dev)
        torch.cuda.synchronize()
        print(f"phase 32 multi-geometry cycle (24, 128, 1638) batch 256 -> (256, 48, 8): 6 steps, "
              f"{(time.perf_counter() - t0) / 6 * 1e3:.3f} ms a step wall {card}")
        l2_err, p2_err = first_steps_vs_cpu(True, 128, 128)
        rc, out, wall2 = run_cli(["train", "--model", "2d", "--batch", "128", "--device", "cuda"])
        losses2 = logged_losses(out)
        if rc != 0 or not losses2[-1] < losses2[0]:
            fail(f"cli train --model 2d: rc {rc}, logged losses {losses2}")
        ev2, busy2, top2 = step_ms(True, 128, 128)
        flop2 = train_flop(True, 128 * 4 * 128)
        print(f"phase 32 cli train --model 2d (batch 128, n_re 128, n_dsym 4, 500 steps): loss "
              f"{losses2[0]:.4e} -> {losses2[-1]:.4e}; first 5 steps vs the CPU loss rel "
              f"{l2_err:.3e}, params max abs {p2_err:.3e}; {wall2:.2f} s wall; a step {ev2:.4f} ms "
              f"on CUDA events, device busy {busy2:.4f} ms, bound {flop2 / 67e12 * 1e3:.4f} ms "
              f"({flop2 / 1e9:.3f} GFLOP); heaviest: {top2} {card}")
        rc, out, _ = run_cli(["train", "--device", "cuda", "--steps", "5", "--resume",
                              str(td32 / "d.npz"), "--checkpoint", str(td32 / "d2.npz")])
        back = training.load_checkpoint(td32 / "d2.npz", device=dev)
        if rc != 0 or back.step != 505 or back.opt_state.count != 505:
            fail(f"cli train --resume: rc {rc}, step {back.step}, Adam count {back.opt_state.count}")
        print(f"phase 32 save -> resume: 500 + 5 steps, step {back.step}, Adam count "
              f"{back.opt_state.count} (the bias correction goes on)")
    finally:
        shutil.rmtree(td32, ignore_errors=True)

    # 33. `cli quality --device cuda --cases 2` with the shipped checkpoints
    td33 = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_"))
    try:
        rc, out, wall_q = run_cli(["quality", "--device", "cuda", "--cases", "2",
                                   "--report", str(td33 / "q.json")])
        rep = json.loads((td33 / "q.json").read_text())
    finally:
        shutil.rmtree(td33, ignore_errors=True)
    titles = ("learned-vs-filter gain", "Geometry generalization", "Doppler tracking",
              "CFO RMS error", "Multi-slot tracking", "Auto-matched MMSE prior",
              "Link-level uncoded BER", "Coded link")
    missing = [t for t in titles if t not in out]
    learned0, filter0 = rep["snr"]["learned"]["0.0"], rep["snr"]["filter"]["0.0"]
    single, tracked = rep["tracking"]["single_slot_db"], rep["tracking"]["tracked_8slots_db"]
    if rc != 0 or missing or not learned0 < filter0 or not tracked < single:
        fail(f"cli quality: rc {rc}, tables missing {missing}, learned {learned0:.2f} vs filter "
             f"{filter0:.2f} dB at 0 dB, tracked {tracked:.2f} vs single {single:.2f} dB")
    print(f"phase 33 cli quality --cases 2 on {dev}: learned {learned0:.2f} dB < filter "
          f"{filter0:.2f} dB at 0 dB SNR; tracked 8 slots {tracked:.2f} dB < single slot "
          f"{single:.2f} dB; {len(titles)} tables printed; {wall_q:.2f} s wall {card}")

    # 34. `selftest --deep --device cuda` at reduced counts; K4's launches over
    # the coded fuzz (counts set to 0 just before), then per decode path
    from srsran_ce_tpu_torch.validation import deepfuzz

    cuts = dict(geometry=(20, 100), coded=(9, 30), header=(120, 120), sp=(0, 30))
    print("phase 34 selftest --deep cuts: " + ", ".join(
        f"{k} {n} of the CLI's default {d}" for k, (n, d) in cuts.items()) + " (phase 43 runs "
          "the sharded sweep)")
    td34 = Path(tempfile.mkdtemp(prefix="chip_smoke_deep_"))
    try:
        reset_counts()
        rc, out, wall_d = run_cli(["selftest", "--deep", "--device", "cuda",
                                   "--geometry-n", str(cuts["geometry"][0]),
                                   "--coded-n", str(cuts["coded"][0]),
                                   "--header-n", str(cuts["header"][0]),
                                   "--sp-n", str(cuts["sp"][0]),
                                   "--report", str(td34 / "deep.json")])
        deep_counts = read_counts()
        deep = json.loads((td34 / "deep.json").read_text())
    finally:
        shutil.rmtree(td34, ignore_errors=True)
    k4_path = {False: 0, True: 0}
    for t in range(cuts["coded"][0]):
        reset_counts()
        row = deepfuzz.coded_trial(t, device=dev)
        torch.cuda.synchronize()
        k4_path[row["config"]["dev"]] += read_counts()["ldpc_posterior"]
        if not row["ok"]:
            fail(f"coded trial {t}: {row['config']}")
    if rc != 0 or not deep["all_pass"] or deep_counts["ldpc_posterior"] < 1 \
            or min(k4_path.values()) < 1:
        fail(f"selftest --deep: rc {rc}, all_pass {deep['all_pass']}, launches {deep_counts}, "
             f"K4 per decode path (host, device) {k4_path[False]}, {k4_path[True]}")
    g = deep["geometry"]
    print(f"phase 34 selftest --deep on {dev} ({deep['device_name']}): geometry "
          f"{g['n_pass']}/{g['n_cases']}, NMSE max {g['nmse_max']:.3e} (< {g['nmse_bound']}), "
          f"coded {deep['coded']['n_pass']}/{deep['coded']['n_cases']}, header "
          f"{deep['header']['n_pass']}/{deep['header']['n_cases']}; launches over the run "
          f"{deep_counts}; K4 per coded trial path: host {k4_path[False]}, device "
          f"{k4_path[True]}; {wall_d:.2f} s wall {card}")

    # 35. `validate --debug-case` on a synthesized suite with an injected gain
    td35 = Path(tempfile.mkdtemp(prefix="chip_smoke_debug_"))
    try:
        synth_vectors.generate_suite(td35, [dict(n_prbs=24, n_layers=2, comb=2, scs_hz=30e3)],
                                     seed0=7100)
        from srsran_ce_tpu_torch.utils import vectors

        path = td35 / "port_channel_estimator_test_output_ch_est0.dat"
        ent = vectors.load_entries(path)
        vectors.write_entries(path, ent["sym"], ent["port"], ent["sc"],
                              ent["value"] * 0.8 * np.exp(1j * np.deg2rad(37.0)))
        rc, out, _ = run_cli(["validate", "--data-dir", str(td35), "--debug-case", "0",
                              "--device", "cuda", "--report", str(td35 / "d.json")])
        best = json.loads((td35 / "d.json").read_text())["candidates"][0]
    finally:
        shutil.rmtree(td35, ignore_errors=True)
    if rc != 0 or abs(best["gain_abs"] - 0.8) >= 1e-3 or abs(best["gain_deg"] - 37.0) >= 0.1 \
            or not best["nmse_after_gain"] < 1e-9 < best["nmse"]:
        fail(f"validate --debug-case: rc {rc}, best candidate {best}")
    print(f"phase 35 validate --debug-case 0 on {dev}, golden scaled by 0.8 at 37 deg: recovered "
          f"{best['gain_abs']:.6f} at {best['gain_deg']:+.4f} deg, NMSE {best['nmse']:.3e} -> "
          f"{best['nmse_after_gain']:.3e} after the gain")

    # 36. the native batch packer (srsran_ce_tpu_torch/native): built with g++,
    # the c2 B=128 chunk packed equal to numpy's, the host's packing time per
    # chunk, and the serving run's native packs counted
    from srsran_ce_tpu_torch import graphs
    from srsran_ce_tpu_torch.native import loader as native

    graphs.clear()
    if not native.available():
        fail("native.available() is false on the card: the native packer did not build")
    cases_n = [synthetic.make_case(seed=s, **C2) for s in SEEDS]
    probs_n = [prob_of(cases_n[i % len(cases_n)]) for i in range(128)]  # 128 allocations each
    rg_list = [p.received_rg for p in probs_n]
    pil_list = [p.pilots for p in probs_n]

    def numpy_pack(arrays):
        """The numpy branch of `serving._assemble` (the port's packing before)."""
        return np.stack([estimator.split_ri(np.asarray(a).astype(np.complex64)) for a in arrays])

    for label, arrays in (("grids", rg_list), ("pilots", pil_list)):
        a, b = native.assemble_batch_ri(arrays), numpy_pack(arrays)
        if not (a.shape == b.shape and np.array_equal(a, b)):
            fail(f"native assemble_batch_ri of the c2 B=128 {label} differs from numpy's")

    def host_ms(fn, n=15):
        fn()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    t_pack_np = host_ms(lambda: (numpy_pack(rg_list), numpy_pack(pil_list)))
    t_pack_nat = host_ms(lambda: (native.assemble_batch_ri(rg_list),
                                  native.assemble_batch_ri(pil_list)))

    def stage_before():
        """The route before the native packer: the numpy branch, then a fresh pinned
        copy of each batch."""
        for arrays in (rg_list, pil_list):
            torch.from_numpy(numpy_pack(arrays)).pin_memory().to(dev, non_blocking=True)
        torch.cuda.synchronize()

    def stage_after():
        serving._batch_inputs(probs_n, list(range(128)), dev, multi_rx=False)
        torch.cuda.synchronize()

    t_stage_before, t_stage_after = host_ms(stage_before), host_ms(stage_after)
    grid_h = fn_c2(*c2_args).channel_est_rg.cpu().numpy()  # (128, 2, 4, 14, 1272) float32

    def merge_np(x):
        out = np.empty(x.shape[:1] + x.shape[2:], np.complex64)
        out.real, out.imag = x[:, 0], x[:, 1]
        return out

    if not np.array_equal(native.ri_to_complex(grid_h), merge_np(grid_h)):
        fail("native ri_to_complex of the c2 serve grid differs from numpy's")
    t_merge_np, t_merge_nat = host_ms(lambda: merge_np(grid_h)), host_ms(
        lambda: native.ri_to_complex(grid_h))
    native.packs = native.merges = 0
    serving.process(probs_n * 2, batch_size=128, device=dev)
    torch.cuda.synchronize()
    if native.packs < 4 or native.merges < 2:
        fail(f"serving.process on the card: {native.packs} native packs, {native.merges} merges "
             "(expected >= 4 and >= 2: the native branch did not run)")
    print(f"phase 36 native packer built (g++, {native._target().name}); c2 B=128 chunk packed "
          f"equal to numpy (grids {tuple(numpy_pack(rg_list[:1]).shape[1:])}, pilots); host ms a "
          f"chunk, grids + pilots: numpy {t_pack_np:.3f}, native {t_pack_nat:.3f}; packed and "
          f"staged to the card: before (numpy + a fresh pinned copy) {t_stage_before:.3f}, after "
          f"(native into a pinned buffer) {t_stage_after:.3f}; merge of the serve grid "
          f"(72.9 MB): numpy {t_merge_np:.3f}, native {t_merge_nat:.3f}; serving.process 256 c2 "
          f"problems: {native.packs} native packs, {native.merges} merges {card}")

    # 37. one CUDA graph per builder call: for each builder, the replay against
    # the eager call (graphs.eager()) on the same inputs, bit for bit
    # (torch.equal), the kernels of one replay (torch.profiler, by name) and the
    # launch counters equal to the eager call's, a result held across the next
    # call unchanged, then wall (back to back), CUDA-event ms (cold L2), device
    # busy and idle share before (eager) and after (graphed)
    K_RE = re.compile(r"\b(front_kernel|fill_rotate_serve_kernel|rc_smooth_kernel|"
                      r"fill_rotate_kernel|flooding_kernel|layered_kernel|inpaint_kernel)\b")

    def eager_of(fn):
        def run(*a):
            with graphs.eager():
                return fn(*a)
        return run

    def leaves(res):
        if isinstance(res, (tuple, list)):
            return [t for r in res for t in leaves(r)]
        if dataclasses.is_dataclass(res):
            return leaves([getattr(res, f.name) for f in dataclasses.fields(res)])
        return [res]

    def device_ops(call):
        """{device operation name: count} of one call (torch.profiler): a
        session now and then misses a kernel (three sessions in a row have
        missed K1's cluster launch), so each name's count is the most that
        any of five sessions (one call each) saw."""
        ops = {}
        for _ in range(5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                    ops[e.key] = max(ops.get(e.key, 0), e.count)
        if not ops:
            fail("the profiler saw no device operation in 5 sessions")
        return ops

    def kernel_counts(call):
        """({our kernel name: launches}, device operations) of one call (torch.profiler)."""
        ops = device_ops(call)
        kc = {}
        for key, n in ops.items():
            m = K_RE.search(key)
            if m:
                kc[m.group(1)] = kc.get(m.group(1), 0) + n
        return kc, sum(ops.values())

    def busy_ms(fn, args):
        return sum(kernel_ms(lambda: fn(*args), 20,
                             (ProfilerActivity.CPU, ProfilerActivity.CUDA)).values())

    graph_rows = {}

    def replayed_run(label, run):
        """`run()` once (each key's first call, eager), then again, its result
        returned: every graphed call of the second run must replay."""
        run()
        k0, r0 = graphs.calls, graphs.replays
        out = run()
        torch.cuda.synchronize()
        n_calls, n_rep = graphs.calls - k0, graphs.replays - r0
        if n_calls == 0 or n_rep != n_calls:
            fail(f"{label}: {n_rep} of {n_calls} graphed calls replayed (expected all)")
        return out

    def same_results(label, got, want):
        """Every field of every result equal, nested results (a decoded
        result's soft bits) field by field: arrays with np.array_equal,
        scalars with ==, None with None."""
        def same(a, b):
            if dataclasses.is_dataclass(a):
                return all(same(getattr(a, f.name), getattr(b, f.name))
                           for f in dataclasses.fields(a))
            return np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b

        if len(got) != len(want):
            fail(f"{label}: {len(got)} results, the eager route {len(want)}")
        for g, w in zip(got, want):
            for f in dataclasses.fields(g):
                if not same(getattr(g, f.name), getattr(w, f.name)):
                    fail(f"{label}: {f.name} differs from the eager route")

    def graph_phase(label, fn, args, other):
        want = eager_of(fn)(*args)
        fn(*args)  # a key's first call runs eagerly (the warm-up)
        fn(*args)  # its second captures and replays
        r0 = graphs.replays
        reset_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        g_cnt = read_counts()
        if graphs.replays != r0 + 1:
            fail(f"graphs {label}: the call did not replay a graph")
        reset_counts()
        eager_of(fn)(*args)
        torch.cuda.synchronize()
        e_cnt = read_counts()
        if not all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want))):
            fail(f"graphs {label}: the replay differs from the eager call")
        held = [t.clone() for t in leaves(got)]
        fn(*other)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(leaves(got), held)):
            fail(f"graphs {label}: a held result changed on the next call")
        kc_e, n_e = kernel_counts(lambda: eager_of(fn)(*args))
        kc_g, n_g = kernel_counts(lambda: fn(*args))
        if kc_e != kc_g or g_cnt != e_cnt:
            fail(f"graphs {label}: kernels of one replay {kc_g} / counters {g_cnt} differ from "
                 f"the eager call's {kc_e} / {e_cnt}")
        ev_e, wall_e = call_ms(eager_of(fn), args)
        busy_e = busy_ms(eager_of(fn), args)
        ev_g, wall_g = call_ms(fn, args)
        busy_g = busy_ms(fn, args)
        idle = lambda b, w: 100 * (1 - b / w)
        graph_rows[label] = (wall_e, ev_e, busy_e, idle(busy_e, wall_e), wall_g, ev_g, busy_g,
                             idle(busy_g, wall_g), n_e, n_g)
        print(f"phase 37 graphs {label}: replay bit-identical to eager, a held result unchanged; "
              f"our kernels a call {kc_g} (profiler, eager the same), counters {g_cnt}; device "
              f"operations a call eager {n_e} / graphed {n_g}; before (eager) wall "
              f"{wall_e:.4f} ms, events {ev_e:.4f} ms, busy {busy_e:.4f} ms, idle "
              f"{idle(busy_e, wall_e):.1f} %; after (graphed) wall {wall_g:.4f} ms, events "
              f"{ev_g:.4f} ms, busy {busy_g:.4f} ms, idle {idle(busy_g, wall_g):.1f} % {card}")

    roll = lambda args: tuple(a.roll(1, 0) if torch.is_tensor(a) else a for a in args)
    graph_phase("pallas_front/serve c2 B=128", fn_c2, c2_args, roll(c2_args))
    grid_c2 = fn_c2(*c2_args).channel_est_rg
    t_clone = time_ms(lambda: grid_c2.clone(), cold=False)
    print(f"phase 37 the output clone of a replay: the c2 serve grid "
          f"({grid_c2.numel() * 4 / 1e6:.1f} MB) {t_clone:.4f} ms back to back on CUDA events "
          f"(bound {2 * grid_c2.numel() * 4 / PEAK_BPS * 1e3:.4f} ms) {card}")
    del grid_c2
    graph_phase("pallas/ref c2 B=128", fn_pref, args_c2, roll(args_c2))
    _, _, _, fn_c4, args_c4 = run_path(C4, 256, "pallas", "ref")
    graph_phase("pallas/ref c4 B=256", fn_c4, args_c4, roll(args_c4))
    graph_phase("pallas/serve c2 B=128", fn_pserve, args_c2, roll(args_c2))
    graph_phase("xla/serve c2 B=128", fns_xla["serve"], args_c2, roll(args_c2))
    graph_phase("xla/ref c2 B=128", fns_xla["ref"], args_c2, roll(args_c2))
    graphs.clear()
    cases_l, cfg_l, rg_l, pil_l, beta_l = tiled(C2L, 128)
    fn_l = estimator.build_ri(cases_l[0].hop1, cases_l[0].hop2, cfg_l, 4, batched=True,
                              kernels="pallas", out_layout="serve")
    graph_phase("learned c2 pallas/serve B=128", fn_l, (rg_l, pil_l, beta_l, params1),
                (rg_l.roll(1, 0), pil_l, beta_l, params1))
    # the cuDNN algorithms chosen at the warm-up are frozen into the graph:
    # the convolution kernels of one replay, by name (IEEE f32: no tf32)
    conv_ops = {k: n for k, n in device_ops(lambda: fn_l(rg_l, pil_l, beta_l, params1)).items()
                if re.search(r"conv|fprop|dgrad|implicit_gemm|winograd|fft|nhwc|nchw", k, re.I)}
    if not conv_ops or any("tf32" in k.lower() for k in conv_ops):
        fail(f"graphs learned c2: the replay's convolution kernels {sorted(conv_ops)} (expected "
             "some, none of them tf32)")
    print(f"phase 37 graphs learned c2 pallas/serve B=128: the denoiser's convolutions run with "
          f"torch.backends.cudnn.allow_tf32 = False (models/denoiser._no_tf32_conv); the "
          f"cuDNN kernels frozen into the graph at capture, a replay: " + "; ".join(
              f"{k} x{n}" for k, n in sorted(conv_ops.items())) + f" {card}")
    fn_t, t_args, _ = tracked_fns["c2"]
    s_g = s_e = t_args[3:]
    r0 = graphs.replays
    for slot in range(3):
        a = tuple(x.roll(slot, 0) for x in t_args[:3])
        got, *s_g = fn_t(*a, *s_g)
        want, *s_e = eager_of(fn_t)(*a, *s_e)
        if not all(torch.equal(x, y) for x, y in zip(leaves((got, s_g)), leaves((want, s_e)))):
            fail(f"graphs tracked serve c2: slot {slot} (result or state) differs from eager")
    if graphs.replays - r0 != 2:
        fail(f"graphs tracked serve c2: {graphs.replays - r0} replays over 3 slots (expected 2: "
             "the first slot eager, the second the capture's replay, the third a replay)")
    print(f"phase 37 graphs tracked serve c2 B=128: 3 slots with the state threaded, slots 1 and "
          f"2 replayed, graphed results and states bit-identical to eager (w "
          f"{float(s_g[1].min()):.0f})")
    graph_phase("tracked serve c2 B=128 (a slot)", fn_t, t_args, roll(t_args))
    graphs.clear()
    graph_phase(f"receiver c2_receiver_4rx4l auto/xla B={B_RX}", rx_fns[("auto", "xla")],
                (rx_rg, rx_pil, rx_beta), roll((rx_rg, rx_pil, rx_beta)))
    graphs.clear()
    e2e_g = replayed_run("graphs e2e decoded device path", lambda: run_slots(8, True)[1])
    with graphs.eager():
        e2e_e = run_slots(8, True)[1]
    same_results("graphs e2e decoded device path", e2e_g, e2e_e)
    walls = {}
    for mode in ("eager", "graphed", "eager", "graphed", "eager", "graphed"):
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            walls.setdefault(mode, []).append(run_slots(8, True)[0] * 1e3)
    busy_e2e = {}
    for mode in ("eager", "graphed"):
        ctx = graphs.eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            ms = kernel_ms(lambda: run_slots(8, True), 3, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
        busy_e2e[mode] = sum(ms.values())
    graph_rows["e2e decoded device path, 8 slots"] = tuple(
        v for mode in ("eager", "graphed") for v in (
            min(walls[mode]), float("nan"), busy_e2e[mode],
            100 * (1 - busy_e2e[mode] / min(walls[mode])))) + (0, 0)
    print(f"phase 37 graphs e2e decoded device path, 8 slots (273 PRB, BG1 Z=384): payloads, ok "
          f"and scalars bit-identical to eager; wall a call (min of 3) eager "
          f"{min(walls['eager']):.3f} ms, graphed {min(walls['graphed']):.3f} ms; device busy "
          f"eager {busy_e2e['eager']:.3f} ms, graphed {busy_e2e['graphed']:.3f} ms; idle eager "
          f"{graph_rows['e2e decoded device path, 8 slots'][3]:.1f} %, graphed "
          f"{graph_rows['e2e decoded device path, 8 slots'][7]:.1f} % {card}")
    print(f"phase 37 graphs kept {graphs.cached()} (of {graphs.MAX_GRAPHS}), captured in this run "
          f"{graphs.captures}, replayed {graphs.replays}; device memory reserved "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB")

    # 38. serving.process end to end on the card: the graphed route against the
    # eager one (graphs.eager(), the route before this change) for grid,
    # factored and decoded (host and device paths), bit for bit
    graphs.clear()
    n_rep38 = graphs.replays
    for out in ("grid", "factored"):
        cs = [c for c in g_cases if out == "grid" or c.config.time_interp == "none"]
        got = replayed_run(f"process(out={out!r})", lambda: serving.process(
            [prob_of(c) for c in cs], batch_size=4, out=out, device=dev))
        with graphs.eager():
            want = serving.process([prob_of(c) for c in cs], batch_size=4, out=out, device=dev)
        same_results(f"process(out={out!r}) graphed", got, want)
    for on_device in (False, True):
        got = replayed_run(f"process(out='decoded', decode_on_device={on_device})",
                           lambda: run_slots(8, on_device)[1])
        with graphs.eager():
            want = run_slots(8, on_device)[1]
        same_results(f"process(out='decoded', decode_on_device={on_device}) graphed", got, want)
    print(f"phase 38 serving.process on {dev}: grid ({len(g_cases)} problems, 4 signatures), "
          f"factored and decoded (host and device paths, 8 e2e slots): each route called once "
          f"(eager, the warm-up), then again with every graphed call a replay "
          f"({graphs.replays - n_rep38} replays in all), bit-identical to the eager route in "
          f"every field, the scalars included")

    # 39. `cli diagnose --device cuda`, per problem and with the main path's
    # batched serve call (pallas_front)
    for argv, n in ((["diagnose", "--device", "cuda"], 1),
                    (["diagnose", "--device", "cuda", "--batched", "--kernels", "pallas_front"], 2)):
        rc, out, wall_dg = run_cli(argv)
        if rc != 0 or out.count("graph_count: 1 ") != n or out.count("bit-identical") != n \
                or "offload verdict: fully offloadable" not in out:
            fail(f"cli {' '.join(argv)}: rc {rc}")
        print(f"phase 39 cli {' '.join(argv)}: rc 0, graph_count: 1 for each of {n} call(s), "
              f"replays bit-identical, {wall_dg:.2f} s wall")

    # 40. a traffic mix: graphs pay off only where a key (builder, batch,
    # shapes) comes again, and a key's first call stays eager. 11 signatures,
    # a Zipf share each, 1-48 requests a call in chunks of up to 16, so the
    # tails' batch sizes vary; the same 30 calls eager and graphed in turn,
    # three times each, the graphs kept from one graphed pass to the next
    mix_specs = ([dict(n_prbs=p, n_layers=nl) for p in (24, 52, 106) for nl in (1, 2, 4)]
                 + [dict(n_prbs=12, n_layers=1, two_hops=True), dict(n_prbs=273, n_layers=2)])
    mix_probs = [[prob_of(synthetic.make_case(seed=400 + 10 * j + i, snr_db=30.0, **sp))
                  for i in range(2)] for j, sp in enumerate(mix_specs)]
    rng = np.random.default_rng(40)
    share = 1.0 / np.arange(1, len(mix_specs) + 1)
    share /= share.sum()
    mix_calls = []
    for _ in range(30):
        sigs = rng.choice(len(mix_specs), size=int(rng.integers(1, 49)), p=share)
        mix_calls.append([mix_probs[j][int(rng.integers(2))] for j in sigs])
    n_req = sum(len(c) for c in mix_calls)

    def run_mix():
        t0 = time.perf_counter()
        for probs in mix_calls:
            serving.process(probs, batch_size=16, device=dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    graphs.clear()
    mix = []  # (mode, ms, graphed calls, captures, replays of a kept graph)
    for mode in ("eager", "graphed", "eager", "graphed", "eager", "graphed"):
        k0, c0, r0 = graphs.calls, graphs.captures, graphs.replays
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            ms = run_mix()
        caps = graphs.captures - c0
        mix.append((mode, ms, graphs.calls - k0, caps, graphs.replays - r0 - caps))
    e_ms = [m[1] for m in mix if m[0] == "eager"]
    g = [m for m in mix if m[0] == "graphed"]
    print(f"phase 40 traffic mix: {len(mix_calls)} serving.process calls, {n_req} requests over "
          f"{len(mix_specs)} signatures (Zipf shares), chunks of up to 16, passes in turn eager / "
          f"graphed (from no graph, then with the graphs kept): wall eager "
          f"{[round(x, 1) for x in e_ms]} ms, graphed {[round(m[1], 1) for m in g]} ms; of each "
          f"graphed pass's builder calls, replays of a kept graph / captures / eager first "
          f"calls: " + ", ".join(f"{m[4]} / {m[3]} / {m[2] - m[4] - m[3]} of {m[2]} "
                                 f"({100 * m[4] / max(m[2], 1):.1f} % replayed)" for m in g)
          + f"; at most {graphs.MAX_GRAPHS} graphs kept {card}")

    # 41. the sharded paths (srsran_ce_tpu_torch/parallel/) over NCCL at world
    # size 1, in this process: every builder of the slice at full width against
    # the unsharded port on the same card and dtype, graphed replays against
    # eager, K3 / K4 launched by the DP decoder
    import socket

    import torch.distributed as tdist

    from srsran_ce_tpu_torch import entry
    from srsran_ce_tpu_torch.parallel import comm as pcomm
    from srsran_ce_tpu_torch.parallel import data_parallel, launch
    from srsran_ce_tpu_torch.parallel import mesh as pmesh
    from srsran_ce_tpu_torch.validation import sharded

    graphs.clear()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        free_port = sock.getsockname()[1]
    pmesh.multihost_initialize(f"localhost:{free_port}", 1, 0)
    if tdist.get_backend() != "nccl" or tdist.get_world_size() != 1:
        fail(f"phase 41: world {tdist.get_backend()} x {tdist.get_world_size()}, expected nccl x 1")
    g384 = ldpc.default_layered_group(code384)
    dec_k3 = dict(schedule="layered", layered_group=g384, stream_c2v_dtype="bfloat16")
    # bench_scaling.py's cases (measure_config4, seed 88; measure_sp_wideband,
    # seed 99), problem k of a batch scaled by 1 + 0.01 k (`sharded.case_inputs`)
    C4_KW = dict(n_prbs=24, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0, two_hops=True)
    W273 = dict(n_prbs=273, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0)
    f32 = dict(dtype="float32")
    specs41 = [
        dict(name="build_dp_batched c2 ref B=128", kind="dp_batched", mesh=(1, 1), kw=C2, seed=11,
             batch=128, **f32),
        dict(name="build_dp_batched c2 factored B=128", kind="dp_batched", mesh=(1, 1), kw=C2,
             seed=11, batch=128, layout="factored", **f32),
        dict(name="build_dp_receiver c2_receiver_4rx4l 16qam B=128", kind="dp_receiver",
             mesh=(1, 1), kw=C2_RX, seed=11, n_rx=N_RX, batch=128, modulation="16qam", **f32),
        dict(name="build_dp_decoder BG1 Z=384 layered bf16 B=24 (K3)", kind="dp_decoder",
             mesh=(1, 1), code=("nr", 1, 384), batch=24, n_iters=16, dec=dec_k3),
        dict(name="build_dp_decoder n976 B=512 (K4)", kind="dp_decoder", mesh=(1, 1),
             code=("array", 6, 16, 61), batch=512, n_iters=25),
        dict(name="build_sp_batched c4_hopped_24prb B=4096", kind="sp_batched", mesh=(1, 1),
             kw=C4_KW, seed=88, batch=4096, **f32),
        dict(name="build_sp_batched sp_wideband_273prb B=2", kind="sp_batched", mesh=(1, 1),
             kw=W273, seed=99, batch=2, **f32),
        dict(name="build_sp sp_wideband_273prb", kind="sp", mesh=(1, 1), kw=W273, seed=99, **f32),
        dict(name="build_sp_batched factored c2 B=128", kind="sp_batched", mesh=(1, 1), kw=C2,
             seed=11, batch=128, layout="factored", **f32),
        dict(name="build_sp_receiver c2_receiver_4rx4l qpsk B=16", kind="sp_receiver",
             mesh=(1, 1), kw=C2_RX, seed=11, n_rx=N_RX, batch=16, modulation="qpsk", **f32),
        dict(name="build_sp_tracked c2 (3 slots)", kind="sp_tracked", mesh=(1, 1), kw=C2, seed=11,
             noise_seeds=[1, 2, 3], **f32),
        dict(name="build_train_step(mesh) 1-D B=256", kind="train", mesh=(1, 1), batch=256,
             n_re=128, steps=2, **f32),
        dict(name="all_device_barrier / Heartbeat", kind="barrier"),
        dict(name="entry.dryrun_body", kind="dryrun"),
    ]
    t41 = time.perf_counter()
    r41 = sharded.run_cases(specs41, "cuda", True)
    # the DP decoder's launches: counts set to 0 just before one call, read just after
    mesh1 = pmesh.make_mesh((1, 1))
    for code, batch, kw in ((code384, 24, dict(n_iters=16, **dec_k3)),
                            (ldpc_rows[0][1], 512, dict(n_iters=25))):
        plan_d, u_d, ch_d = words(code, batch, 3.5 if code is code384 else 4.0)
        dec_dp = data_parallel.build_dp_decoder(code, mesh1, device=dev, **kw)
        dec_dp(ch_d)
        torch.cuda.synchronize()
        reset_counts()
        res_d = dec_dp(dec_dp.shard(ch_d))
        torch.cuda.synchronize()
        cnt = read_counts()
        want_n = (0, 1) if code is code384 else (1, 0)
        if (cnt["ldpc_posterior"], cnt["ldpc_stream_posterior"]) != want_n:
            fail(f"phase 41 build_dp_decoder launches {cnt}, expected (K4, K3) = {want_n}")
        if not (bool(res_d.ok.all()) and np.array_equal(res_d.info.cpu().numpy(), u_d)):
            fail("phase 41 build_dp_decoder: not payload-exact")
        for k in ldpc_launches:
            ldpc_launches[k] += cnt[k]
        print(f"phase 41 build_dp_decoder {dec_dp.local.tier} B={batch}: launches of one call "
              f"K4 {cnt['ldpc_posterior']}, K3 {cnt['ldpc_stream_posterior']}, payload-exact")
    tdist.destroy_process_group()

    def report(phase, name, r, f64=False):
        """One sharded builder's line; fails on any comparison out of bounds."""
        if "rel" in r:
            worst = max(v for k, v in r["rel"].items() if k != "llr")
            bound = 1e-12 if f64 else 1e-4  # float32: phase 22's receiver bar
            if "llr" in r["rel"]:
                if r["llr_max_step"] > 1 or r["llr_diff_share"] > 1e-3:
                    fail(f"phase {phase} {name}: LLRs {r['llr_max_step']} steps apart on "
                         f"{r['llr_diff_share']:.2e} of the entries")
            elif worst > bound:
                fail(f"phase {phase} {name}: relative error {worst:.3e} against the unsharded "
                     f"port (bound {bound})")
        if "nmse_vs_oracle" in r and r["nmse_vs_oracle"] >= (1e-18 if f64 else REF_NMSE_BOUND):
            fail(f"phase {phase} {name}: NMSE vs the float64 oracle {r['nmse_vs_oracle']:.3e}")
        if r.get("graph_replayed") is False or r.get("graphed_equal") is False:
            fail(f"phase {phase} {name}: graphed replay {r.get('graph_replayed')}, equal to "
                 f"eager {r.get('graphed_equal')}")
        if "payload_exact" in r and not (r["payload_exact"] and r["ok"] and r["bit_identical"]):
            fail(f"phase {phase} {name}: decode {r}")
        if "loss_rel" in r and (r["loss_rel"] > 1e-5 or r["params_rel"] > 1e-5):
            fail(f"phase {phase} {name}: DP step vs the unsharded step {r}")
        parts = []
        if "bit_identical" in r:
            parts.append("bit-identical to the unsharded port" if r["bit_identical"] else
                         f"max relative error vs the unsharded port "
                         f"{max(r['rel'].values()):.3e}")
        elif "rel" in r:
            parts.append(f"max relative error vs the unsharded port {max(r['rel'].values()):.3e}")
        if "nmse_vs_oracle" in r:
            parts.append(f"NMSE vs the float64 oracle {r['nmse_vs_oracle']:.3e}")
        if "llr_max_step" in r:
            parts.append(f"LLRs within {r['llr_max_step']} step on {r['llr_diff_share']:.2e}")
        if "graphed_equal" in r:
            parts.append("graphed replay bit-identical to eager")
        if "loss_rel" in r:
            parts.append(f"loss rel {r['loss_rel']:.2e}, params rel {r['params_rel']:.2e} vs the "
                         f"unsharded step")
        if "ms" in r:
            parts.append(f"{r['ms']:.4f} ms a call (wall, synchronised, best of 5) against the "
                         f"unsharded {r['unsharded_ms']:.4f} ms")
        print(f"phase {phase} {name}: " + "; ".join(parts) + f" {card}")

    for spec in specs41:
        r = r41[spec["name"]]
        if spec["kind"] == "barrier":
            if not (r["healthy"] and r["rounds"] >= 1 and r["failure"] == (False, ["injected"])):
                fail(f"phase 43 barrier / heartbeat over NCCL: {r}")
            print(f"phase 43 all_device_barrier over NCCL x 1: {r['barrier_s'] * 1e3:.3f} ms; "
                  f"Heartbeat (its own gloo group) {r['rounds']} rounds healthy, last "
                  f"{r['latency'] * 1e3:.3f} ms; the failure path fires")
        elif spec["kind"] == "dryrun":
            print(f"phase 41 {r}")
        else:
            report(41, spec["name"], r)
    print(f"phase 41 NCCL world 1: halo routes {dict(pcomm.halo_routes)}, graphs captured "
          f"{graphs.captures}, replayed {graphs.replays}; {time.perf_counter() - t41:.1f} s")

    # 42. spawned gloo worlds of 2 and 4 ranks on cuda:0 (NCCL refuses two ranks
    # on one card): every halo, psum and all_gather on the card, eagerly
    specs42 = lambda n: [
        dict(name="build_sp sp_wideband_273prb float64", kind="sp", mesh=(1, n), kw=W273,
             seed=13),
        dict(name="build_sp sp_wideband_273prb float32", kind="sp", mesh=(1, n), kw=W273,
             seed=13, **f32),
        dict(name=f"build_sp_batched c4_hopped_24prb B=4096 mesh {(n // 2, 2)}",
             kind="sp_batched", mesh=(n // 2, 2), kw=C4_KW, seed=88, batch=4096, **f32),
        dict(name="build_sp_batched c4_hopped_24prb float64 B=64", kind="sp_batched",
             mesh=(1, n), kw=C4_KW, seed=88, batch=64),
        dict(name="build_dp_batched c2 B=128", kind="dp_batched", mesh=(n, 1), kw=C2, seed=11,
             batch=128, **f32),
        dict(name="build_dp_decoder n976 B=512 (K4)", kind="dp_decoder", mesh=(n, 1),
             code=("array", 6, 16, 61), batch=512, n_iters=25),
        dict(name="build_dp_decoder BG1 Z=384 bf16 B=24 (K3)", kind="dp_decoder", mesh=(n, 1),
             code=("nr", 1, 384), batch=24, n_iters=16, dec=dec_k3),
        dict(name="all_device_barrier / Heartbeat", kind="barrier"),
        dict(name="entry.dryrun_body", kind="dryrun"),
    ]
    for n in (2, 4):
        t42 = time.perf_counter()
        r42 = launch.spawn_world(sharded.run_cases, n, "gloo", "cuda", args=(specs42(n), "cuda", True))[0]
        for spec in specs42(n):
            r = r42[spec["name"]]
            if spec["kind"] == "barrier":
                if not (r["healthy"] and r["rounds"] >= 1):
                    fail(f"phase 43 barrier / heartbeat over gloo x {n}: {r}")
                print(f"phase 43 all_device_barrier over gloo x {n} (cuda:0): "
                      f"{r['barrier_s'] * 1e3:.3f} ms; Heartbeat {r['rounds']} rounds healthy")
            elif spec["kind"] == "dryrun":
                print(f"phase 42 {r}")
            else:
                report(42, f"gloo x {n}: {spec['name']}", r, f64=spec.get("dtype") != "float32")
        if r42["_foreign_modules"]:
            fail(f"phase 42: a rank imported {r42['_foreign_modules']}")
        print(f"phase 42 gloo x {n} on cuda:0: halo routes {r42['_halo_routes']} (gloo's send/recv "
              f"take no CUDA tensor), {time.perf_counter() - t42:.1f} s with the spawn")

    # 43. the deep fuzz's sharded sweep on the card (one spawned world per
    # shard count among the draws)
    rc, out, wall_sp = run_cli(["selftest", "--deep", "--geometry-n", "1", "--coded-n", "1",
                                "--header-n", "1", "--sp-n", "6", "--device", "cuda",
                                "--report", str(Path(tempfile.gettempdir()) / "deep_sp.json")])
    if rc != 0 or "sp: 6/6 pass" not in out:
        fail(f"phase 43 selftest --deep --sp-n 6: rc {rc}")
    print(f"phase 43 selftest --deep --sp-n 6 on the card: 6/6 pass, {wall_sp:.1f} s wall")

    # 44. `cli bench --device cuda`, whole: every row of bench.py at its widths,
    # every gate, the headline; the kernels' launches over the run
    from srsran_ce_tpu_torch.bench import scaling as bscaling
    from srsran_ce_tpu_torch.bench import throughput as bthroughput

    graphs.clear()
    torch.cuda.empty_cache()
    out44 = Path(tempfile.mkdtemp(prefix="smoke_bench_")) / "details.json"
    reset_counts()
    rc, out, wall44 = run_cli(["bench", "--device", "cuda", "--out", str(out44)])
    torch.cuda.synchronize()
    cnt44 = read_counts()
    if rc != 0:
        fail(f"phase 44 cli bench: rc {rc}")
    head = json.loads(out.strip().splitlines()[-1])
    if not (head.get("unit") == "REs/s" and head.get("value", 0) > 0):
        fail(f"phase 44 cli bench: headline {head}")
    det = json.loads(out44.read_text())
    want_rows = ([n for n, _ in bthroughput.row_specs(None)] + ["ldpc_decode_n976_b512"]
                 + [r[0] for r in bthroughput.NR_ROWS] + [r[0] for r in bthroughput.STREAM_ROWS]
                 + ["e2e_decoded_273prb_bg1z384"])
    missing = [n for n in want_rows if n not in det["configs"]]
    errors = {n: r["error"] for n, r in det["configs"].items() if "error" in r}
    if missing or errors:
        fail(f"phase 44 cli bench: rows missing {missing}, rows failed {errors}")
    # the kernels bench.py's rows run: K1 (_pallas_front), K2 (_pallas, _pallas_front),
    # K4 (n976, the auto rows), K3 (the streamed rows, e2e)
    not_run = [k for k in ("fused_front", "fused_fill_rotate_serve", "ldpc_posterior",
                           "ldpc_stream_posterior") if cnt44[k] == 0]
    if not_run:
        fail(f"phase 44 cli bench: kernels not launched {not_run} (launches {cnt44})")
    for n in want_rows:
        r = det["configs"][n]
        keep = {k: r[k] for k in ("latency_ms_per_batch", "latency_ms_per_slot", "batch",
                                  "slope_spread", "spread_warn", "escalations", "res_per_s",
                                  "info_bits_per_s", "bound", "x_over_bound", "hbm_floor_ms",
                                  "compute_floor_ms", "nmse_vs_oracle", "nmse_vs_oracle_serve",
                                  "tier", "device_decode_ms_per_slot", "xla_tier_ms_per_batch",
                                  "layered13_ms_per_batch", "layered_half_iters_ms_per_batch",
                                  "vs_reference_cpu") if k in r}
        print(f"phase 44 bench {n}: {json.dumps(keep)}")
    print(f"phase 44 cli bench --device cuda: exit 0, {len(want_rows)} rows of bench.py present, "
          f"none failed, every gate passed; headline {head['value']:.6e} REs/s (vs the torch-CPU "
          f"reference {head['vs_baseline']:.1f}x, measured on {head['baseline_hardware']!r}); "
          f"launches over the run {cnt44}; {wall44:.1f} s wall; {det['device']['nvidia_smi']} "
          f"{card}")

    # 45. `cli scaling --device cuda`: NCCL worlds of up to the card count
    out45 = Path(tempfile.mkdtemp(prefix="smoke_scaling_")) / "scaling.json"
    rc, out, wall45 = run_cli(["scaling", "--device", "cuda", "--out", str(out45)])
    if rc != 0:
        fail(f"phase 45 cli scaling: rc {rc}")
    rep = json.loads(out45.read_text())
    n_cards = torch.cuda.device_count()
    run_sizes = [n for n in bscaling.WORLD_SIZES if n <= n_cards]
    got = {(e["scenario"], e.get("n_devices")) for e in rep["entries"] if "error" not in e}
    want = ({("dp_weak", n) for n in run_sizes} | {("sp_wideband_273prb", n) for n in run_sizes}
            | {("config4_hopped_4096", 1), ("dp_baselines", None)})
    skipped = [n for n in bscaling.WORLD_SIZES if n > n_cards]
    if not want <= got or rep["meta"]["world_sizes"] != run_sizes or (
            skipped and (rep["meta"]["not_run"] or {}).get("world_sizes") != skipped):
        fail(f"phase 45 cli scaling: rows {sorted(got, key=str)}, meta {rep['meta']}")
    for e in rep["entries"]:
        print(f"phase 45 scaling {json.dumps(e)}")
    print(f"phase 45 cli scaling --device cuda: exit 0, worlds {run_sizes} (NCCL), not run "
          f"{rep['meta']['not_run']}; {wall45:.1f} s wall {card}")

    sources = {"fused_front": ("srsran_ce_tpu_torch/csrc/front.cu",
                               "srsran_ce_tpu/ops/pallas/kernels.py:639"),
               "fused_fill_rotate_serve": ("srsran_ce_tpu_torch/csrc/fill_rotate_serve.cu",
                                           "srsran_ce_tpu/ops/pallas/kernels.py:232"),
               "rc_smooth": ("srsran_ce_tpu_torch/csrc/rc_smooth.cu",
                             "srsran_ce_tpu/ops/pallas/kernels.py:786"),
               "fused_fill_rotate": ("srsran_ce_tpu_torch/csrc/fill_rotate.cu",
                                     "srsran_ce_tpu/ops/pallas/kernels.py:70"),
               "ldpc_posterior": ("srsran_ce_tpu_torch/csrc/ldpc.cu",
                                  "srsran_ce_tpu/ops/pallas/kernels.py:1220"),
               "ldpc_stream_posterior": ("srsran_ce_tpu_torch/csrc/ldpc_stream.cu",
                                         "srsran_ce_tpu/ops/pallas/kernels.py:1139"),
               "inpaint_stack": ("srsran_ce_tpu_torch/csrc/inpaint.cu",
                                 "srsran_ce_tpu/ops/pallas/kernels.py:852")}
    launches = dict(counts)
    launches.update({k: pallas_counts[k] for k in ("rc_smooth", "fused_fill_rotate")})
    launches.update(ldpc_launches)
    launches["inpaint_stack"] = k7_launches
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
         "launches": launches[k], "max_abs_err": results[k], "ms": times[k][0],
         "plain_ms": times[k][1], "bound_ms": times[k][4], "bound_by": times[k][5],
         "library_ms": library[k]}
        for k in sources
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
