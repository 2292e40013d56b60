"""Run one cell of the benchmark and print its result as one JSON line.

    python -m cebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (BENCHMARK.json beside `cebench/` and the
program, `srsran_ce_tpu_torch`). A run:

  1. reads the cell from BENCHMARK.json and its files (cebench/spec.py), and
     fails (exit 2) without a card, or with fewer cards than the cell asks for;
  2. set-up, timed as `setup_s` from the start of this process: the program
     imported and its kernel libraries loaded (built once into the checkout),
     the pool of distinct cell-slots made from the seed, and every call shape
     the cell's traffic uses warmed: eager, captured, replayed; what it built
     is then frozen out of the garbage collector's full collections;
  3. the window: the cell's traffic generator drives the program for
     `--seconds`, keeping the results of a sample of the calls drawn from the
     seed. With `--trace 0`, where the cell reports an end-to-end metric
     taken from the device (`source` "device_trace"), the whole window runs
     under torch.profiler with the CUDA activity alone. With `--trace 1` the
     window runs untraced (for the host-paced per-layer rates), and then a
     second one of `TRACE_SECONDS` under torch.profiler with every event;
  4. after the window: the device's peak memory, the check that no JAX module
     was loaded, then the sampled results judged against the reference
     (cebench/reference), each number compared beside its limit;
  5. the result line: `correct`, `attempted` and `failed` cell-slots, the
     cell's end-to-end metrics (`--trace 0`) or its per-layer metrics and the
     trace's breakdown (`--trace 1`), the device, and the numbers compared,
     last.

Exit codes: 0 with a result line; 1 when the run failed; 2 when the cell,
the card or the program is not there.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402

import numpy as np  # noqa: E402

from cebench import spec  # noqa: E402
from cebench.window import clock  # noqa: E402

#: the traced run's window (s): a trace of every call of a long window would
#: take longer to read than a run may last
TRACE_SECONDS = 4.0
#: calls whose results are kept and judged (a reservoir drawn from the seed)
KEEP_CALLS = 32
#: calls made of each warmed shape: eager, captured (and replayed), replayed
WARM_CALLS = 3
#: top-level module names no run may load (JAX and the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "srsran_ce_tpu")
PROGRAM = "srsran_ce_tpu_torch"
CACHE_DIR = ".cebench_cache"


def forbidden_modules() -> list:
    """The forbidden top-level names in sys.modules, compared whole (the
    program's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin_caches(root: str) -> None:
    """Every compile cache at a fixed directory inside the checkout."""
    base = os.path.join(os.path.abspath(root), CACHE_DIR)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


class Reservoir:
    """A uniform sample of `k` calls' (slot ids, results), drawn from `rng`."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


@dataclass
class TraceContext:
    """What a metric's reader (cebench/metrics/<name>.py) reads."""

    cell: spec.Cell
    window: object  # window.Window: the timed window, or with --trace 1 the traced one
    device_name: str
    timeline: object = None  # --trace 1: trace.Timeline of the traced window
    counters: dict = None  # --trace 1: the program's counters' deltas over the traced window
    host_window: object = None  # --trace 1: the untraced window run before the traced one
    device_time: object = None  # --trace 0: trace.DeviceTime of the whole window, where asked


def program_counters() -> dict:
    """The program's graph counters and its kernels' launch counters."""
    from srsran_ce_tpu_torch import graphs

    out = {f"graphs.{n}": int(getattr(graphs, n)) for n in ("calls", "captures", "replays")}
    for m in graphs.kernel_modules():
        out["launches." + m.__name__.rsplit(".", 1)[-1]] = int(m.launches)
    return out


def judge(cell: spec.Cell, chain, pool, kept):
    """(numbers, failed slots, judged slots) of the kept calls: each slot's
    numbers against its reference (`chain.reference`), summed or maxed."""
    ref_mod = chain.reference
    refs = {}
    per_slot = []
    for slot_ids, results in kept:
        for sid, res in zip(slot_ids, results):
            if sid not in refs:
                refs[sid] = ref_mod.reference(pool[sid])
            per_slot.append(ref_mod.judge_slot(pool[sid], res, refs[sid]))
    limits = cell.config["limits"]
    numbers = {}
    for name, how in ref_mod.AGGREGATE.items():
        vals = [float(n[name]) for n in per_slot]
        numbers[name] = (sum(vals) if how == "sum" else max(vals)) if vals else float("inf")
    failed = sum(any(not (n[k] <= limits[k]) for k in ref_mod.AGGREGATE) for n in per_slot)
    return numbers, failed, len(per_slot)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, log=print) -> dict:
    """One run of `cell`: the result line's object (see the module's doc)."""
    t_start = T_START if t_start is None else t_start
    cfg, mix = cell.config, cell.traffic
    chain = spec.load_module("chains", cfg["chain"])
    traffic = spec.load_module("traffic", mix["kind"])
    import torch

    n_pool = traffic.pool_slots(mix)
    pool = [chain.make_slot(cfg, seed, i) for i in range(n_pool)]
    serve_raw = chain.server(cfg, pool, device)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for b in traffic.warm_batches(mix):
        for _ in range(WARM_CALLS):
            serve_raw([j % n_pool for j in range(b)])
    sync()
    # what set-up built lives to the end of the run: out of the collector's
    # way, so that a full collection in the window does not walk it again
    gc.collect()
    gc.freeze()

    kept = Reservoir(KEEP_CALLS, np.random.default_rng([seed % 2**63, 2]))

    def serve(slot_ids):
        kept.offer((slot_ids, serve_raw(slot_ids)))

    setup_s = clock() - t_start
    from cebench import trace as tr

    host_win = dtime = None
    cpu0 = time.process_time()
    if trace:
        host_win = traffic.run(serve, mix, seconds, n_pool)
        cpu_s, cpu_win = time.process_time() - cpu0, host_win
        before = program_counters()
        win, timeline = tr.profile(lambda: traffic.run(serve, mix, min(seconds, TRACE_SECONDS),
                                                       n_pool))
        after = program_counters()
        counters = {k: after[k] - before.get(k, 0) for k in after}
    elif on_card and any(m["source"] == "device_trace" for m in cell.end_to_end):
        win, dtime = tr.device_time(lambda: traffic.run(serve, mix, seconds, n_pool))
        cpu_s, cpu_win = time.process_time() - cpu0, win
    else:
        win = traffic.run(serve, mix, seconds, n_pool)
        cpu_s, cpu_win = time.process_time() - cpu0, win
    sync()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {bad}")
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    del serve_raw

    numbers, failed, judged = judge(cell, chain, pool, kept.items)
    limits = cfg["limits"]
    correct = judged > 0 and failed == 0 and all(numbers[k] <= limits[k] for k in numbers)

    metrics = {}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name, "count": cell.chips,
           "memory_peak_bytes": peak}
    attempted = win.slots + (host_win.slots if host_win is not None else 0)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    if not trace:
        values = dict(traffic.end_to_end(win), setup_s=setup_s)
        ctx = TraceContext(cell=cell, window=win, device_name=device_name, device_time=dtime)
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is None:
                v = spec.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if dtime is not None:
            n = max(win.slots, 1)
            log(f"the card over the window: kernels {dtime.kernel_us * 1e-3 / n:.6f} ms, busy "
                f"{dtime.busy_us * 1e-3 / n:.6f} ms, copies and fills "
                f"{dtime.copy_us * 1e-3 / n:.6f} ms a cell-slot; {dtime.ops} operations, "
                f"{dtime.kernels} kernels, spanning {dtime.span_us * 1e-6:.3f} s",
                file=sys.stderr)
    else:
        ctx = TraceContext(cell=cell, window=win, device_name=device_name, timeline=timeline,
                           counters=counters, host_window=host_win)
        for m in cell.per_layer:
            v = spec.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev["busy_s"] = timeline.busy_us() * 1e-6
        dev["window_s"] = timeline.window_us * 1e-6
        dev["power_limit_w"] = power_limit_w()
        out["breakdown"] = {"device_ops": timeline.top_ops(), "idle_gaps": timeline.idle_gaps()}
        log(f"counters over the traced window: {json.dumps(counters)}", file=sys.stderr)
    if hasattr(traffic, "lateness_ms"):
        log(f"generator lateness: {traffic.lateness_ms(win):.3f} ms at most", file=sys.stderr)
    for what, w in (("untraced window", host_win), ("window", win)):
        if w is not None:
            log(f"{what}: {len(w.calls)} calls, {w.slots} cell-slots in {w.wall:.3f} s",
                file=sys.stderr)
    log(f"set-up {setup_s:.3f} s; the host's CPU {cpu_s * 1e3 / max(cpu_win.slots, 1):.6f} ms "
        f"a cell-slot over the {'untraced ' if trace else ''}window; {judged} cell-slots judged",
        file=sys.stderr)
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = {k: {"value": _num(numbers[k]), "limit": limits[k]} for k in numbers}
    return out


def _num(x: float):
    """A number for the result line: a non-finite one as its name."""
    return x if np.isfinite(x) else str(x)


def power_limit_w():
    """The card's power limit (W) as nvidia-smi reads it, None where it cannot."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"], capture_output=True, text=True,
                           timeout=30)
        return float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        print(f"cebench: {e}", file=sys.stderr)
        return 2
    pin_caches(os.getcwd())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cebench: cell {cell.name} needs {cell.chips} CUDA card(s); {n} here",
              file=sys.stderr)
        return 2
    try:
        __import__(PROGRAM)
    except ImportError as e:
        print(f"cebench: the program {PROGRAM} is not here: {e}", file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda")
    except Exception:  # the run failed: no result line, the traceback on stderr
        traceback.print_exc()
        return 1
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
