"""The SNR a PUSCH configuration's slots are sent at, and the faults its
limits catch. Not part of a benchmark run: it is run on the card when the SNR
is set, and its readings are kept in PERF.md.

    python -m cebench.threshold --workload pusch100_closed8 --snrs 4,4.5,5 \
        --seeds 1,2,3 [--slots 32] [--variants program,sweeps4,rx1] \
        [--fault-span 4] [--out threshold.jsonl]

For each variant, SNR (dB a receive antenna, the configuration's
`assumed.snr_db`) and seed: `--slots` slots made from the seed at that SNR,
served through the program as the cell serves them (the traffic's cells a
call), and counted: the code blocks whose payload differs from the one sent
or whose CRC flag is not set. The variants:

  program   the configuration as it is
  sweepsN   the decoder stopped after N of its layered sweeps
  rx1       the receiver given one antenna of the slot's four (each grid cut
            to antenna 0): a receiver that combines one antenna

`program` runs first, over every SNR; its threshold is the lowest SNR from
which every block of every seed decodes, at every SNR above it too. The other
variants then run over the SNRs from that threshold to `--fault-span` dB
above it. One JSON line a point, then each variant's threshold.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys

import numpy as np

from cebench import run, spec


def variant_config(cfg: dict, variant: str, snr_db: float) -> dict:
    out = copy.deepcopy(cfg)
    out["assumed"]["snr_db"] = float(snr_db)
    if variant.startswith("sweeps"):
        out["decoder"]["n_iters"] = int(variant[len("sweeps"):])
    elif variant not in ("program", "rx1"):
        raise ValueError(f"unknown variant {variant!r}")
    return out


def bad_blocks(cell: spec.Cell, variant: str, snr_db: float, seed: int, n_slots: int,
               device: str) -> dict:
    """The blocks of `n_slots` slots of `seed` at `snr_db` that came back wrong."""
    cfg = variant_config(cell.config, variant, snr_db)
    chain = spec.load_module("chains", cfg["chain"])
    pool = [chain.make_slot(cfg, seed, i) for i in range(n_slots)]
    if variant == "rx1":
        pool = [dataclasses.replace(s, rg=np.ascontiguousarray(s.rg[:1])) for s in pool]
    serve = chain.server(cfg, pool, device)
    per_call = int(cell.traffic["cells"])
    blocks = bad = bit_errors = 0
    for c0 in range(0, n_slots, per_call):
        ids = list(range(c0, min(c0 + per_call, n_slots)))
        for sid, (r,) in zip(ids, serve(ids)):
            sent = pool[sid].payload
            info, ok = np.asarray(r.info), np.asarray(r.ok, bool)
            wrong = ~ok | np.any(info != sent, axis=1)
            blocks += sent.shape[0]
            bad += int(np.count_nonzero(wrong))
            bit_errors += int(np.count_nonzero(info != sent))
    return {"variant": variant, "snr_db": snr_db, "seed": seed, "slots": n_slots,
            "blocks": blocks, "bad_blocks": bad, "payload_bit_errors": bit_errors}


def threshold(rows: list, variant: str):
    """The lowest SNR from which no block of any seed came back wrong, None
    where the highest SNR still had one."""
    bad = {}
    for r in rows:
        if r["variant"] == variant:
            bad[r["snr_db"]] = bad.get(r["snr_db"], 0) + r["bad_blocks"]
    t = None
    for snr in sorted(bad, reverse=True):
        if bad[snr]:
            break
        t = snr
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--snrs", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--variants", default="program")
    ap.add_argument("--fault-span", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if cell.config["chain"] != "pusch_decoded":
        raise SystemExit(f"{cell.name} decodes nothing")
    run.pin_caches(os.getcwd())
    snrs = sorted(float(x) for x in args.snrs.split(","))
    seeds = [int(x) for x in args.seeds.split(",")]
    variants = args.variants.split(",")
    rows = []

    def point(variant, snr):
        for seed in seeds:
            rows.append(bad_blocks(cell, variant, snr, seed, args.slots, args.device))
            print(json.dumps(rows[-1]), flush=True)

    for snr in snrs:
        point("program", snr)
    t = threshold(rows, "program")
    summary = {"program": t}
    for v in variants:
        if v == "program" or t is None:
            continue
        for snr in (s for s in snrs if t <= s <= t + args.fault_span):
            point(v, snr)
        summary[v] = threshold(rows, v)
    print(json.dumps({"workload": cell.name, "thresholds_db": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [{"workload": cell.name, "thresholds_db": summary}]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
