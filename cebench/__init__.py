"""The benchmark of `srsran_ce_tpu_torch`, the PyTorch / CUDA port: slots handed
to `serving.process` by a client that plays a base station's PHY, timed from
the caller's side on one NVIDIA H100 and judged against a float64 reference.

    python -m cebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from data files (README.md):
`configs/<config>.json`, `workloads/<cell>.json`, `traffic/<mix>.json` (its
generator `traffic/<kind>.py`), `chains/<chain>.py` (how a deployment's slots
are made, served and judged) and `metrics/<metric>.py`. Nothing here imports
JAX or the JAX package; the inputs and the reference come from the frozen
numpy copies under `gen/` and `reference/`.
"""
