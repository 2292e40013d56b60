"""srsran_ce_tpu_torch — the PyTorch/CUDA port of `srsran_ce_tpu`.

A second package beside the JAX one, which stays the reference the port is held
against. It imports torch and numpy, never jax: the host-side numpy modules it
needs (config, plan, oracle, synthetic) are copies, held bit-identical to the
JAX package's by the CPU tests. The kernels of the TPU package become
hand-written Hopper kernels (`csrc/`, built at first use by
`ops/kernels/_build.py`), each beside a plain PyTorch version that the CPU runs.

This slice covers the batched serve estimator: `models.estimator.build_ri(...,
kernels="pallas_front", out_layout="serve" | "factored")` through the fused
front (K1) and the serve fill (K2). `entry.entry()` builds the c2 case.
"""
from .config import (
    NRE,
    EstimatorConfig,
    HopConfig,
    baseline_config,
    cnn_config,
    make_config,
    normal_cp_durations_ms,
    tensorized_config,
)

__version__ = "0.1.0"

__all__ = [
    "NRE",
    "EstimatorConfig",
    "HopConfig",
    "baseline_config",
    "cnn_config",
    "make_config",
    "normal_cp_durations_ms",
    "tensorized_config",
]
