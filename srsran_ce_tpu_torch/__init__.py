"""srsran_ce_tpu_torch — the PyTorch/CUDA port of `srsran_ce_tpu`.

A second package beside the JAX one, which stays the reference the port is held
against. It imports torch and numpy, never jax: the host-side numpy modules it
needs (config, plan, oracle, synthetic, ops/sequences, utils/vectors,
validation/synth_vectors) are copies, held bit-identical to the JAX package's
by the CPU tests. The kernels of the TPU package become hand-written Hopper
kernels (`csrc/`, built at first use by `ops/kernels/_build.py`), each beside a
plain PyTorch version that the CPU runs.

Covered: the estimator, `models.estimator.build_ri` over the three kernel tiers
("xla" plain torch, "pallas" with K5 `rc_smooth` and K6 `fused_fill_rotate`,
"pallas_front" with K1 `fused_front`; K2 `fused_fill_rotate_serve` fills the
serve grid) and the three layouts, plus `build`, `build_batched` and
`estimate`; the conformance replay (`validation/cli.py selftest | validate`).
`entry.entry()` builds the c2 case.
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
