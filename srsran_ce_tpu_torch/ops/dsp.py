"""Host-side DSP helpers of the port (numpy).

Counterparts of two functions of `srsran_ce_tpu/ops/dsp.py`: the static
inpainting schedule the plan builds (a numpy copy, held bit-identical by
tests/test_torch_plan.py) and the matmul precision names. The rest of that
module (the jnp primitives, the inpainting operator) is ROADMAP.md queue 1,
item 2.
"""
from __future__ import annotations

import numpy as np


def make_inpaint_schedule(known_mask: np.ndarray, n_iters: int):
    """Precompute the static mask/denominator schedule of the partial-conv inpainting.

    The reference updates its validity mask every iteration from data-independent
    quantities (ce_dl_cnn.py:473-508): m_{t+1} = max(m_t, conv(m_t, h) > eps). Since
    the seed mask is static config, the whole mask trajectory is plan-time constant —
    we precompute (m_t, den_t) per iteration in numpy.

    Returns list of (m_t, den_t) float64 numpy arrays, each shape (n,).
    """
    h = np.array([0.25, 0.5, 0.25])
    eps = 1e-12
    m = np.asarray(known_mask, dtype=np.float64).reshape(-1)
    n = m.size

    def conv_reflect_np(v):
        if n == 1:
            vp = np.array([v[0], v[0], v[0]])
        else:
            vp = np.concatenate([v[1:2], v, v[-2:-1]])
        return np.convolve(vp, h, mode="valid")

    schedule = []
    steady = 0
    total = max(1, int(n_iters))
    for it in range(total):
        den = conv_reflect_np(m)
        if m.all() and (den > eps).all():
            # Mask saturated: every remaining iteration is the identical fixed-point
            # update x = where(known, x0, conv(x)/(1+eps)); count them instead.
            steady = total - it
            break
        schedule.append((m.copy(), den))
        m = np.maximum(m, (den > eps).astype(np.float64))
    return schedule, steady


#: EstimatorConfig.matmul_precision -> the precision the port's kernels take.
#: On the TPU "high" is a 3-pass bf16 split (~1e-7 relative) and "highest" a
#: 6-pass one. The port's CUDA kernels compute every product in full f32 FMA,
#: at least as accurate as either, so both map to "highest"; the plain PyTorch
#: versions run with TF32 off. "default" (one bf16 pass, ~4e-3) has no port
#: counterpart and raises.
_PRECISIONS = {"high": "highest", "highest": "highest"}


def precision_of(name: str) -> str:
    if name not in _PRECISIONS:
        raise NotImplementedError(
            f"matmul_precision={name!r} has no port counterpart (the kernels run full f32)"
        )
    return _PRECISIONS[name]
