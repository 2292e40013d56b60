"""Peaks of the card and the work of the kernels whose roofline share the
benchmark reports.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its full
700 W; a card set below that runs slower, so every share is printed beside the
card's power limit.

K3 (`ldpc_stream_posterior`, the streamed layered min-sum): a frozen copy of
the count in chip_smoke.py (`ldpc_ops`, layered), which counts the work of the
coding and not of the implementation: per edge lane and sweep 9 float32
operations (v = L - c2v, |v|, its sign, the two-min compare and min, norm * m,
the sign, stored - old, the L update), so 9 x sweeps x edges x Z x words. Its
bytes are the channel LLRs in and the posteriors out, float32, each counted
once: 2 x 4 x n x words.
"""
from __future__ import annotations

from typing import Optional

PEAKS = {
    # name fragment of torch.cuda.get_device_name(): (HBM bytes/s, f32 FLOP/s outside the tensor cores)
    "H100": (3.35e12, 67e12),
}


def peaks(device_name: str) -> Optional[tuple]:
    """(bytes/s, f32 FLOP/s) of the card, None for a card not in the table."""
    return next((v for k, v in PEAKS.items() if k in device_name), None)


def k3_ops(n_edges: int, z: int, words: int, sweeps: int) -> float:
    return 9.0 * sweeps * n_edges * z * words


def k3_bytes(n: int, words: int) -> float:
    return 2.0 * 4.0 * n * words


def least_time_s(nbytes: float, ops: float, device_name: str) -> Optional[float]:
    """The least time the card could take: the larger of the byte and the
    operation bound; None for a card whose peaks are not in the table."""
    pk = peaks(device_name)
    if pk is None:
        return None
    return max(nbytes / pk[0], ops / pk[1])
