"""Soft demapper of the port: `srsran_ce_tpu/ops/demap.py` in torch.

Exact max-log-MAP bit LLRs from MMSE-equalized symbols and their post-MMSE
SINR. After MMSE equalization each RE is the scalar channel
x_hat = alpha x + z with alpha = sinr / (1 + sinr), so x_hat / alpha sees
complex noise variance 1 / sinr and the demapper needs no other channel state.

For the square Gray-mapped QAM constellations of TS 38.211 §5.1 (QPSK, 16QAM,
64QAM, 256QAM, 1024QAM; BPSK on its diagonal axis) the I and Q bit groups
demap apart, and every bit's exact max-log LLR is a closed-form fold of a few
elementwise operations (`_llr_list`). Sign convention: positive = bit 0 more
likely; bit order b0 b1 ... of TS 38.211 (b0/b1 the I/Q sign bits).

`MODULATIONS`, `bits_per_symbol`, `constellation` and `modulate` are numpy
copies of the JAX module's (the port imports nothing of the JAX package);
tests/test_torch_receiver.py holds them identical. `llrs`, `llr_planes` and
`_llr_list` take torch tensors on any device, in the input's precision.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# m = bits per PAM axis; levels are odd integers scaled by 1/sqrt(norm)
# (TS 38.211 §5.1.3-§5.1.6 normalizations).
_QAM_NORM = {1: 2.0, 2: 10.0, 3: 42.0, 4: 170.0, 5: 682.0}

MODULATIONS = ("bpsk", "qpsk", "16qam", "64qam", "256qam", "1024qam")


def bits_per_symbol(modulation: str) -> int:
    try:
        return {
            "bpsk": 1, "qpsk": 2, "16qam": 4, "64qam": 6, "256qam": 8,
            "1024qam": 10,
        }[modulation]
    except KeyError:
        raise ValueError(f"modulation must be one of {MODULATIONS}: {modulation!r}")


def _pam_level(bits) -> float:
    """TS 38.211 Gray PAM level (odd integer, unnormalized) for axis bits
    (b_sign, b_mag1, b_mag2, ...), the spec's nested form built innermost-out."""
    f = 1.0
    p = 2.0
    for b in reversed(bits[1:]):
        f = p - (1.0 - 2.0 * b) * f
        p *= 2.0
    return (1.0 - 2.0 * bits[0]) * f


def _pam_table(m: int):
    """(levels, bits) for one PAM axis: levels (2^m,) float64 odd integers,
    bits (2^m, m) in axis bit order (sign, mag1, ...)."""
    n = 1 << m
    levels = np.empty(n)
    bits = np.empty((n, m), np.int64)
    for w in range(n):
        bw = [(w >> (m - 1 - k)) & 1 for k in range(m)]
        bits[w] = bw
        levels[w] = _pam_level(bw)
    return levels, bits


def constellation(modulation: str) -> np.ndarray:
    """Unit-energy Gray-mapped constellation indexed by the TS 38.211 bit word
    (b0..b_{n-1} -> index sum b_k 2^(n-1-k)), host-side numpy."""
    nbits = bits_per_symbol(modulation)
    if nbits == 1:
        # TS 38.211 5.1.2 BPSK: d = (1-2b)(1+j)/sqrt(2)
        return np.array([(1 + 1j), (-1 - 1j)]) / np.sqrt(2.0)
    m = nbits // 2
    s = np.sqrt(_QAM_NORM[m])
    pts = np.empty(1 << nbits, np.complex128)
    for w in range(1 << nbits):
        b = [(w >> (nbits - 1 - k)) & 1 for k in range(nbits)]
        pts[w] = (_pam_level(b[0::2]) + 1j * _pam_level(b[1::2])) / s
    return pts


def _llr_list(x: torch.Tensor, sinr, modulation: str):
    """The nbits per-bit LLR tensors (each x.shape) in TS 38.211 word order:
    the shared compute of `llrs` and `llr_planes`. x complex; sinr real,
    broadcastable to x.shape."""
    nbits = bits_per_symbol(modulation)
    m = nbits // 2
    rdt = x.real.dtype
    sinr = torch.as_tensor(sinr, dtype=rdt, device=x.device).broadcast_to(x.shape)
    alpha = sinr / (1.0 + sinr)
    xt_scale = torch.where(sinr > 0, 1.0 / torch.clamp_min(alpha, 1e-30), torch.zeros_like(sinr))
    if nbits == 1:
        # BPSK: one bit on the diagonal axis p = (1+j)/sqrt(2);
        # exact max-log LLR = 4 * sinr * Re(x_tilde * conj(p))
        t = (x.real + x.imag) * (xt_scale / math.sqrt(2.0))
        return [4.0 * t * sinr]
    norm = _QAM_NORM[m]
    s = math.sqrt(norm)
    # t-units (levels at odd integers): t = Re/Im(x_tilde) * sqrt(norm); the
    # noise variance per real dimension is norm / (2 sinr), so
    # 1 / (2 sigma_t^2) = sinr / norm
    inv2var = sinr / norm

    def axis_llrs(t):
        # Closed-form fold: every magnitude bit of the TS 38.211 Gray PAM is the
        # sign bit of a reflected sub-PAM, u_0 = t, u_{k+1} = 2^(m-1-k) - |u_k|,
        # with sub-PAM levels the odd integers in [-(n-1), n-1], n = 2^(m-k).
        # The sign bit's max-log LLR on a = |u| (nearest opposite-sign level -1,
        # nearest same-sign level c0 = 2 floor(a/2) + 1 clipped to the edge):
        #   LLR(u) = sign(u) (c0 + 1)(2a - c0 + 1) inv2var.
        out = []
        u = t
        for k in range(m):
            n = 1 << (m - k)
            if n == 2:
                out.append(4.0 * u * inv2var)
            else:
                a = u.abs()
                c0 = torch.clamp_max(2.0 * torch.floor(0.5 * a) + 1.0, float(n - 1))
                out.append(torch.sign(u) * ((c0 + 1.0) * (2.0 * a - c0 + 1.0)) * inv2var)
            if k < m - 1:
                u = float(1 << (m - 1 - k)) - u.abs()
        return out

    li = axis_llrs(x.real * (xt_scale * s))
    lq = axis_llrs(x.imag * (xt_scale * s))
    inter = []
    for k in range(m):
        inter.append(li[k])
        inter.append(lq[k])
    return inter


def llrs(x: torch.Tensor, sinr, modulation: str) -> torch.Tensor:
    """Exact max-log-MAP bit LLRs of MMSE-equalized symbols x (complex, any
    shape) with per-RE SINR (linear, broadcastable): x.shape + (nbits,).
    REs with sinr = 0 get all-zero LLRs (erasures)."""
    return torch.stack(_llr_list(x, sinr, modulation), dim=-1)


def llr_planes(x: torch.Tensor, sinr, modulation: str) -> torch.Tensor:
    """`llrs` with the bit axis leading: (nbits,) + x.shape, each bit plane in
    x's layout."""
    return torch.stack(_llr_list(x, sinr, modulation), dim=0)


def modulate(bits: np.ndarray, modulation: str) -> np.ndarray:
    """Host-side Gray-QAM modulator: bits (..., n_sym * nbits) in {0, 1} ->
    unit-energy symbols (..., n_sym). Inverse of `llrs`' hard decisions."""
    nbits = bits_per_symbol(modulation)
    pts = constellation(modulation)
    b = np.asarray(bits)
    assert b.shape[-1] % nbits == 0, (b.shape, nbits)
    words = b.reshape(b.shape[:-1] + (-1, nbits))
    idx = np.zeros(words.shape[:-1], np.int64)
    for k in range(nbits):
        idx = (idx << 1) | words[..., k]
    return pts[idx]


def descramble_llrs(llr, c: np.ndarray):
    """Undo TS 38.211 §6.3.1.1 scrambling on soft bits: LLR(b) = (1 - 2c)
    LLR(b'), a sign flip where c = 1. llr: numpy (numpy out) or a tensor
    (tensor out, on its device), float or int8 (the symmetric +-127 clip
    commutes with the flip); c: the scrambling bits, same shape."""
    c = np.asarray(c)
    if isinstance(llr, np.ndarray):
        sign = (1 - 2 * c.astype(np.int8)) if llr.dtype == np.int8 else (
            1.0 - 2.0 * c.astype(np.float32)
        )
        return llr * sign
    sign = torch.as_tensor(1 - 2 * c.astype(np.int8), device=llr.device).to(llr.dtype)
    return llr * sign
