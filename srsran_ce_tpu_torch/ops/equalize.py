"""MMSE equalization of the port: `srsran_ce_tpu/ops/equalize.py` in torch.

The downstream consumer of the channel estimates: per-RE MMSE filter

    x̂ = (H^H H + σ²/β² I)^(-1) H^H y / β

over (n_rx, n_layers), with the post-equalization SINR
1/diag((G + σ̃²I)^(-1) σ̃²) - 1 beside it.

  * `mmse_equalize_serve` / `mmse_equalize` — the dense grid, one filter per RE.
  * `mmse_equalize_factored_serve` / `mmse_equalize_factored` — the factored
    channel H[sc, sym] = P[sc] · r[sym] with |r| = 1: the unit-modulus rotation
    cancels in the Gram matrix, so the filter is built once per subcarrier and
    the rotation undone as a per-symbol scalar.

Layout: the tiny axes (n_rx, nL) lead, the long axes trail with the
subcarrier last, as in the JAX serve layout, so the estimator's serve grid is
consumed with no relayout. Every contraction over n_rx or nL (at most 4 terms)
is written out as elementwise multiply-adds, never an einsum or matmul:
that keeps full float32 on the card (no TF32 tensor-core dot) and the
near-singular determinant cancellation of the closed-form inverses intact
(ARCHITECTURE.md "Tiny-contraction precision trap").

Batching: every function takes any number of batch axes between the tiny
axes and the (sym, sc) axes — received (n_rx, *batch, n_sym, n_sc), channel
(n_rx, nL, *batch, n_sym, n_sc) — with `noise_var` a scalar or a tensor that
broadcasts against the trailing axes ((*batch, 1, 1) dense, (*batch, 1)
factored). The JAX functions run one problem and gain the batch by vmap.
Complex64 or complex128, on the tensors' device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def mmse_equalize(
    received: torch.Tensor,
    channel: torch.Tensor,
    noise_var,
    beta: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-grid MMSE equalization, reference (sc, sym, layer) layout, one
    problem: received (n_rx, n_sc, n_sym), channel (n_rx, n_sc, n_sym, nL),
    noise_var a scalar. Returns (x_hat (n_sc, n_sym, nL), sinr (n_sc, n_sym,
    nL)): a relayout around `mmse_equalize_serve`, the one compute path."""
    x, sinr = mmse_equalize_serve(
        received.movedim(-2, -1), channel.permute(0, 3, 2, 1), noise_var, beta=beta
    )
    return x.permute(2, 1, 0), sinr.permute(2, 1, 0)


def _inv2_blk(m):
    """Inverse of a 2x2 'matrix of tensors' [[a, b], [c, d]] (elementwise)."""
    (a, b), (c, d) = m
    det = a * d - b * c
    return [[d / det, -b / det], [-c / det, a / det]]


def _mul2_blk(x, y):
    """2x2 block product of 'matrices of tensors' (elementwise)."""
    return [
        [x[0][0] * y[0][0] + x[0][1] * y[1][0], x[0][0] * y[0][1] + x[0][1] * y[1][1]],
        [x[1][0] * y[0][0] + x[1][1] * y[1][0], x[1][0] * y[0][1] + x[1][1] * y[1][1]],
    ]


def _hermitian_inverse_lead(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a regularized Hermitian PD matrix with leading matrix axes:
    a (nL, nL, ...) -> (nL, nL, ...). Closed forms for nL 1-4 (adjugate for 2
    and 3, a Schur complement on 2x2 blocks for 4; the Gram + sigma^2 I is PD,
    so the pivots never vanish), elementwise over the trailing axes;
    `torch.linalg.inv` beyond."""
    nL = a.shape[0]
    if nL == 1:
        return 1.0 / a
    if nL == 2:
        a00, a01, a11 = a[0, 0], a[0, 1], a[1, 1]
        det = a00 * a11 - a01 * torch.conj(a01)
        row0 = torch.stack([a11, -a01])
        row1 = torch.stack([-torch.conj(a01), a00])
        return torch.stack([row0, row1]) / det
    if nL == 3:
        m = [[a[i, j] for j in range(3)] for i in range(3)]
        c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
        c01 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
        c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
        c10 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
        c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
        c12 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
        c20 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
        c21 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
        c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
        det = m[0][0] * c00 + m[0][1] * c10 + m[0][2] * c20
        rows = [
            torch.stack([c00, c01, c02]),
            torch.stack([c10, c11, c12]),
            torch.stack([c20, c21, c22]),
        ]
        return torch.stack(rows) / det
    if nL == 4:
        # A = [[P, Q], [Q^H, S]], P and T = S - Q^H P^-1 Q invertible
        blk = lambda i, j: [[a[2 * i + r, 2 * j + c] for c in (0, 1)] for r in (0, 1)]
        P, Q, S = blk(0, 0), blk(0, 1), blk(1, 1)
        Qh = [[torch.conj(Q[c][r]) for c in (0, 1)] for r in (0, 1)]
        Pi = _inv2_blk(P)
        PiQ = _mul2_blk(Pi, Q)
        QhPi = _mul2_blk(Qh, Pi)
        QhPiQ = _mul2_blk(Qh, PiQ)
        T = [[S[r][c] - QhPiQ[r][c] for c in (0, 1)] for r in (0, 1)]
        Ti = _inv2_blk(T)
        B01 = _mul2_blk(PiQ, Ti)  # P^-1 Q T^-1
        B10 = _mul2_blk(Ti, QhPi)  # T^-1 Q^H P^-1
        A00c = _mul2_blk(B01, QhPi)  # P^-1 Q T^-1 Q^H P^-1
        A00 = [[Pi[r][c] + A00c[r][c] for c in (0, 1)] for r in (0, 1)]
        rows = []
        for r in (0, 1):
            rows.append(torch.stack([A00[r][0], A00[r][1], -B01[r][0], -B01[r][1]]))
        for r in (0, 1):
            rows.append(torch.stack([-B10[r][0], -B10[r][1], Ti[r][0], Ti[r][1]]))
        return torch.stack(rows)
    moved = a.movedim((0, 1), (-2, -1))
    # inv_ex: the Gram + sigma^2 I is PD, and `linalg.inv`'s singularity check
    # would read the info flags back on the host
    return torch.linalg.inv_ex(moved).inverse.movedim((-2, -1), (0, 1))


def _sinr_from_inv_lead(inv: torch.Tensor, noise_over_beta2: torch.Tensor) -> torch.Tensor:
    """Post-MMSE SINR per layer from the regularized inverse: inv (nL, nL,
    ...) -> (nL, ...); noise_over_beta2 real. The JAX function puts an
    optimization barrier on d*s against a TPU miscompile; the barrier has no
    counterpart here, and the order stays: d*s, then max(., 1e-30), then the
    reciprocal."""
    nL = inv.shape[0]
    d = torch.stack([inv[i, i].real for i in range(nL)])
    ds = d * noise_over_beta2
    return torch.clamp_min(1.0 / torch.clamp_min(ds, 1e-30) - 1.0, 0.0)


def _gram_lead(h: torch.Tensor, s) -> torch.Tensor:
    """Regularized Gram H^H H + sI for leading tiny axes: h (n_rx, nL, ...) ->
    (nL, nL, ...), unrolled elementwise over the nL x nL x n_rx terms."""
    nL = h.shape[1]
    hc = torch.conj(h)
    rows = []
    for i in range(nL):
        row = []
        for j in range(nL):
            g = torch.sum(hc[:, i] * h[:, j], dim=0)
            row.append(g + s if i == j else g)
        rows.append(torch.stack(row))
    return torch.stack(rows)


def _matched_filter_lead(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """H^H y for leading tiny axes: h (n_rx, nL, ...), y (n_rx, ...) -> (nL, ...)."""
    hc = torch.conj(h)
    return torch.stack([torch.sum(hc[:, i] * y, dim=0) for i in range(h.shape[1])])


def _apply_inv_lead(inv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """inv (nL, nL, ...) @ v (nL, ...) -> (nL, ...), unrolled elementwise."""
    nL = inv.shape[0]
    return torch.stack([sum(inv[i, j] * v[j] for j in range(nL)) for i in range(nL)])


def _noise_over_beta2(noise_var, beta: float, like: torch.Tensor) -> torch.Tensor:
    """sigma^2 / beta^2 as a real tensor of `like`'s precision and device (a
    tensor `noise_var` is cast on its device, a number filled in: no host
    data crosses to the device)."""
    rdt = like.real.dtype
    if torch.is_tensor(noise_var):
        s = noise_var.to(device=like.device, dtype=rdt)
    else:
        s = torch.full((), float(noise_var), dtype=rdt, device=like.device)
    return s / (beta * beta)


def mmse_equalize_serve(
    received: torch.Tensor,
    channel: torch.Tensor,
    noise_var,
    beta: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense MMSE equalization in the serve layout (subcarrier-last).

    received (n_rx, *batch, n_sym, n_sc); channel (n_rx, nL, *batch, n_sym,
    n_sc) — the estimator's serve grid stacked over RX ports. Returns
    x (nL, *batch, n_sym, n_sc), sinr (nL, *batch, n_sym, n_sc)."""
    s = _noise_over_beta2(noise_var, beta, channel)
    inv = _hermitian_inverse_lead(_gram_lead(channel, s.to(channel.dtype)))
    mf = _matched_filter_lead(channel, received)  # H^H y
    x = _apply_inv_lead(inv, mf) / beta
    return x, _sinr_from_inv_lead(inv, s)


def mmse_equalize_factored_serve(
    received: torch.Tensor,
    profiles: torch.Tensor,
    sym_rot: torch.Tensor,
    noise_var,
    sym_start: int,
    n_alloc_syms: int,
    beta: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factored MMSE equalization, serve layout, multi-RX, per-RX CFO rotations.

    received (n_rx, *batch, n_sym, n_sc); profiles (n_rx, nL, *batch, n_sc) —
    one hop row of each RX port's FactoredResult; sym_rot (n_rx, *batch,
    n_sym) per-port rotations. The rotations cancel in the Gram matrix
    G = Σ_r P_r^H P_r, so the inverse is built once per subcarrier; they
    survive only in the matched filter, folded into the received symbols.
    Returns x (nL, *batch, n_alloc, n_sc), sinr (nL, *batch, n_sc)."""
    s = _noise_over_beta2(noise_var, beta, profiles)
    inv = _hermitian_inverse_lead(_gram_lead(profiles, s.to(profiles.dtype)))
    rot = sym_rot[..., sym_start : sym_start + n_alloc_syms]
    y = received[..., sym_start : sym_start + n_alloc_syms, :]
    y = y * torch.conj(rot)[..., None]  # (n_rx, *batch, n_alloc, n_sc)
    nL, n_rx = profiles.shape[1], profiles.shape[0]
    pc = torch.conj(profiles)
    # the filter W = (G + sI)^-1 P^H folded to per-subcarrier weights, then
    # applied in one pass over the symbols (no matched-filter grid)
    x = torch.stack(
        [
            sum(
                sum(inv[i, j] * pc[r, j] for j in range(nL))[..., None, :] * y[r]
                for r in range(n_rx)
            )
            for i in range(nL)
        ]
    ) / beta
    return x, _sinr_from_inv_lead(inv, s)


def mmse_equalize_factored(
    received: torch.Tensor,
    profiles: torch.Tensor,
    sym_rot: torch.Tensor,
    noise_var,
    sym_start: int,
    n_alloc_syms: int,
    beta: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factored-channel MMSE equalization of one hop's symbols, one problem:
    received (n_rx, n_sc, n_sym), profiles (n_rx, nL, n_sc), sym_rot (n_sym,)
    shared by the ports. Returns (x_hat (n_sc, n_alloc, nL), sinr (n_sc, nL)):
    a relayout around `mmse_equalize_factored_serve`."""
    x, sinr = mmse_equalize_factored_serve(
        received.movedim(-2, -1), profiles, sym_rot[None, :], noise_var,
        sym_start, n_alloc_syms, beta=beta,
    )
    return x.permute(2, 1, 0), sinr.T
