"""K1 — the fused estimator front, one pass per problem: `fused_front`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:fused_front`
(`_front_kernel`). Per hop and problem it computes the LS de-spread
rx * conj(pilot); the first-pair CFO by atan2 summed over CDM groups, then the
compensation at the DM-RS symbol times; the time average / beta / n_dsym; the
smoothing by the raised-cosine taps over the extended band [vb | H | flip(ve)]
with unwrap-based virtual pilots (what the TPU kernel's fused operator
H @ smooth + vb @ smooth_vb + flip(ve) @ smooth_ve holds); the direct-DFT time
alignment (PDP over the +-half-CP bins, first maximum, head window wins ties);
noise, RSRP and EPRE.

CUDA kernel (csrc/front.cu), the PR 2 body redesigned for Hopper. What
bounded the first body (one block a problem) was reuse, not the FMA rate: each
of its 128 blocks streamed the constant matrices (smoothing 636 x 636 = 1.6 MB
and the TA DFT 2 x 636 x 288 = 1.5 MB at c2) from L2 on its own, about 400 MB
a batch, on 8 warps an SM. Now:
- a cluster of S blocks takes P problems (P * 2nL <= 32 rows), so every
  K tile of `ta_c`/`ta_s` is staged once in shared memory (a two-stage
  cp.async ring) for all P problems, and each of a block's 512 threads keeps
  a 4-row x RN-column register tile;
- the n_re columns of H and Hs and the TA bins are split over the S blocks;
  a block keeps only its columns of H and Hs, and each K step of the TA
  product reads the A rows from the block that owns them; the other partials
  (EPRE, CFO correlations, noise / RSRP, the PDP) go through distributed
  shared memory too, summed in rank order;
- the plan takes the split with the fewest FMAs a block among those whose
  clusters are all resident at once with one block an SM: an H100 holds 30
  clusters of 4 (its GPCs), so 273 PRB at B=128 runs 2 problems x 2 blocks
  on 128 SMs rather than 4 x 4, whose 32 clusters would not all fit;
- the serial parts (the CFO atan2 over CDM groups, the virtual-pilot atan2 /
  unwrap / fit, the first-maximum TA argmax) run once per problem, exactly
  as before.
`launch_plan` picks P, S, the K tile and RN per shape and mirrors
`make_plan` in csrc/front.cu number for number (a card test compares them
through `srs_front_plan`); a shape that fits no plan raises.

Smoothing (the banded route, `front_kernel_banded`): the raised-cosine taps
themselves (`mats["taps"]`, 15 at comb 2), at every band: each block
pair-averages its columns of H, takes the edge columns the virtual pilots fit
from their owners, and filters its columns over the extended band, the hw =
(K - 1) / 2 columns past its share on each side read from its neighbours'
shared memory. The plan's dense operator (n_re x n_re with its edge matrices,
built up to 1,024 pilot REs for the "xla" tier) holds the same filter, but a
product with it costs n_re + 2 n_pils FMAs a row and column (8 x 636 x 650 a
problem at 106 PRB), the taps K.

Inputs, in one of two forms that the kernel reads through one accessor (the
element strides of both inputs, and the RE and symbol tables or none):
- staged: the received grid `rg_ri` (B, 2, n_sc, n_sym) as the caller staged
  it, read through the hop's RE table `re_idx` (n_cdm * n_re,) (group-major)
  and DM-RS symbol table `dmrs_sym_idx` (nd,), both int64 (`plan_tensors`'
  per-hop "re_idx" and "dmrs_sym_idx"):
  rx[b, ri, c, d, k] = rg_ri[b, ri, re_idx[c * n_re + k], dmrs_sym_idx[d]];
  and the staged pilots of the hop's symbols, `pil_ri[:, :, :, d0:d1]`
  (B, 2, n_re, nd, nL), a view: the kernel starts at d0 through the view's
  offset and reads its strides, so nothing is copied:
  pil[b, ri, l, d, k] = pil_ri[b, ri, k, d0 + d, l];
- gathered: rx (B, 2, n_cdm, nd, n_re) and pil (B, 2, nL, nd, n_re), the TPU
  kernel's layout (a TPU has no gather hardware), read with no tables.
The wrapper tells them apart by the grid's rank and counts the launches of
each in `route_launches`. On the card a thread takes one subcarrier column
k, so with comb 2 a warp's 32 columns read one contiguous run of the staged
grid (the rows 2k, 2k + 1 of both CDM groups): a pass over the DM-RS moves
the whole grid through L2 (18.24 MB at 128 problems of 106 PRB, 14 symbols)
for the 5.2 MB it uses, the three passes at most ~55 MB from L2, and the
pilots 10.4 MB a pass. The L1's requests bound it, not the bytes (a warp's
read of one symbol touches ~28 lines of the staged grid), so each pass reads
every value once and the pilots 16 bytes at a time where their layers are
contiguous. The staged form replaces four launches in front of the kernel
(the gather's two index kernels, its transpose, the pilots' permute: 91 MB
through device memory); both forms give the same bits, since only the
addresses and the loads differ.

Precision: the TPU runs matmul_precision "high" as a 3-pass bf16 split
(`kernels._dot_f32x3`); the kernel's full f32 FMA is at least as accurate, so
"high" and "highest" both map to it.

Left out on purpose (Mosaic workarounds of the TPU kernel): the batch block
with its floor of 2 and batch padding, and the sublane-column scalar layout —
here any B works, B=1 included. The two flipped matrices of the TPU kernel
(`pair_r[:, ::-1]`, `smooth_ve[::-1]`, Mosaic has no lane reversal) go with
the dense operator: the kernel reads the right edge reversed. The TPU's static
`sst_d` tuple is the small device array `two_pi_sst_d`.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from .. import mathx
from . import bind, check_cuda_f32, check_shape, full_f32_matmul, launch

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0
#: the same launches by input form: "staged" (the grid and the pilots as the
#: caller staged them) or "gathered"
route_launches = {"staged": 0, "gathered": 0}

_MAX_LAYERS = 8
_MAX_PILS = 16
_MAX_DSYM = 32
_THREADS = 512
_MAX_M = 32  # rows of the TA product a cluster: P * 2nL
_MAX_CLUSTER = 8
_MAX_RN = 4
_STAGES = 2  # depth of the kernel's operand rings
#: dynamic shared memory one block may use on the H100 (227 KB), less room for
#: the kernel's static shared arrays
SMEM_LIMIT = 232448 - 1024
#: the most two blocks of an SM may each use (228 KB an SM, 1 KB reserved a block)
SMEM_HALF = 233472 // 2 - 1024
#: `caps` for the shape checks made without a card (whether a plan exists
#: does not depend on them): 132 SMs, one block an SM
NOMINAL_CAPS = tuple(132 // s for s in range(1, 9))

_PTR = ctypes.c_void_p
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
#: `srs_fused_front_strided_f32`: rx, its tables and strides, pil and its
#: strides, beta, vp, taps, ta_c, ta_s, two_pi_sst_d, h_out, sc_out; B, n_cdm,
#: nL, nd, n_re, n_pils, k_ta, half_cp_len, n_taps, cfo_possible,
#: cfo_compensate; 2 pi n_samples, fft_size, scs_hz; smem, stream
_STRIDED_ARGTYPES = ([_PTR] * 3 + [_STRIDES, _PTR, _STRIDES] + [_PTR] * 8 + [ctypes.c_int] * 11
                     + [ctypes.c_float] * 3 + [ctypes.c_int, _PTR])
PLAN_ARGTYPES = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int])
CAPS_ARGTYPES = [ctypes.POINTER(ctypes.c_int)]


@dataclass(frozen=True)
class LaunchPlan:
    """P problems a cluster of S blocks; Mpad rows (P * 2nL padded to 4, 8, 16
    or 32); RN register columns a thread (the TA product's); K tiles of KT
    rows; NS columns of H and TS TA bins a block; blocks in all; smem bytes a
    block."""

    P: int
    S: int
    Mpad: int
    RN: int
    KT: int
    NS: int
    TS: int
    blocks: int
    smem: int


def _pad4(x: int) -> int:
    return (x + 3) & ~3


def launch_plan(batch: int, n_re: int, nL: int, n_pils: int, half_cp_len: int, k_ta: int,
                caps, n_taps: int) -> LaunchPlan:
    """The launch of `batch` problems as `make_plan` (csrc/front.cu) computes it.

    `caps[S - 1]`: the clusters of S blocks the card holds at once with one
    block an SM (`kernel_caps`). Among P (problems a cluster, at most 32 rows)
    and S (1..8 blocks a cluster) whose clusters are all resident at once and
    whose block fits the shared memory (the largest K tile of 32, 16 or 8 that
    does), the one with the fewest FMAs a block, padding included (the
    filter's `n_taps` (odd) a row and column of the block's share, and the TA
    passes); on a tie the larger P, then the smaller S. If none is resident at
    once, the same search without that condition, so whether a plan exists
    depends only on the shape, never on `batch` or `caps`. RN serves the TA
    product (at most 4, in passes past that). A launch asks for at least half
    an SM's shared memory, so that a block has its SM to itself. NS and TS are
    multiples of 4. Raises when no plan fits."""
    rows, np_, nbins = 2 * nL, n_pils, 2 * half_cp_len
    if (batch < 1 or not 1 <= nL <= _MAX_LAYERS or not 1 <= np_ <= _MAX_PILS or n_re < np_
            or half_cp_len < 1 or not 1 <= k_ta <= n_re or len(caps) != _MAX_CLUSTER
            or n_taps < 1 or n_taps % 2 == 0):
        raise ValueError(f"no front launch for batch={batch}, nL={nL}, n_pils={n_pils}, "
                         f"n_re={n_re}, half_cp_len={half_cp_len}, k_ta={k_ta}, n_taps={n_taps}")
    for resident in (True, False):
        best = None
        for P in range(min(_MAX_M // rows, batch), 0, -1):
            Mpad = 4
            while Mpad < P * rows:
                Mpad *= 2
            NX = _THREADS // (Mpad // 4)
            clusters = -(-batch // P)
            for S in range(1, _MAX_CLUSTER + 1):
                if resident and clusters > caps[S - 1]:
                    continue
                NS = _pad4(-(-n_re // S))
                TS = _pad4(-(-nbins // S))
                RN = min(_MAX_RN, -(-2 * TS // NX))
                W = NX * RN
                cost = Mpad * (n_taps * NS + -(-2 * TS // W) * W * k_ta)
                if best is not None and cost >= best[0]:
                    continue
                for KT in (32, 16, 8):
                    floats = (max(NS, 2 * TS) * Mpad + NS * Mpad + 2 * np_ * Mpad
                              + _STAGES * KT * (Mpad + W)
                              + _pad4(P * nbins) + 2 * _pad4(P * (rows + 1))
                              + _pad4(2 * S * P) + _pad4(2 * Mpad * np_)
                              + _pad4(2 * P * _MAX_DSYM) + _pad4(3 * P)
                              + _pad4(_THREADS // 32 * (rows + 1)))
                    if 4 * floats <= SMEM_LIMIT:
                        best = (cost, LaunchPlan(
                            P=P, S=S, Mpad=Mpad, RN=RN, KT=KT, NS=NS, TS=TS,
                            blocks=clusters * S, smem=max(4 * floats, SMEM_HALF + 16)))
                        break
        if best is not None:
            return best[1]
    raise ValueError(f"the front fits no launch: n_re={n_re}, nL={nL}, n_pils={n_pils}, "
                     f"half_cp_len={half_cp_len} need more than {SMEM_LIMIT} B a block")


def fused_front_plain(
    rx_ri: torch.Tensor,  # (B, 2, n_cdm, n_dsym, n_re)
    pil_ri: torch.Tensor,  # (B, 2, nL, n_dsym, n_re)
    beta: torch.Tensor,  # (B,)
    mats: dict,
    *,
    n_samples: float,
    half_cp_len: int,
    fft_size: int,
    scs_hz: float,
    cfo_possible: bool,
    cfo_compensate: bool,
):
    """Plain PyTorch version of the fused front (the TPU kernel body's math and
    operation order, its fused smoothing operator applied as the taps it holds,
    `banded_smooth`). Returns (h_s (B, 2, nL, n_re), scalars (B, 8)) with
    scalar columns [cfo, ta, noise, rsrp, epre, 0, 0, 0].

    `mats`: taps (the raised-cosine filter, (K,), K odd), vp (n_pils,
    n_pils), ta_c, ta_s and two_pi_sst_d."""
    B, _, n_cdm, nd, n_re = rx_ri.shape
    nL = pil_ri.shape[2]
    n_pils = mats["vp"].shape[0]
    k_ta = mats["ta_c"].shape[0]
    dt = rx_ri.dtype
    with full_f32_matmul():
        rx_r, rx_i = rx_ri[:, 0], rx_ri[:, 1]  # (B, n_cdm, nd, n_re)
        pil_r, pil_i = pil_ri[:, 0], pil_ri[:, 1]  # (B, nL, nd, n_re)
        beta = beta.to(dt)
        b3 = beta[:, None, None]
        epre = (rx_r * rx_r + rx_i * rx_i).sum(dim=(1, 2, 3))

        # layer l reads CDM group l // 2 (n_cdm = ceil(nL / 2))
        rxl_r = rx_r.repeat_interleave(2, dim=1)[:, :nL]  # (B, nL, nd, n_re)
        rxl_i = rx_i.repeat_interleave(2, dim=1)[:, :nL]
        rec_r = rxl_r * pil_r + rxl_i * pil_i
        rec_i = rxl_i * pil_r - rxl_r * pil_i

        cfo = torch.zeros(B, dtype=dt, device=rx_ri.device)
        rotate = cfo_possible and cfo_compensate
        if cfo_possible:
            a_r, a_i = rec_r[:, :, 0], rec_i[:, :, 0]
            e_r, e_i = rec_r[:, :, 1], rec_i[:, :, 1]
            in_r = (a_r * e_r + a_i * e_i).sum(-1)  # conj(rec0) * rec1, (B, nL)
            in_i = (a_r * e_i - a_i * e_r).sum(-1)
            acc = torch.zeros(B, dtype=dt, device=rx_ri.device)
            for c in range(n_cdm):
                pr, pi = in_r[:, 2 * c], in_i[:, 2 * c]
                if 2 * c + 1 < nL:
                    pr = pr + in_r[:, 2 * c + 1]
                    pi = pi + in_i[:, 2 * c + 1]
                acc = acc + mathx.atan2(pi, pr)
            cfo = acc / (2.0 * math.pi * n_samples) / n_cdm
        if rotate:
            x = mats["two_pi_sst_d"][None, :] * cfo[:, None]  # (B, nd)
            cos_d = torch.cos(x)[:, None, :, None]
            sin_d = torch.sin(x)[:, None, :, None]
            # compensation by exp(-i x): cos(-x) = cos(x), sin(-x) = -sin(x)
            rec_r, rec_i = rec_r * cos_d + rec_i * sin_d, rec_i * cos_d - rec_r * sin_d

        hp_r = rec_r.sum(2) / b3 / nd  # (B, nL, n_re)
        hp_i = rec_i.sum(2) / b3 / nd
        H = torch.cat([hp_r, hp_i], dim=1)  # (B, 2nL, n_re), rows (ri, l)
        if nL >= 2:  # the CDM pair average, which the dense operator holds
            m = n_re // 2
            avg = (H[..., 0:2 * m:2] + H[..., 1:2 * m:2]) * 0.5
            H = torch.cat([avg[..., None].expand(avg.shape + (2,)).reshape(B, 2 * nL, 2 * m),
                           H[..., 2 * m:]], dim=-1)
        e_l = H[..., :n_pils]  # (B, 2nL, n_pils)
        e_rf = torch.flip(H[..., n_re - n_pils:], dims=(-1,))

        def virtual(e):
            if n_pils == 1:
                return e  # the n==1 fit degenerates to constant extrapolation
            vr, vi = e[:, :nL], e[:, nL:]
            amp = torch.sqrt(vr * vr + vi * vi)
            ph = mathx.unwrap_last(mathx.atan2(vi, vr))
            vp_t = mats["vp"].transpose(0, 1)
            v_amp = torch.matmul(amp, vp_t)
            v_ph = torch.matmul(ph, vp_t)
            return torch.cat([v_amp * torch.cos(v_ph), v_amp * torch.sin(v_ph)], dim=1)

        Hs = banded_smooth(H, virtual(e_l), virtual(e_rf), mats["taps"])
        hs_r, hs_i = Hs[:, :nL], Hs[:, nL:]

        Hk = Hs[:, :, :k_ta]
        tc = torch.matmul(Hk, mats["ta_c"])  # (B, 2nL, 2*half_cp)
        ts = torch.matmul(Hk, mats["ta_s"])
        re = tc[:, :nL] - ts[:, nL:]  # hr@C - hi@S
        im = ts[:, :nL] + tc[:, nL:]  # hr@S + hi@C
        pdp = (re * re + im * im).sum(1)  # (B, 2*half_cp)
        head, tail = pdp[:, :half_cp_len], pdp[:, half_cp_len:]
        i_d = mathx.argmax_last(head)
        i_a = mathx.argmax_last(tail)
        i_max = torch.where(
            head.amax(-1) >= tail.amax(-1), i_d.to(dt), -((half_cp_len - i_a).to(dt))
        )
        ta = i_max / float(fft_size) / float(scs_hz)

        if rotate:
            x = mats["two_pi_sst_d"][None, :] * cfo[:, None]
            c2 = torch.cos(x)[:, None, :, None]  # (B, 1, nd, 1)
            s2 = torch.sin(x)[:, None, :, None]
            hph_r = hs_r[:, :, None, :] * c2 - hs_i[:, :, None, :] * s2  # (B, nL, nd, n_re)
            hph_i = hs_r[:, :, None, :] * s2 + hs_i[:, :, None, :] * c2
        else:
            hph_r = hs_r[:, :, None, :]
            hph_i = hs_i[:, :, None, :]
        b4 = beta[:, None, None, None]
        con_r = b4 * (pil_r * hph_r - pil_i * hph_i)
        con_i = b4 * (pil_r * hph_i + pil_i * hph_r)
        noise_l = torch.zeros(B, n_re, dtype=dt, device=rx_ri.device)
        for c in range(n_cdm):
            l0, l1 = 2 * c, min(2 * c + 2, nL)
            est_r, est_i = con_r[:, l0], con_i[:, l0]
            for l in range(l0 + 1, l1):
                est_r = est_r + con_r[:, l]
                est_i = est_i + con_i[:, l]
            d_r = rx_r[:, c] - est_r  # (B, nd, n_re)
            d_i = rx_i[:, c] - est_i
            noise_l = noise_l + (d_r * d_r + d_i * d_i).sum(1)
        noise = noise_l.sum(-1)
        rsrp = (beta * beta) * (hs_r * hs_r + hs_i * hs_i).sum(1).sum(-1) * nd

        zero = torch.zeros_like(cfo)
        sc = torch.stack([cfo, ta, noise, rsrp, epre, zero, zero, zero], dim=1)
    return Hs.reshape(B, 2, nL, n_re), sc


def banded_smooth(h: torch.Tensor, vb: torch.Tensor, vef: torch.Tensor,
                  taps: torch.Tensor) -> torch.Tensor:
    """K1's smoothing: (..., n_re) rows, already pair-averaged,
    filtered by the K taps over the extended band x = [vb | h | flip(vef)]
    (n_pils virtual pilots each side), out[j] = sum_t taps[t] x[j + n_pils +
    hw - t] with zero outside x (hw = (K - 1) / 2): the 'same' convolution of
    the reference, which the plan's dense operator holds as a matrix. Summed
    over t in order, as the kernel."""
    n_re, n_pils, K = h.shape[-1], vb.shape[-1], taps.shape[0]
    hw = (K - 1) // 2
    pad = max(0, hw - n_pils)
    x = torch.nn.functional.pad(torch.cat([vb, h, torch.flip(vef, dims=(-1,))], dim=-1),
                                (pad, pad))
    out = torch.zeros_like(h)
    for t in range(K):
        s = pad + n_pils + hw - t
        out = out + taps[t] * x[..., s:s + n_re]
    return out


def gather_rx(rg: torch.Tensor, re_idx: torch.Tensor, dmrs_sym_idx: torch.Tensor,
              n_cdm: int) -> torch.Tensor:
    """A hop's received pilot REs, time-major: (..., n_cdm, n_dsym, n_re) from
    a grid (..., n_sc, n_sym), ri (B, 2, n_sc, n_sym) or complex (B, n_sc,
    n_sym), by the hop's RE table (n_cdm * n_re,) (group-major) and DM-RS
    symbol table.

    One index gather with the plan's RE table; the TPU package's reshape-and-
    slice form for contiguous combs (`fast_sel`, TPUs have no gather hardware)
    selects the same elements in the same order."""
    lead = rg.shape[:-2]
    g = rg.index_select(-2, re_idx).index_select(-1, dmrs_sym_idx)
    n_re = re_idx.shape[0] // n_cdm
    return g.reshape(lead + (n_cdm, n_re, g.shape[-1])).transpose(-1, -2).contiguous()


def gather_staged(rg_ri: torch.Tensor, pil_ri: torch.Tensor, re_idx: torch.Tensor,
                  dmrs_sym_idx: torch.Tensor):
    """The gathered form of staged inputs: (rx (B, 2, n_cdm, nd, n_re), pil
    (B, 2, nL, nd, n_re)) from the grid (B, 2, n_sc, n_sym), a hop's staged
    pilots (B, 2, n_re, nd, nL) and its tables, element for element what the
    kernel reads through the tables."""
    n_re = pil_ri.shape[2]
    rx = gather_rx(rg_ri, re_idx, dmrs_sym_idx, re_idx.shape[0] // n_re)
    return rx, pil_ri.permute(0, 1, 4, 3, 2).contiguous()


def _check_staged(rg_ri, pil_ri, re_idx, dmrs_sym_idx):
    """Validate the staged form's grid, pilots and tables (on either device),
    the band's width read from the RE table: returns (n_cdm, nd, nL, n_re)."""
    if rg_ri.dim() != 4 or rg_ri.shape[1] != 2 or rg_ri.shape[0] < 1:
        raise ValueError(f"the staged grid must be (B>=1, 2, n_sc, n_sym), got {tuple(rg_ri.shape)}")
    for name, t in (("re_idx", re_idx), ("dmrs_sym_idx", dmrs_sym_idx)):
        if t is None:
            raise ValueError(f"the staged form needs the hop's {name}")
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != rg_ri.device:
            raise ValueError(f"{name} is on {t.device}, the grid on {rg_ri.device}")
    if pil_ri.dim() != 5:
        raise ValueError(f"the staged pilots must be (B, 2, n_re, n_dsym, nL), got "
                         f"{tuple(pil_ri.shape)}")
    nd, nL = dmrs_sym_idx.shape[0], pil_ri.shape[4]
    n_cdm = (nL + 1) // 2
    n_re = re_idx.shape[0] // n_cdm
    check_shape("re_idx", re_idx, (n_cdm * n_re,))
    check_shape("pil_ri", pil_ri, (rg_ri.shape[0], 2, n_re, nd, nL))
    return n_cdm, nd, nL, n_re


def fused_front(
    rx_ri: torch.Tensor,
    pil_ri: torch.Tensor,
    beta: torch.Tensor,
    mats: dict,
    *,
    n_samples: float,
    half_cp_len: int,
    fft_size: int,
    scs_hz: float,
    cfo_possible: bool,
    cfo_compensate: bool,
    re_idx: torch.Tensor | None = None,
    dmrs_sym_idx: torch.Tensor | None = None,
):
    """Fused front for a batch of problems: (h_s (B, 2, nL, n_re), scalars (B, 8)).

    Staged form: `rx_ri` the received grid (B, 2, n_sc, n_sym), `pil_ri` the
    hop's staged pilots (B, 2, n_re, nd, nL) (a view of its symbols), with
    the hop's `re_idx` and `dmrs_sym_idx`. Gathered form: `rx_ri` (B, 2,
    n_cdm, nd, n_re), `pil_ri` (B, 2, nL, nd, n_re), no tables. The grid's
    rank says which (module docstring). `mats`: the hop's tensors of
    `models.plan.plan_tensors` (taps, vp, ta_c, ta_s, two_pi_sst_d). CPU
    tensors go through `fused_front_plain` (the staged form gathered first, by `gather_staged`);
    CUDA tensors launch the kernel."""
    kw = dict(
        n_samples=n_samples, half_cp_len=half_cp_len, fft_size=fft_size, scs_hz=scs_hz,
        cfo_possible=cfo_possible, cfo_compensate=cfo_compensate,
    )
    staged = rx_ri.dim() == 4
    if staged:
        n_cdm, nd, nL, n_re = _check_staged(rx_ri, pil_ri, re_idx, dmrs_sym_idx)
    elif re_idx is not None or dmrs_sym_idx is not None:
        raise ValueError("the gathered form (rx_ri (B, 2, n_cdm, n_dsym, n_re)) takes no tables")
    else:
        n_re = pil_ri.shape[-1]
    if rx_ri.device.type == "cpu":
        if staged:
            rx_ri, pil_ri = gather_staged(rx_ri, pil_ri, re_idx, dmrs_sym_idx)
        return fused_front_plain(rx_ri, pil_ri, beta, mats, **kw)
    if rx_ri.device.type != "cuda":
        raise ValueError(f"fused_front runs on CPU (plain) or CUDA tensors, not {rx_ri.device}")

    if not staged:
        if rx_ri.dim() != 5 or rx_ri.shape[1] != 2 or rx_ri.shape[0] < 1:
            raise ValueError(f"rx_ri must be (B>=1, 2, n_cdm, n_dsym, n_re), got "
                             f"{tuple(rx_ri.shape)}")
        n_cdm, nd = rx_ri.shape[2:4]
        nL = pil_ri.shape[2]
        check_shape("rx_ri", rx_ri, (rx_ri.shape[0], 2, n_cdm, nd, n_re))
        check_shape("pil_ri", pil_ri, (rx_ri.shape[0], 2, nL, nd, n_re))
    B = rx_ri.shape[0]
    n_pils = mats["vp"].shape[0]
    k_ta, n_bins = mats["ta_c"].shape
    rotate = cfo_possible and cfo_compensate
    vp = mats["vp"] if n_pils > 1 else None
    sst_d = mats["two_pi_sst_d"] if rotate else None
    taps = mats["taps"]
    device = check_cuda_f32(beta=beta, vp=vp, ta_c=mats["ta_c"], ta_s=mats["ta_s"],
                            two_pi_sst_d=sst_d, taps=taps)
    for name, t in (("rx_ri", rx_ri), ("pil_ri", pil_ri), ("re_idx", re_idx),
                    ("dmrs_sym_idx", dmrs_sym_idx)):
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    for name, t in (("rx_ri", rx_ri), ("pil_ri", pil_ri)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        # a problem's offsets are 32-bit in the kernel
        if sum((n - 1) * st for n, st in zip(t.shape[1:], t.stride()[1:])) >= 2**31:
            raise ValueError(f"{name} spans more than 2**31 elements a problem")
    if not 1 <= nL <= _MAX_LAYERS or n_cdm != (nL + 1) // 2:
        raise ValueError(f"kernel takes 1..{_MAX_LAYERS} layers in ceil(nL/2) CDM groups")
    if not 1 <= n_pils <= _MAX_PILS or nd > _MAX_DSYM or (cfo_possible and nd < 2):
        raise ValueError(f"unsupported n_pils={n_pils} / n_dsym={nd}")
    if n_bins != 2 * half_cp_len or k_ta > n_re:
        raise ValueError(f"TA DFT {tuple(mats['ta_c'].shape)} does not match half_cp_len / n_re")
    check_shape("beta", beta, (B,))
    if vp is not None:
        check_shape("vp", vp, (n_pils, n_pils))
    if taps.dim() != 1 or taps.shape[0] % 2 == 0:
        raise ValueError(f"the smoothing takes an odd number of taps, got {tuple(taps.shape)}")
    check_shape("ta_s", mats["ta_s"], (k_ta, n_bins))
    if sst_d is not None:
        check_shape("two_pi_sst_d", sst_d, (nd,))
    n_taps = taps.shape[0]
    plan = launch_plan(B, n_re, nL, n_pils, half_cp_len, k_ta, kernel_caps(device), n_taps)

    if staged:  # strides (problem, ri, CDM group, symbol, row), (problem, ri, l, d, k)
        sb, sri, sk, sd = rx_ri.stride()
        rx_st = (sb, sri, 0, sd, sk)
        pb, pri, pk, pd, pl = pil_ri.stride()
        pil_st = (pb, pri, pl, pd, pk)
    else:
        rx_st, pil_st = rx_ri.stride(), pil_ri.stride()
    h_out = torch.empty((B, 2, nL, n_re), dtype=torch.float32, device=device)
    sc_out = torch.empty((B, 8), dtype=torch.float32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    strides = lambda st: (ctypes.c_longlong * 5)(*st)
    launch(
        "fused_front", bind("front", "srs_fused_front_strided_f32", _STRIDED_ARGTYPES), device,
        ptr(rx_ri), ptr(re_idx), ptr(dmrs_sym_idx), strides(rx_st), ptr(pil_ri), strides(pil_st),
        ptr(beta), ptr(vp), ptr(taps), ptr(mats["ta_c"]), ptr(mats["ta_s"]), ptr(sst_d),
        ptr(h_out), ptr(sc_out), B, n_cdm, nL, nd, n_re, n_pils, k_ta, half_cp_len, n_taps,
        int(cfo_possible), int(cfo_compensate),
        2.0 * math.pi * n_samples, float(fft_size), float(scs_hz), plan.smem,
    )
    global launches
    launches += 1
    route_launches["staged" if staged else "gathered"] += 1
    return h_out, sc_out


_caps: dict = {}


def kernel_caps(device) -> tuple:
    """The clusters of 1..8 blocks `device` holds at once with one block an SM
    (`srs_front_caps`: cudaOccupancyMaxActiveClusters), asked once a device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    caps = _caps.get(idx)
    if caps is None:
        out = (ctypes.c_int * _MAX_CLUSTER)()
        with torch.cuda.device(idx):
            rc = bind("front", "srs_front_caps", CAPS_ARGTYPES)(out)
        if rc != 0:
            raise RuntimeError(f"srs_front_caps failed: CUDA error {rc}")
        caps = _caps[idx] = tuple(int(v) for v in out)
    return caps


def kernel_plan(batch: int, n_re: int, nL: int, n_pils: int, half_cp_len: int, k_ta: int,
                caps, n_taps: int) -> LaunchPlan:
    """The kernel's own plan (`srs_front_plan` of the built library), to hold
    `launch_plan` to it on the card."""
    out = (ctypes.c_longlong * 9)()
    cap = (ctypes.c_int * _MAX_CLUSTER)(*caps)
    rc = bind("front", "srs_front_plan", PLAN_ARGTYPES)(out, batch, n_re, nL, n_pils,
                                                        half_cp_len, k_ta, cap, n_taps)
    if rc != 0:
        raise ValueError(f"srs_front_plan refused the shape (CUDA error {rc})")
    return LaunchPlan(*[int(v) for v in out])
