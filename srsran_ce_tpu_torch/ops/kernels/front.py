"""K1 — the fused estimator front, one pass per problem: `fused_front`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:fused_front`
(`_front_kernel`). Per hop and problem it computes the LS de-spread
rx * conj(pilot); the first-pair CFO by atan2 summed over CDM groups, then the
compensation at the DM-RS symbol times; the time average / beta / n_dsym; the
fused smoothing H @ smooth + vb @ smooth_vb + flip(ve) @ smooth_ve with
unwrap-based virtual pilots; the direct-DFT time alignment (PDP over the
+-half-CP bins, first maximum, head window wins ties); noise, RSRP and EPRE.

CUDA kernel (csrc/front.cu), the PR 2 body redesigned for Hopper. What
bounded the first body (one block a problem) was reuse, not the FMA rate: each
of its 128 blocks streamed the constant matrices (smoothing 636 x 636 = 1.6 MB
and the TA DFT 2 x 636 x 288 = 1.5 MB at c2) from L2 on its own, about 400 MB
a batch, on 8 warps an SM. Now:
- a cluster of S blocks takes P problems (P * 2nL <= 32 rows), so every
  K tile of `smooth`, `smooth_vb`/`smooth_ve` and `ta_c`/`ta_s` is staged once
  in shared memory (a two-stage cp.async ring) for all P problems, and each
  of a block's 512 threads keeps a 4-row x RN-column register tile;
- the n_re columns of the smoothing product and the TA bins are split over
  the S blocks; a block keeps only its columns of H and Hs, and each K step
  reads the A rows from the block that owns them; the other partials (EPRE,
  CFO correlations, edge products, noise / RSRP, the PDP) go through
  distributed shared memory too, summed in rank order;
- the plan takes the split with the fewest FMAs a block among those whose
  clusters are all resident at once with one block an SM: an H100 holds 30
  clusters of 4 (its GPCs), so c2 at B=128 runs 2 problems x 2 blocks on
  128 SMs rather than 4 x 4, whose 32 clusters would not all fit;
- the serial parts (the CFO atan2 over CDM groups, the virtual-pilot atan2 /
  unwrap / fit, the first-maximum TA argmax) run once per problem, exactly
  as before.
`launch_plan` picks P, S, the K tile and RN per shape and mirrors
`make_plan` in csrc/front.cu number for number (a card test compares them
through `srs_front_plan`); a shape that fits no plan raises.

Precision: the TPU runs matmul_precision "high" as a 3-pass bf16 split
(`kernels._dot_f32x3`); the kernel's full f32 FMA is at least as accurate, so
"high" and "highest" both map to it.

Left out on purpose (Mosaic workarounds of the TPU kernel): the batch block
with its floor of 2 and batch padding, and the sublane-column scalar layout —
here any B works, B=1 included. The two flipped matrices of the TPU kernel
(`pair_r[:, ::-1]`, `smooth_ve[::-1]`, Mosaic has no lane reversal) are
dropped as well: the matrices stay in plan order and the kernel indexes them
reversed. The TPU's static `sst_d` tuple is the small device array
`two_pi_sst_d`.
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

_MAX_LAYERS = 8
_MAX_PILS = 16
_MAX_DSYM = 32
_THREADS = 512
_MAX_M = 32  # rows of the products a cluster: P * 2nL
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
_ARGTYPES = [_PTR] * 14 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3 + [ctypes.c_int, _PTR]
PLAN_ARGTYPES = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_int)])
CAPS_ARGTYPES = [ctypes.POINTER(ctypes.c_int)]


@dataclass(frozen=True)
class LaunchPlan:
    """P problems a cluster of S blocks; Mpad rows (P * 2nL padded to 4, 8, 16
    or 32); RN register columns a thread; K tiles of KT rows; NS columns of
    the smoothing product and TS TA bins a block; blocks in all; smem bytes a
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
                caps) -> LaunchPlan:
    """The launch of `batch` problems as `make_plan` (csrc/front.cu) computes it.

    `caps[S - 1]`: the clusters of S blocks the card holds at once with one
    block an SM (`kernel_caps`). Among P (problems a cluster, at most 32 rows)
    and S (1..8 blocks a cluster) whose clusters are all resident at once,
    whose column share needs at most 4 register columns a thread and whose
    block fits the shared memory (the largest K tile of 32, 16 or 8 that
    does), the one with the fewest FMAs a block, padding included; on a tie
    the larger P, then the smaller S. If none is resident at once, the same
    search without that condition, so whether a plan exists depends only on
    the shape, never on `batch` or `caps`. A launch asks for at least half an
    SM's shared memory, so that a block has its SM to itself. NS and TS are
    multiples of 4. Raises when no plan fits."""
    rows, np_, nbins = 2 * nL, n_pils, 2 * half_cp_len
    if (batch < 1 or not 1 <= nL <= _MAX_LAYERS or not 1 <= np_ <= _MAX_PILS or n_re < 1
            or half_cp_len < 1 or not 1 <= k_ta <= n_re or len(caps) != _MAX_CLUSTER):
        raise ValueError(f"no front launch for batch={batch}, nL={nL}, n_pils={n_pils}, "
                         f"n_re={n_re}, half_cp_len={half_cp_len}, k_ta={k_ta}")
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
                RN = -(-NS // NX)
                if RN > _MAX_RN:
                    continue
                TS = _pad4(-(-nbins // S))
                W = NX * RN
                cost = Mpad * (W * (n_re + 2 * np_) + -(-2 * TS // W) * W * k_ta)
                if best is not None and cost >= best[0]:
                    continue
                for KT in (32, 16, 8):
                    floats = (max(NS, 2 * TS) * Mpad + NS * Mpad + 2 * np_ * Mpad
                              + _STAGES * KT * (Mpad + W)
                              + _pad4(P * nbins) + 2 * _pad4(P * (rows + 1))
                              + _pad4(2 * S * P) + 2 * _pad4(2 * Mpad * np_)
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
    """Plain PyTorch version of the fused front (same math and operation order
    as the TPU kernel body). Returns (h_s (B, 2, nL, n_re), scalars (B, 8)) with
    scalar columns [cfo, ta, noise, rsrp, epre, 0, 0, 0]."""
    B, _, n_cdm, nd, n_re = rx_ri.shape
    nL = pil_ri.shape[2]
    n_pils = mats["pair_l"].shape[1]
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
        e_l = torch.matmul(H, mats["pair_l"])  # (B, 2nL, n_pils)
        e_rf = torch.flip(torch.matmul(H, mats["pair_r"]), dims=(-1,))

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

        vb = virtual(e_l)
        vef = virtual(e_rf)
        Hs = (
            torch.matmul(H, mats["smooth"])
            + torch.matmul(vb, mats["smooth_vb"])
            + torch.matmul(vef, torch.flip(mats["smooth_ve"], dims=(0,)))
        )
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
):
    """Fused front for a batch of problems: (h_s (B, 2, nL, n_re), scalars (B, 8)).

    `mats`: the hop's tensors of `models.plan.plan_tensors` (pair_l, pair_r,
    vp, smooth, smooth_vb, smooth_ve, ta_c, ta_s, two_pi_sst_d). CPU tensors go
    through `fused_front_plain`; CUDA tensors launch the kernel."""
    kw = dict(
        n_samples=n_samples, half_cp_len=half_cp_len, fft_size=fft_size, scs_hz=scs_hz,
        cfo_possible=cfo_possible, cfo_compensate=cfo_compensate,
    )
    if rx_ri.device.type == "cpu":
        return fused_front_plain(rx_ri, pil_ri, beta, mats, **kw)
    if rx_ri.device.type != "cuda":
        raise ValueError(f"fused_front runs on CPU (plain) or CUDA tensors, not {rx_ri.device}")

    B, two, n_cdm, nd, n_re = rx_ri.shape
    nL = pil_ri.shape[2]
    n_pils = mats["pair_l"].shape[1]
    k_ta, n_bins = mats["ta_c"].shape
    rotate = cfo_possible and cfo_compensate
    vp = mats["vp"] if n_pils > 1 else None
    sst_d = mats["two_pi_sst_d"] if rotate else None
    tensors = dict(
        rx_ri=rx_ri, pil_ri=pil_ri, beta=beta, pair_l=mats["pair_l"], pair_r=mats["pair_r"],
        vp=vp, smooth=mats["smooth"], smooth_vb=mats["smooth_vb"],
        smooth_ve=mats["smooth_ve"], ta_c=mats["ta_c"], ta_s=mats["ta_s"], two_pi_sst_d=sst_d,
    )
    device = check_cuda_f32(**tensors)
    if two != 2 or B < 1:
        raise ValueError(f"rx_ri must be (B>=1, 2, n_cdm, n_dsym, n_re), got {tuple(rx_ri.shape)}")
    if not 1 <= nL <= _MAX_LAYERS or n_cdm != (nL + 1) // 2:
        raise ValueError(f"kernel takes 1..{_MAX_LAYERS} layers in ceil(nL/2) CDM groups")
    if not 1 <= n_pils <= _MAX_PILS or nd > _MAX_DSYM or (cfo_possible and nd < 2):
        raise ValueError(f"unsupported n_pils={n_pils} / n_dsym={nd}")
    if n_bins != 2 * half_cp_len or k_ta > n_re:
        raise ValueError(f"TA DFT {tuple(mats['ta_c'].shape)} does not match half_cp_len / n_re")
    check_shape("pil_ri", pil_ri, (B, 2, nL, nd, n_re))
    check_shape("beta", beta, (B,))
    check_shape("pair_l", mats["pair_l"], (n_re, n_pils))
    check_shape("pair_r", mats["pair_r"], (n_re, n_pils))
    if vp is not None:
        check_shape("vp", vp, (n_pils, n_pils))
    check_shape("smooth", mats["smooth"], (n_re, n_re))
    check_shape("smooth_vb", mats["smooth_vb"], (n_pils, n_re))
    check_shape("smooth_ve", mats["smooth_ve"], (n_pils, n_re))
    check_shape("ta_s", mats["ta_s"], (k_ta, n_bins))
    if sst_d is not None:
        check_shape("two_pi_sst_d", sst_d, (nd,))
    plan = launch_plan(B, n_re, nL, n_pils, half_cp_len, k_ta, kernel_caps(device))

    h_out = torch.empty((B, 2, nL, n_re), dtype=torch.float32, device=device)
    sc_out = torch.empty((B, 8), dtype=torch.float32, device=device)
    ptr = lambda t: None if t is None else t.data_ptr()
    launch(
        "fused_front", bind("front", "srs_fused_front_f32", _ARGTYPES), device,
        ptr(rx_ri), ptr(pil_ri), ptr(beta), ptr(mats["pair_l"]), ptr(mats["pair_r"]),
        ptr(vp), ptr(mats["smooth"]), ptr(mats["smooth_vb"]), ptr(mats["smooth_ve"]),
        ptr(mats["ta_c"]), ptr(mats["ta_s"]), ptr(sst_d), ptr(h_out), ptr(sc_out),
        B, n_cdm, nL, nd, n_re, n_pils, k_ta, half_cp_len,
        int(cfo_possible), int(cfo_compensate),
        2.0 * math.pi * n_samples, float(fft_size), float(scs_hz), plan.smem,
    )
    global launches
    launches += 1
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
                caps) -> LaunchPlan:
    """The kernel's own plan (`srs_front_plan` of the built library), to hold
    `launch_plan` to it on the card."""
    out = (ctypes.c_longlong * 9)()
    cap = (ctypes.c_int * _MAX_CLUSTER)(*caps)
    rc = bind("front", "srs_front_plan", PLAN_ARGTYPES)(out, batch, n_re, nL, n_pils,
                                                        half_cp_len, k_ta, cap)
    if rc != 0:
        raise ValueError(f"srs_front_plan refused the shape (CUDA error {rc})")
    return LaunchPlan(*[int(v) for v in out])
