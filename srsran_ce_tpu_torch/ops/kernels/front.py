"""K1 — the fused estimator front, one pass per problem: `fused_front`.

Replaces the TPU kernel `srsran_ce_tpu/ops/pallas/kernels.py:fused_front`
(`_front_kernel`). Per hop and problem it computes the LS de-spread
rx * conj(pilot); the first-pair CFO by atan2 summed over CDM groups, then the
compensation at the DM-RS symbol times; the time average / beta / n_dsym; the
fused smoothing H @ smooth + vb @ smooth_vb + flip(ve) @ smooth_ve with
unwrap-based virtual pilots; the direct-DFT time alignment (PDP over the
+-half-CP bins, first maximum, head window wins ties); noise, RSRP and EPRE.

CUDA kernel (csrc/front.cu): one thread block per problem. The block's rows H
(2*nL x n_re f32, 20 KB at the c2 width) and the smoothed rows sit in shared
memory; the reductions over n_re (CFO correlation, EPRE, noise, RSRP) are
block reductions; the virtual-pilot atan2 / unwrap / fit runs on one warp in
plain serial code; every matrix product is f32 FMA inside the kernel. What
bounds it on the H100: each block streams the constant matrices (smoothing
636x636 = 1.6 MB and the TA DFT 2 x 636x288 = 1.5 MB at c2) once from L2 —
about 400 MB of L2 traffic per batch of 128 — and one block per problem gives
only 8 warps per SM to hide that latency. Reusing each constant tile across
several problems per block is a later change.

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

import torch

from .. import mathx
from . import _build, check_cuda_f32, check_shape, full_f32_matmul

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0

_MAX_LAYERS = 8
_MAX_PILS = 16
_MAX_DSYM = 32
#: dynamic shared memory one block may use on the H100 (227 KB), less room for
#: the kernel's static shared arrays
SMEM_LIMIT = 232448 - 1024

_PTR = ctypes.c_void_p
_ARGTYPES = [_PTR] * 14 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3 + [ctypes.c_int, _PTR]


def smem_bytes(n_re: int, nL: int, n_pils: int, half_cp_len: int) -> int:
    """Dynamic shared memory of one block: H and the smoothed rows, the PDP,
    the edge products and the virtual pilots (csrc/front.cu, same layout)."""
    rows = 2 * nL
    return 4 * (2 * rows * n_re + 2 * half_cp_len + 4 * rows * n_pils)


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

        cdm_of_layer = [min(l // 2, n_cdm - 1) for l in range(nL)]
        rxl_r, rxl_i = rx_r[:, cdm_of_layer], rx_i[:, cdm_of_layer]  # (B, nL, nd, n_re)
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


def _lib():
    lib = _build.load("front")
    fn = lib.srs_fused_front_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


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
    smem = smem_bytes(n_re, nL, n_pils, half_cp_len)
    if smem > SMEM_LIMIT:
        raise ValueError(f"front needs {smem} B of shared memory, the card has {SMEM_LIMIT}")

    h_out = torch.empty((B, 2, nL, n_re), dtype=torch.float32, device=device)
    sc_out = torch.empty((B, 8), dtype=torch.float32, device=device)
    fn = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            ptr(rx_ri), ptr(pil_ri), ptr(beta), ptr(mats["pair_l"]), ptr(mats["pair_r"]),
            ptr(vp), ptr(mats["smooth"]), ptr(mats["smooth_vb"]), ptr(mats["smooth_ve"]),
            ptr(mats["ta_c"]), ptr(mats["ta_s"]), ptr(sst_d), ptr(h_out), ptr(sc_out),
            B, n_cdm, nL, nd, n_re, n_pils, k_ta, half_cp_len,
            int(cfo_possible), int(cfo_compensate),
            2.0 * math.pi * n_samples, float(fft_size), float(scs_hz),
            smem, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_front kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return h_out, sc_out
