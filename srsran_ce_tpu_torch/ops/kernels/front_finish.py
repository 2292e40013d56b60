"""The fused-front tier's finish, one launch a call: `front_finish`.

Replaces no TPU kernel. The TPU package ends its "pallas_front" tier in XLA:
the scalars and the CFO rotation as small element-wise ops, and with
`out_layout="factored"` the profiles as one product a CDM group by the plan's
dense (n_re, n_sc_hop) interpolation operator into a zero-filled array. On
an H100 (80GB HBM3, 700 W) that was 24 small kernels and two dense products
a call after K1 (`ce40_closed4`: 140.8 us of a 0.336 ms call, the products
318x the work the result needs, as each column of a linear interpolation
operator holds at most two nonzero entries). This kernel does the same work
in one pass, 6.0 us a call there:

- per problem, the hop sums of K1's scalars, rsrp / n_pilots / nL,
  epre / n_pilots, noise / noise_den, TA halved over two hops, the CFO
  averaged over the hops that can estimate it, `cfo_hz` (NaN where none
  can) and the rotation (cos, sin)(2 pi cfo sst) over the symbols, or (1, 0)
  without compensation;
- on the profiles route (the factored layout with linear interpolation),
  every element of `profiles` (B, 2, n_hops, nL, n_sc): inside hop h's band
  w_l * h_s[left] + w_r * h_s[right] for CDM group l // 2's layers, zero
  outside. The tables (`plan_tensors`' per-hop `taps`, built once a plan)
  hold the operator's two nonzero entries of each column, so the kernel sums
  exactly the terms the dense product summed.

The scalar route (the serve layout, whose fill K2 consumes the rotation, and
`interp="cnn"`, whose inpainting operator is not two-tap) takes the same
launch without the profiles.

CUDA kernel (csrc/front_finish.cu): a block a (problem, hop, CDM group)
stages the group's rows of h_s in shared memory, then each thread reads the
tables of 4 consecutive subcarriers once (16-byte loads) and writes those 4
outputs of every row of the group as one 16-byte store; the first block of a
problem also runs its scalars and rotation (a thread a symbol). No atomics.
What bounds it on the H100: the bytes, h_s read (fresh in L2 from K1), the
profiles written, the tables read (ce40_closed4 at B=128: 2.61 MB, 5.21 MB
and 41 KB, 7.88 MB in all, 2.35 us at 3.35 TB/s); at that size the launch is
a large share of its time.

Arithmetic: the plain version's order; each profile value's two products and
their sum are rounded apart (no FMA), so the two agree bit for bit on the
profiles; the divisions are IEEE (PyTorch divides a CUDA tensor by a scalar
through its reciprocal, so the plain version on the card may differ from the
kernel by an ulp in the scalars); `cosf` / `sinf` in full precision.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import bind, check_cuda_f32, check_shape, launch

#: kernel launches since the count was last set to 0 (incremented only where
#: the CUDA kernel is launched, never by the plain version)
launches = 0
#: launches by route: "profiles" (the factored profiles, the scalars and the
#: rotation) or "scalars" (the scalars and the rotation alone)
route_launches = {"profiles": 0, "scalars": 0}

_MAX_HOPS = 2
#: dynamic shared memory a block may take without an opt-in: the group's rows
#: of h_s, 2 x min(2, nL) x n_re floats
_SMEM_LIMIT = 48 * 1024
_PTR = ctypes.c_void_p


class _Hop(ctypes.Structure):
    """struct FinishHop of csrc/front_finish.cu."""

    _fields_ = [("h", _PTR), ("sc", _PTR), ("left", _PTR), ("right", _PTR), ("w_l", _PTR),
                ("w_r", _PTR), ("n_re", ctypes.c_int), ("n_sc_hop", ctypes.c_int),
                ("sc_start", ctypes.c_int), ("cfo_possible", ctypes.c_int)]


class _Args(ctypes.Structure):
    """struct FinishArgs of csrc/front_finish.cu."""

    _fields_ = [("hop", _Hop * _MAX_HOPS), ("sst", _PTR), ("prof", _PTR), ("rot", _PTR),
                ("scal", _PTR), ("batch", ctypes.c_int), ("n_hops", ctypes.c_int),
                ("nL", ctypes.c_int), ("n_sc", ctypes.c_int), ("n_sym", ctypes.c_int),
                ("rotate", ctypes.c_int), ("n_pilots", ctypes.c_float),
                ("n_layers", ctypes.c_float), ("noise_den", ctypes.c_float),
                ("scs_hz", ctypes.c_float), ("two_pi", ctypes.c_float)]


_ARGTYPES = [ctypes.POINTER(_Args), _PTR]


def front_finish_plain(h_s, sc, taps, sst, *, sc_starts, cfo_possible, n_sc: int, n_sym: int,
                       n_pilots: int, noise_den: float, scs_hz: float, cfo_compensate: bool):
    """Plain PyTorch version of `front_finish`, the same arithmetic in the same
    order: the profiles as a two-tap gather, not the dense product."""
    B, _, nL, _ = h_s[0].shape
    acc = sc[0][:, 1:5]
    cfo = sc[0][:, 0] if cfo_possible[0] else None
    for s, possible in zip(sc[1:], cfo_possible[1:]):
        acc = acc + s[:, 1:5]
        if possible:
            cfo = s[:, 0] if cfo is None else (cfo + s[:, 0]) / 2.0
    ta, noise, rsrp, epre = acc.unbind(1)
    noise = noise / noise_den
    rsrp = rsrp / n_pilots / nL
    epre = epre / n_pilots
    ta = ta / 2.0 if len(sc) == 2 else ta.clone()
    cfo_hz = cfo * scs_hz if cfo is not None else torch.full_like(ta, math.nan)
    if cfo_compensate and cfo is not None:
        phase = (2.0 * math.pi) * cfo[:, None] * sst[None, :]  # (B, n_sym)
        rot = torch.stack([torch.cos(phase), torch.sin(phase)], dim=1)
    else:
        rot = torch.stack([ta.new_ones(B, n_sym), ta.new_zeros(B, n_sym)], dim=1)

    profiles = None
    if taps is not None:
        profiles = h_s[0].new_zeros((B, 2, len(h_s), nL, n_sc))
        layer = torch.arange(nL, device=h_s[0].device)
        group, rows = layer // 2, layer[:, None]  # layer l reads CDM group l // 2's taps
        for h, (hs, t, s0) in enumerate(zip(h_s, taps, sc_starts)):
            left, right = t["left"].long()[group], t["right"].long()[group]  # (nL, n_sc_hop)
            fill = t["w_l"][group] * hs[:, :, rows, left] + t["w_r"][group] * hs[:, :, rows, right]
            profiles[:, :, h, :, s0 : s0 + left.shape[1]] = fill
    return profiles, rot, noise, rsrp, epre, ta, cfo_hz


def front_finish(h_s, sc, taps, sst, *, sc_starts, cfo_possible, n_sc: int, n_sym: int,
                 n_pilots: int, noise_den: float, scs_hz: float, cfo_compensate: bool):
    """The finish of the fused front over one or two hops.

    h_s, sc: per hop, K1's outputs (B, 2, nL, n_re) and (B, 8). taps: per hop
    the dict of `plan_tensors`' `taps` (left / right int32 and w_l / w_r, each
    (n_cdm, n_sc_hop)) for the profiles route, or None for the scalar route.
    sst: the (n_sym,) symbol start times (read only when rotating). sc_starts,
    cfo_possible: per hop, its first subcarrier and whether it estimates the
    CFO. Layer l belongs to CDM group l // 2, as K1 takes it. On the profiles
    route the kernel takes n_sc, each hop's first subcarrier and band width as
    multiples of 4 (whole PRBs are) and the tables 16-byte aligned (fresh
    allocations are): it reads and writes 4 subcarriers as one 16-byte word.

    Returns (profiles (B, 2, n_hops, nL, n_sc) or None, rot_ri (B, 2, n_sym),
    noise, rsrp, epre, ta, cfo_hz (each (B,))). CPU tensors go through
    `front_finish_plain`; CUDA tensors launch the kernel."""
    kw = dict(sc_starts=sc_starts, cfo_possible=cfo_possible, n_sc=n_sc, n_sym=n_sym,
              n_pilots=n_pilots, noise_den=noise_den, scs_hz=scs_hz,
              cfo_compensate=cfo_compensate)
    if h_s[0].device.type == "cpu":
        return front_finish_plain(h_s, sc, taps, sst, **kw)
    if h_s[0].device.type != "cuda":
        raise ValueError(f"front_finish runs on CPU (plain) or CUDA tensors, not {h_s[0].device}")

    n_hops = len(h_s)
    if not 1 <= n_hops <= _MAX_HOPS or len(sc) != n_hops or len(sc_starts) != n_hops \
            or len(cfo_possible) != n_hops or (taps is not None and len(taps) != n_hops):
        raise ValueError(f"front_finish takes 1..{_MAX_HOPS} hops, each with its h_s, sc, "
                         "sc_start, cfo_possible (and taps)")
    rotate = cfo_compensate and any(cfo_possible)
    device = check_cuda_f32(sst=sst if rotate else None,
                            **{f"h_s[{h}]": t for h, t in enumerate(h_s)},
                            **{f"sc[{h}]": t for h, t in enumerate(sc)})
    B, two, nL, _ = h_s[0].shape
    n_cdm = (nL + 1) // 2
    if two != 2 or B < 1 or nL < 1 or n_sc < 1 or n_sym < 1:
        raise ValueError(f"h_s must be (B>=1, 2, nL>=1, n_re), got {tuple(h_s[0].shape)}")
    if rotate:
        check_shape("sst", sst, (n_sym,))
    args = _Args()
    max_re = 0
    for h in range(n_hops):
        hop = args.hop[h]
        n_re = h_s[h].shape[3]
        check_shape(f"h_s[{h}]", h_s[h], (B, 2, nL, n_re))
        check_shape(f"sc[{h}]", sc[h], (B, 8))
        hop.h, hop.sc, hop.n_re = h_s[h].data_ptr(), sc[h].data_ptr(), n_re
        hop.cfo_possible = int(bool(cfo_possible[h]))
        if taps is None:
            continue
        t = taps[h]
        check_cuda_f32(w_l=t["w_l"], w_r=t["w_r"])
        n_sc_hop = t["left"].shape[-1]
        for name in ("left", "right", "w_l", "w_r"):
            check_shape(f"taps[{h}][{name!r}]", t[name], (n_cdm, n_sc_hop))
        for name in ("left", "right"):
            x = t[name]
            if x.dtype != torch.int32 or x.device != device or not x.is_contiguous():
                raise TypeError(f"taps[{h}][{name!r}] must be contiguous int32 on {device}")
        if not 0 <= sc_starts[h] <= n_sc - n_sc_hop:
            raise ValueError(f"hop {h}'s band [{sc_starts[h]}, {sc_starts[h] + n_sc_hop}) "
                             f"lies outside the {n_sc} subcarriers")
        if n_sc % 4 or sc_starts[h] % 4 or n_sc_hop % 4:
            raise ValueError(f"front_finish writes 4 subcarriers a store: n_sc={n_sc} and hop "
                             f"{h}'s band [{sc_starts[h]}, {sc_starts[h] + n_sc_hop}) must lie "
                             "on multiples of 4")
        if any(t[name].data_ptr() % 16 for name in ("left", "right", "w_l", "w_r")):
            raise ValueError(f"taps[{h}] must be 16-byte aligned (fresh allocations are)")
        hop.left, hop.right = t["left"].data_ptr(), t["right"].data_ptr()
        hop.w_l, hop.w_r = t["w_l"].data_ptr(), t["w_r"].data_ptr()
        hop.n_sc_hop, hop.sc_start = n_sc_hop, int(sc_starts[h])
        max_re = max(max_re, n_re)
    if 8 * min(2, nL) * max_re > _SMEM_LIMIT:
        raise ValueError(f"front_finish stages at most {_SMEM_LIMIT} B of h_s a block: "
                         f"n_re={max_re} is too long")

    profiles = None
    if taps is not None:
        profiles = torch.empty((B, 2, n_hops, nL, n_sc), dtype=torch.float32, device=device)
    rot = torch.empty((B, 2, n_sym), dtype=torch.float32, device=device)
    scal = torch.empty((5, B), dtype=torch.float32, device=device)
    args.sst = sst.data_ptr() if rotate else None
    args.prof = None if profiles is None else profiles.data_ptr()
    args.rot, args.scal = rot.data_ptr(), scal.data_ptr()
    args.batch, args.n_hops, args.nL, args.n_sc, args.n_sym = B, n_hops, nL, n_sc, n_sym
    args.rotate = int(rotate)
    args.n_pilots, args.n_layers, args.noise_den = n_pilots, nL, noise_den
    args.scs_hz, args.two_pi = scs_hz, 2.0 * math.pi
    launch("front_finish", bind("front_finish", "srs_front_finish_f32", _ARGTYPES), device,
           ctypes.byref(args))
    global launches
    launches += 1
    route_launches["profiles" if profiles is not None else "scalars"] += 1
    noise, rsrp, epre, ta, cfo_hz = scal.unbind(0)
    return profiles, rot, noise, rsrp, epre, ta, cfo_hz
