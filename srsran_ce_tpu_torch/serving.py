"""Serving front-end of the port: `srsran_ce_tpu/serving.py` in torch.

A stream of heterogeneous problems (cells, UEs, ports, slots with different
configurations) is served in three steps:

  1. group the problems by plan signature (hop1, hop2, config, n_layers, n_rx):
     one signature shares one build function (the estimator's and the receiver's
     lru caches) and its plan tensors;
  2. pack each group into `batch_size` chunks, the tail chunk padded by
     repeating its last problem, so every signature sees one batch shape;
  3. run the batched function per chunk on the device and scatter the results
     back into submission order.

Pipelining (`inflight`): each chunk is packed by the native packer
(`native/loader.py`, g++ at first use; the numpy branch, with one warning,
when it does not build) straight into a pinned staging buffer and
goes to the card with a `non_blocking=True` copy; its outputs come back the
same way into pinned buffers behind a CUDA event, all on the current stream.
PyTorch's caching host allocator reuses a staging buffer only after the copy
that reads it has completed. The host packs the next chunk while the card runs and waits
on a chunk only when `inflight` chunks are pending. On the card each builder
call replays one CUDA graph (`graphs.py`), the device decode chunk (the
receiver and the decode tail) one graph a chunk. On the CPU (`device="cpu"`)
the same code runs in order, eagerly.

`out="decoded"` continues through descrambling, deinterleaving, rate recovery,
LDPC decoding (ops/ldpc) and the CRC, either on the host (`_decode_soft`) or
on the device (`decode_on_device=True`, `_process_decoded_device`).

`TrackedServer` is the stateful counterpart: multi-slot tracking
(models/tracking.py) per caller-chosen stream, the states threaded across
calls on the host.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import devices, graphs, transport
from .config import EstimatorConfig, HopConfig
from .models import estimator, receiver, tracking
from .models.plan import make_plan
from .native import loader as _native
from .ops import demap, ldpc


def _assemble(arrays, out: Optional[np.ndarray] = None) -> np.ndarray:
    """B scattered complex problems -> one contiguous (B, 2, ...) f32 ri batch
    (into `out` when given): the native packer, or the numpy branch when it
    did not build."""
    if _native.available():
        return _native.assemble_batch_ri(arrays, out=out)
    return np.stack([estimator.split_ri(np.asarray(a).astype(np.complex64)) for a in arrays],
                    out=out)


def _stage(fill, shape, dtype, device: torch.device) -> torch.Tensor:
    """A host batch on `device`: `fill(out)` writes it into a numpy array of
    `shape`. On the card `out` is a pinned buffer, sent with a non_blocking
    copy that does not wait for the work already queued. PyTorch's caching
    host allocator records the copy's event and hands the buffer out again
    only once that copy has completed, so a chunk in flight keeps its own."""
    if device.type != "cuda":
        return torch.from_numpy(fill(None))
    buf = torch.empty(shape, dtype=dtype, pin_memory=True)
    fill(buf.numpy())
    return buf.to(device, non_blocking=True)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on `device`: on the card from a pinned copy, without
    waiting for the work already queued on the stream."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _HostCopy:
    """A dispatched result on its way to the host: each CUDA tensor is copied
    with non_blocking=True into a pinned buffer, one event recorded after the
    copies; `get()` waits on that event and returns the result with numpy
    fields. CPU tensors are taken as they are."""

    def __init__(self, value):
        self._event = None
        self._device = None
        self._value = graphs.map_tensors(self._start, value)
        if self._event is not None:
            self._event.record(torch.cuda.current_stream(self._device))

    def _start(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        if self._event is None:
            self._event, self._device = torch.cuda.Event(), t.device
        return h

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        return graphs.map_tensors(lambda t: t.numpy(), self._value)


@dataclass
class Problem:
    """One estimation request (the reference call signature,
    ce_rule_baseline.py:761-768).

    received_rg is (n_sc, n_sym) complex — one RX antenna port — or
    (n_rx, n_sc, n_sym) for a multi-port request (meaningful with
    `process(out="equalized" | "llrs" | "decoded")`, which jointly
    MMSE-equalizes across ports)."""

    received_rg: np.ndarray  # (n_sc, n_sym) or (n_rx, n_sc, n_sym) complex
    pilots: np.ndarray  # (n_re, n_dsym, n_layers) complex
    beta: float
    hop1: HopConfig
    hop2: Optional[HopConfig]
    config: EstimatorConfig

    @property
    def n_rx(self) -> int:
        return 1 if self.received_rg.ndim == 2 else int(self.received_rg.shape[0])

    def signature(self) -> Tuple:
        hop2 = None if (self.hop2 is not None and self.hop2.is_empty) else self.hop2
        return (self.hop1, hop2, self.config, int(self.pilots.shape[-1]), self.n_rx)


@dataclass
class ServeResult:
    """Host-side per-problem result (complex channel grid, reference layout)."""

    channel_est_rg: np.ndarray  # (n_sc, n_sym, n_layers) complex64
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float


@dataclass
class FactoredServeResult:
    """Per-problem result in rank-1 factored form (`process(out="factored")`):
    the dense grid is profiles[h, l, sc] * sym_rot[sym] over hop h's
    allocated symbols and zero elsewhere; `.dense()` expands it."""

    profiles: np.ndarray  # (n_hops, n_layers, n_sc) complex64 — zero outside band
    sym_rot: np.ndarray  # (n_sym,) complex64
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float
    hop1: HopConfig = None  # hop extents, needed by .dense()
    hop2: Optional[HopConfig] = None

    def dense(self) -> np.ndarray:
        """(n_sc, n_sym, n_layers) complex grid, reference layout."""
        return estimator.reconstruct_factored(
            self.profiles, self.sym_rot, self.hop1, self.hop2, n_sym=int(self.sym_rot.shape[0])
        )


@dataclass
class EqualizedServeResult:
    """Per-problem output of `process(out="equalized")`: the joint multi-RX
    receiver's equalized symbols and SINR (the channel grid stays on the
    device)."""

    x: np.ndarray  # (n_sc, n_sym, n_layers) complex64 — noise-normalized symbols
    sinr: np.ndarray  # (n_sc, n_sym, n_layers) float32 — post-MMSE SINR (linear)
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float


@dataclass
class LlrServeResult:
    """Per-problem output of `process(out="llrs", modulation=...)`: int8 soft
    bits (neither the grid nor the symbols leave the device)."""

    llr: np.ndarray  # (n_sc, n_sym, n_layers, nbits) int8 — round(llr*scale), +-127 clip
    sinr: np.ndarray  # (n_sc, n_sym, n_layers) float32 — post-MMSE SINR (linear)
    noise_est: float
    rsrp: float
    epre: float
    time_alignment: float
    cfo_hz: float
    llr_scale: float = 8.0

    def llrs_float(self) -> np.ndarray:
        """Dequantized LLRs (float32), saturated at +-127 / llr_scale."""
        return self.llr.astype(np.float32) / self.llr_scale


@dataclass
class DecodedServeResult:
    """Per-problem output of `process(out="decoded", ...)`: the decoded
    payload bits of each codeword of the problem's grid."""

    info: np.ndarray  # (c_words, k) uint8 — decoded systematic payloads
    ok: np.ndarray  # (c_words,) bool — parity check (and CRC, when coded with one)
    # the underlying soft-bit result; None on the device path (decode_on_device)
    soft: Optional[LlrServeResult]
    # the receiver's measurement scalars, set on the device path (the host
    # path exposes them through soft.*)
    noise_est: Optional[float] = None
    rsrp: Optional[float] = None
    epre: Optional[float] = None
    time_alignment: Optional[float] = None
    cfo_hz: Optional[float] = None


# ---------------------------------------------------------------------------
# Host-side measurement probes (numpy copies of the JAX module's)
# ---------------------------------------------------------------------------


def _hop1_pilot_estimates(problem: Problem):
    """Raw LS pilot estimates on CDM group 0 of hop 1: (m, n_dsym) complex128
    (pair-averaged onto the decimated lattice when the group carries two OCC'd
    layers), the pilot-lattice spacing df (Hz), and the hop plan."""
    n_layers = int(problem.pilots.shape[-1])
    plan = make_plan(problem.hop1, problem.hop2, problem.config, n_layers)
    hp = plan.hop1
    rg = np.asarray(problem.received_rg)
    if rg.ndim == 3:
        rg = rg[0]  # the probes sample RX port 0 (same physical link)
    pil = np.asarray(problem.pilots).astype(np.complex128)
    h = rg[hp.re_idx[0][:, None], hp.dmrs_sym_idx[None, :]] * np.conj(pil[:, : hp.n_dsym, 0])
    h = h / max(abs(float(problem.beta)), 1e-30)
    sc = hp.re_idx[0].astype(np.int64)
    comb = int(np.median(np.diff(sc))) if sc.size > 1 else 1
    df = comb * plan.scs_hz
    l0, l1 = hp.layer_slices[0]
    if l1 - l0 == 2 and h.shape[0] % 2 == 0:
        # the OCC'd partner layer cancels under adjacent-pair averaging; the
        # decimated lattice doubles the spacing
        h = 0.5 * (h[0::2] + h[1::2])
        df *= 2.0
    return h, df, hp


def estimate_delay_spread(problem: Problem) -> float:
    """RMS delay spread (seconds) of one problem from its raw pilot estimates:
    the second moment of the delay-domain power profile of hop 1's
    time-averaged LS estimates (noise floor from the median bin, bins above
    max(6x floor, 2 % of peak) within +-m/8 of the peak, circular centroid).
    0.0 for channels flat below the lattice's delay resolution."""
    ht, df, _ = _hop1_pilot_estimates(problem)
    h = np.mean(ht, axis=1)
    m = h.size
    if m < 8:
        return 0.0

    z = np.fft.ifft(h)
    p = np.abs(z) ** 2
    floor = float(np.median(p)) / np.log(2.0)
    pk = int(np.argmax(p))
    if p[pk] < 8.0 * floor:
        return 0.0  # no channel power resolvable above the noise floor
    thr = max(6.0 * floor, 0.02 * p[pk])
    dist_pk = (np.arange(m) - pk + m // 2) % m - m // 2
    ps = np.where((p > thr) & (np.abs(dist_pk) <= m // 8), p - floor, 0.0)
    w = ps / ps.sum()
    ang = float(np.angle(np.sum(w * np.exp(2j * np.pi * np.arange(m) / m))))
    b0 = ang / (2.0 * np.pi) * m
    dist = (np.arange(m) - b0 + m / 2.0) % m - m / 2.0
    return float(np.sqrt(np.sum(w * dist**2)) / (m * df))


def estimate_doppler(problem: Problem) -> float:
    """Doppler spread (Hz, uniform-spread half-width F) of one problem: a
    least-squares line of log|r(dt)| against dt^2 over all DM-RS symbol pairs
    of hop 1 (small-angle expansion of sinc(2 F dt)); two-symbol hops take a
    noise-corrected single ratio. 0.0 for single-DM-RS-symbol hops."""
    h, _, hp = _hop1_pilot_estimates(problem)
    if hp.n_dsym < 2:
        return 0.0

    cfg = problem.config
    cpds = cfg.cp_durations_np * cfg.scs_hz / 1000.0  # symbol-duration units
    vec = np.empty(14)
    vec[0] = cpds[0]
    vec[1:] = cpds[1:14] + 1.0
    t = np.cumsum(vec)[hp.dmrs_sym_idx] / cfg.scs_hz  # seconds

    n = hp.n_dsym
    xs, ys = [], []
    for j in range(n):
        for k in range(j + 1, n):
            r = np.abs(np.mean(h[:, k] * np.conj(h[:, j])))
            xs.append((t[k] - t[j]) ** 2)
            ys.append(np.log(max(r, 1e-30)))
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    if np.unique(np.round(xs, 16)).size >= 2:
        b = np.polyfit(xs, ys, 1)[0]
        return float(np.sqrt(max(-b, 0.0) * 6.0) / (2.0 * np.pi))
    # single pair gap: noise-correct the power from frequency-adjacent diffs
    sig2 = float(np.mean(np.abs(np.diff(h[:, 0])) ** 2)) / 2.0
    p = max(float(np.mean(np.abs(h) ** 2)) - sig2, 1e-30)
    ratio = min(float(np.exp(ys[0])) / p, 1.0 - 1e-9)
    return float(np.sqrt(max(-np.log(ratio), 0.0) * 6.0) / (2.0 * np.pi * np.sqrt(xs[0])))


def _snap_wiener_delay(problems: List[Problem], grid) -> List[Problem]:
    """Each wiener problem's delay-spread prior replaced by the grid value
    nearest (in log) to its measured delay spread; the grid bounds the number
    of plan signatures."""
    taus = np.asarray(sorted(float(t) for t in grid), np.float64)
    if not (taus.size > 0 and np.all(taus > 0)):
        raise ValueError(f"wiener_auto_delay needs positive delay spreads: {grid!r}")
    out = []
    for p in problems:
        if p.config.smoothing == "wiener":
            t_hat = max(estimate_delay_spread(p), float(taus[0]))
            best = float(taus[np.argmin(np.abs(np.log(taus) - np.log(t_hat)))])
            p = dataclasses.replace(
                p, config=dataclasses.replace(p.config, wiener_delay_spread_s=best)
            )
        out.append(p)
    return out


def _auto_time_interp(problems: List[Problem], thr_hz: float) -> List[Problem]:
    """Problems with time_interp="none" whose measured Doppler spread exceeds
    `thr_hz` are served with time_interp="linear"."""
    return [
        dataclasses.replace(p, config=dataclasses.replace(p.config, time_interp="linear"))
        if (
            p.config.time_interp == "none"
            and p.config.smoothing != "learned2d"
            and estimate_doppler(p) > thr_hz
        )
        else p
        for p in problems
    ]


# ---------------------------------------------------------------------------
# Scatters: one fetched batch -> per-problem host results
# ---------------------------------------------------------------------------


def _merge_batch(ch_ri: np.ndarray) -> np.ndarray:
    """(B, 2, ...) ri batch -> (B, ...) complex: the native threaded
    interleave for float32 when it built; the numpy branch otherwise and for
    float64."""
    if ch_ri.dtype == np.float32 and _native.available():
        return _native.ri_to_complex(ch_ri)
    cdt = np.complex128 if ch_ri.dtype == np.float64 else np.complex64
    out = np.empty(ch_ri.shape[:1] + ch_ri.shape[2:], cdt)
    out.real = ch_ri[:, 0]
    out.imag = ch_ri[:, 1]
    return out


def _scalars(out, k: int) -> dict:
    return {n: float(getattr(out, n)[k])
            for n in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")}


def _scatter_out(out, chunk, results) -> None:
    ch = _merge_batch(out.channel_est_rg)  # (B, nL, n_sym, n_sc) complex
    for k, i in enumerate(chunk):
        results[i] = ServeResult(
            channel_est_rg=np.moveaxis(ch[k], (0, 1, 2), (2, 1, 0)), **_scalars(out, k)
        )


def _scatter_out_factored(out, chunk, results, sig) -> None:
    hop1, hop2 = sig
    prof = _merge_batch(out.profiles)  # (B, n_hops, nL, n_sc) complex
    rot = _merge_batch(out.sym_rot)  # (B, n_sym) complex
    for k, i in enumerate(chunk):
        results[i] = FactoredServeResult(
            profiles=prof[k], sym_rot=rot[k], **_scalars(out, k), hop1=hop1, hop2=hop2
        )


def _expand_sinr_grid(sinr_k, n_sc, n_sym, n_layers, hop_cfgs, factored):
    """One problem's receiver SINR -> (n_sc, n_sym, nL) float32 grid (the
    factored form is time-invariant per hop; the expansion is a broadcast)."""
    if factored:
        sg = np.zeros((n_sc, n_sym, n_layers), np.float32)
        for h, hc in enumerate(hop_cfgs):
            s0, s1 = hc.start_symbol, hc.start_symbol + hc.n_allocated_symbols
            sg[:, s0:s1, :] = sinr_k[h].T[:, None, :]
        return sg
    return np.moveaxis(sinr_k, (0, 1, 2), (2, 1, 0)).astype(np.float32)


def _scatter_out_equalized(out, chunk, results, sig, factored) -> None:
    hop1, hop2 = sig
    x = _merge_batch(out.x)  # (B, nL, n_sym, n_sc) complex
    nL, n_sym, n_sc = x.shape[1], x.shape[2], x.shape[3]
    hop_cfgs = [hop1] + ([hop2] if hop2 is not None else [])
    for k, i in enumerate(chunk):
        results[i] = EqualizedServeResult(
            x=np.moveaxis(x[k], (0, 1, 2), (2, 1, 0)),
            sinr=_expand_sinr_grid(out.sinr[k], n_sc, n_sym, nL, hop_cfgs, factored),
            **_scalars(out, k),
        )


def _scatter_out_llrs(out, chunk, results, sig, factored, llr_scale) -> None:
    hop1, hop2 = sig
    llr = np.stack(out.llr, axis=1)  # (B, nbits, nL, n_sym, n_sc)
    n_sym, n_sc = llr.shape[3], llr.shape[4]
    hop_cfgs = [hop1] + ([hop2] if hop2 is not None else [])
    for k, i in enumerate(chunk):
        results[i] = LlrServeResult(
            llr=np.moveaxis(llr[k], (0, 1, 2, 3), (3, 2, 1, 0)),  # (sc, sym, nL, bits)
            sinr=_expand_sinr_grid(out.sinr[k], n_sc, n_sym, llr.shape[2], hop_cfgs, factored),
            **_scalars(out, k),
            llr_scale=llr_scale,
        )


def _chunks(idxs: List[int], batch_size: int):
    """(chunk, take) per batch of a bucket: `take` repeat-pads the tail chunk
    to batch_size when the bucket spans more than one batch."""
    for start in range(0, len(idxs), batch_size):
        chunk = idxs[start : start + batch_size]
        pad = batch_size - len(chunk) if len(idxs) > batch_size else 0
        yield chunk, chunk + [chunk[-1]] * pad


def _batch_inputs(problems, take, device, multi_rx: bool):
    """The device tensors (rg_ri, pil_ri, beta) of one chunk; `multi_rx` gives
    every grid the receiver's (n_rx, n_sc, n_sym) form."""
    def rg(p: Problem):
        return np.asarray(p.received_rg)[None] if multi_rx and p.received_rg.ndim == 2 \
            else p.received_rg

    def packed(arrays):
        shape = (len(arrays), 2) + np.shape(arrays[0])
        return _stage(functools.partial(_assemble, arrays), shape, torch.float32, device)

    beta = np.asarray([problems[i].beta for i in take], np.float32)
    return (packed([rg(problems[i]) for i in take]), packed([problems[i].pilots for i in take]),
            _to_device(beta, device))


# ---------------------------------------------------------------------------
# The decoded tail
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _device_decode_builder(coding, hop1, hop2, n_sc: int, n_sym: int, n_layers: int,
                           nbits: int, device: torch.device):
    """`run(planes) -> packed` for one (geometry, coding, device): descramble,
    deinterleave, rate-recover and decode the receiver's int8 LLR planes
    (each (B, nL, n_sym, n_sc)) on the device, as the JAX package's
    device decode does (serving.py:448-551):

      * scrambling as per-bit sign planes;
      * one flat gather over the concatenated int8->f32 planes (the bit-plane
        choice folded into the index), batch-leading here (the JAX program's
        batch-last frame is a TPU gather layout; the values are the same);
      * r_max rate-recovery gathers whose repeats add, then re-clipped to the
        int8 range as extract_streams' int16 accumulate does; fillers pinned
        at 127;
      * the decoder (ops/ldpc.build_decoder, its tier routed for `device`);
      * the payload bit-packed big-endian (as np.unpackbits reads it) with the
        parity flag as a trailing byte: (B, c_words, ceil(k/8) + 1) uint8."""
    lay = transport.layout(coding, hop1, hop2, n_sc, n_sym, n_layers, nbits)
    tabs = transport.device_extract_tables(lay, nbits, n_layers, n_sym, n_sc)
    sgn = None
    if coding.scramble_c_init is not None:
        pl = transport.scramble_planes(coding.scramble_c_init, n_sc, n_sym, n_layers, nbits)
        sgn = [
            torch.as_tensor((1.0 - 2.0 * pl[..., b].astype(np.float32)).transpose(2, 1, 0).copy(),
                            device=device)
            for b in range(nbits)
        ]  # per-bit (nL, n_sym, n_sc)
    dec = ldpc.build_decoder(
        coding.code, n_iters=coding.n_iters, norm=coding.norm, kernels=coding.kernels,
        schedule=coding.schedule, layered_group=coding.layered_group,
        stream_c2v_dtype=coding.stream_c2v_dtype, device=device,
    )
    inv = torch.as_tensor(tabs["inv"].astype(np.int64), device=device)  # (r_max, n) into [0, tx_bits]
    filler = torch.as_tensor(tabs["filler"], device=device)  # (n,) bool
    c_words, tx_bits, n_code = lay.c_words, lay.tx_bits, lay.n
    plane_len = n_layers * n_sym * n_sc
    src_all = torch.as_tensor(
        np.asarray(tabs["bit"], np.int64) * plane_len + np.asarray(tabs["src"], np.int64),
        device=device,
    )
    bit_w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=device)

    def run(planes) -> torch.Tensor:
        B = planes[0].shape[0]
        ps = [p.to(torch.float32) for p in planes]
        if sgn is not None:
            ps = [p * s for p, s in zip(ps, sgn)]
        flat = torch.cat([p.reshape(B, -1) for p in ps], dim=1)  # (B, nbits * plane_len)
        stream = flat[:, src_all].reshape(B, c_words, tx_bits)
        subp = torch.cat([stream, stream.new_zeros((B, c_words, 1))], dim=2)
        post = subp[:, :, inv[0]]  # (B, c_words, n)
        for r in range(1, inv.shape[0]):
            post = post + subp[:, :, inv[r]]
        if inv.shape[0] > 1:
            post = torch.clamp(post, -127.0, 127.0)
        post = torch.where(filler, torch.full_like(post, 127.0), post)
        res = dec(post.reshape(B * c_words, n_code))
        info = res.info.reshape(B, c_words, -1)
        k = info.shape[-1]
        k8 = -(-k // 8) * 8
        if k8 != k:
            info = torch.nn.functional.pad(info, (0, k8 - k))
        packed = (info.reshape(B, c_words, k8 // 8, 8).to(torch.int32) * bit_w).sum(-1)
        ok_byte = res.ok.reshape(B, c_words, 1)
        return torch.cat([packed.to(torch.uint8), ok_byte.to(torch.uint8)], dim=-1)

    return run


_SCALARS = ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz")


@functools.lru_cache(maxsize=64)
def _device_decode_chunk(fn, run) -> graphs.Graphed:
    """`step(rg_ri, pil_ri, beta, params) -> (packed, scalars)`: one chunk of
    the device decode path, the receiver `fn` and the decode tail `run`
    (`_device_decode_builder`), one CUDA graph a chunk shape on the card.
    `scalars` is the (5, B) float32 row of the receiver's measurements."""

    def step(rg_ri, pil_ri, beta, params):
        res = fn(rg_ri, pil_ri, beta, params)
        scal = torch.stack([getattr(res, n).to(torch.float32) for n in _SCALARS])
        return run(res.llr), scal

    return graphs.Graphed(step, f"device decode chunk of {fn._name()}")


def _check_params(config: EstimatorConfig, params) -> None:
    """The learned smoothings need the denoiser's params (serving.py:632, :976
    of the JAX package)."""
    if config.smoothing in ("learned", "learned2d") and params is None:
        raise ValueError(f"smoothing={config.smoothing!r} needs params")


def _process_decoded_device(problems, coding, batch_size, matmul_precision, data_beta,
                            modulation, llr_scale, inflight, wiener_auto_delay,
                            auto_time_interp_hz, device, params=None):
    """process(out="decoded", decode_on_device=True): the whole chain per
    chunk on the device; the host fetches the packed payloads, the parity
    bytes and one (5, B) row of measurement scalars (soft=None on the
    results). `coding.early_iters` is ignored, as in the JAX package's device
    path (its two-phase retry is host-driven); one shared coding only."""
    if isinstance(coding, (list, tuple)):
        raise ValueError("decode_on_device supports a single shared coding")
    if wiener_auto_delay is not None:
        problems = _snap_wiener_delay(problems, wiener_auto_delay)
    if auto_time_interp_hz is not None:
        problems = _auto_time_interp(problems, float(auto_time_interp_hz))
    nbits = demap.bits_per_symbol(modulation)
    k_full = ldpc.make_ldpc_plan(coding.code).k
    k_pay = transport.payload_bits(coding, k_full)
    k_eff = k_full - coding.n_filler

    buckets: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(problems):
        buckets.setdefault(p.signature(), []).append(i)
    results: List[Optional[DecodedServeResult]] = [None] * len(problems)
    pending: deque = deque()

    def fetch(copy, chunk):
        blob, scal = copy.get()  # (B, c_words, k8/8 + 1) uint8, (5, B) f32
        ok_h = blob[..., -1].astype(bool)
        info_h = np.unpackbits(blob[..., :-1], axis=-1)[..., :k_full]
        if coding.crc is not None:
            # one batched CRC pass per chunk: one table entry per message
            # byte, the table cached per (kind, length)
            B = info_h.shape[0]
            ok_h = ok_h & transport.crc_check(
                info_h[:, :, :k_eff].reshape(B * info_h.shape[1], k_eff), coding.crc
            ).reshape(B, info_h.shape[1])
        for k, i in enumerate(chunk):
            info = info_h[k]
            if coding.crc is not None or coding.n_filler:
                info = info[:, :k_pay]
            results[i] = DecodedServeResult(
                info=info, ok=ok_h[k], soft=None,
                **{n: float(scal[j, k]) for j, n in enumerate(_SCALARS)},
            )

    for sig, idxs in buckets.items():
        hop1, hop2, config, n_layers, n_rx = sig
        if matmul_precision is not None:
            config = dataclasses.replace(config, matmul_precision=matmul_precision)
        _check_params(config, params)
        fn = receiver.build_receiver_ri(
            hop1, hop2, config, n_layers, n_rx, batched=True, data_beta=data_beta,
            modulation=modulation, llr_scale=llr_scale, device=device,
        )
        n_sc, n_sym = problems[idxs[0]].received_rg.shape[-2:]
        run = _device_decode_builder(coding, hop1, hop2, int(n_sc), int(n_sym), n_layers,
                                     nbits, device)
        step = _device_decode_chunk(fn, run)
        for chunk, take in _chunks(idxs, batch_size):
            pending.append((_HostCopy(step(*_batch_inputs(problems, take, device, multi_rx=True),
                                           params)), chunk))
            if len(pending) >= max(1, inflight):
                fetch(*pending.popleft())
    while pending:
        fetch(*pending.popleft())
    return results


def _decode_soft(problems: List[Problem], soft: List[LlrServeResult], coding,
                 device: torch.device, word_batch: int = 512) -> List[DecodedServeResult]:
    """Decode served LLR grids into payloads (the host `out="decoded"` tail):
    per-problem descramble and deinterleave (transport), then one batched
    decode per word chunk, each chunk repeat-padded to a power-of-two bucket
    in [32, word_batch] so the data-dependent retry sizes see a bounded set
    of batch shapes. With `coding.early_iters` every word first runs that
    many sweeps and only the parity failures rerun at n_iters."""
    dec_args = dict(norm=coding.norm, kernels=coding.kernels, schedule=coding.schedule,
                    layered_group=coding.layered_group,
                    stream_c2v_dtype=coding.stream_c2v_dtype, device=device)
    dec = ldpc.build_decoder(coding.code, n_iters=coding.n_iters, **dec_args)
    early = coding.early_iters
    dec_early = None
    if early is not None and early < coding.n_iters:
        dec_early = ldpc.build_decoder(coding.code, n_iters=early, **dec_args)
    layouts: Dict[Tuple, transport.TransportLayout] = {}
    planes: Dict[Tuple, np.ndarray] = {}
    streams: List[np.ndarray] = []
    counts: List[int] = []
    for p, s in zip(problems, soft):
        llr = s.llr  # (n_sc, n_sym, nL, nbits) int8
        n_sc, n_sym, n_layers, nbits = llr.shape
        key = (p.hop1, p.hop2, n_sc, n_sym, n_layers, nbits)
        if key not in layouts:
            layouts[key] = transport.layout(coding, p.hop1, p.hop2, n_sc, n_sym, n_layers, nbits)
            if coding.scramble_c_init is not None:
                planes[key] = transport.scramble_planes(
                    coding.scramble_c_init, n_sc, n_sym, n_layers, nbits
                )
        lay = layouts[key]
        if coding.scramble_c_init is not None:
            llr = demap.descramble_llrs(llr, planes[key])
        streams.append(transport.extract_streams(lay, llr))
        counts.append(lay.c_words)
    words = np.concatenate(streams, axis=0)

    def run_chunks(decoder, w):
        infos, oks = [], []
        for start in range(0, w.shape[0], word_batch):
            chunk = w[start : start + word_batch]
            n = chunk.shape[0]
            bucket = 32
            while bucket < n:
                bucket *= 2
            bucket = min(bucket, word_batch)
            if n < bucket:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bucket - n, axis=0)])
            r = decoder(chunk)
            infos.append(r.info[:n].cpu().numpy())
            oks.append(r.ok[:n].cpu().numpy())
        return np.concatenate(infos, axis=0), np.concatenate(oks, axis=0)

    if dec_early is not None:
        info, ok = run_chunks(dec_early, words)
        retry = np.nonzero(~ok)[0]
        if retry.size:
            info2, ok2 = run_chunks(dec, words[retry])
            info[retry] = info2
            ok[retry] = ok2
    else:
        info, ok = run_chunks(dec, words)
    k_eff = info.shape[1] - coding.n_filler  # systematic bits minus known-zero fillers
    if coding.crc is not None:
        ok = ok & transport.crc_check(info[:, :k_eff], coding.crc)
    if coding.crc is not None or coding.n_filler:
        info = info[:, : transport.payload_bits(coding, info.shape[1])]  # strip CRC + fillers
    out: List[DecodedServeResult] = []
    pos = 0
    for s, c in zip(soft, counts):
        out.append(DecodedServeResult(info=info[pos : pos + c], ok=ok[pos : pos + c], soft=s))
        pos += c
    return out


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def process(
    problems: List[Problem],
    batch_size: int = 128,
    matmul_precision: Optional[str] = "high",
    params=None,
    inflight: int = 3,
    wiener_auto_delay=None,
    auto_time_interp_hz: Optional[float] = None,
    out: str = "grid",
    data_beta: float = 1.0,
    modulation: Optional[str] = None,
    llr_scale: float = 8.0,
    coding=None,
    decode_on_device: bool = False,
    device="cuda",
):
    """Serve a heterogeneous list of problems on `device` (the card by default;
    raises when there is none); results in submission order. The signature of
    `srsran_ce_tpu.serving.process`.

    Problems are bucketed by plan signature and each bucket runs in
    `batch_size` chunks (the tail chunk padded by repetition).
    `matmul_precision` overrides every problem's config precision (None keeps
    each config's own). `params` is the denoiser's (`models.denoiser.
    load_shipped` or `params_from_flax`), required for problems whose config
    uses a learned smoothing (one shared params: mixed 1-D / 2-D learned
    problems need separate calls); it reaches every output. Up to
    `inflight` dispatched chunks stay unfetched while the host packs the
    next one.

    `wiener_auto_delay`: candidate delay spreads (seconds); each wiener
    problem's prior is snapped to the nearest one to its measured delay
    spread. `auto_time_interp_hz`: problems whose measured Doppler spread
    exceeds it are served with time_interp="linear".

    out: "grid" (ServeResult), "factored" (FactoredServeResult; every problem
    time_interp="none"), "equalized" (the joint multi-RX receiver,
    EqualizedServeResult; `data_beta` scales the data REs), "llrs" (the
    receiver with the int8 demapper, `modulation` required, LlrServeResult)
    or "decoded" (`coding=transport.TransportCoding(...)` — or one per
    problem — required): descramble, deinterleave, rate recovery, batched
    min-sum decode and CRC, on the host or, with `decode_on_device=True`,
    on the device (only the decoded bits and parity flags reach the host,
    soft=None, one shared coding, early_iters ignored)."""
    device = devices.resolve(device)
    if out not in ("grid", "factored", "equalized", "llrs", "decoded"):
        raise ValueError(
            f"out must be 'grid', 'factored', 'equalized', 'llrs' or 'decoded': {out!r}"
        )
    if out in ("llrs", "decoded") and modulation is None:
        raise ValueError(f"out={out!r} requires modulation=")
    if out == "decoded":
        if coding is None:
            raise ValueError("out='decoded' requires coding=transport.TransportCoding(...)")
        if decode_on_device:
            return _process_decoded_device(
                problems, coding, batch_size, matmul_precision, data_beta, modulation,
                llr_scale, inflight, wiener_auto_delay, auto_time_interp_hz, device, params,
            )
        soft = process(
            problems, batch_size=batch_size, matmul_precision=matmul_precision,
            params=params, inflight=inflight, wiener_auto_delay=wiener_auto_delay,
            auto_time_interp_hz=auto_time_interp_hz, out="llrs", data_beta=data_beta,
            modulation=modulation, llr_scale=llr_scale, device=device,
        )
        if isinstance(coding, (list, tuple)):
            # per-problem codings: each group of equal codings decodes together
            if len(coding) != len(problems):
                raise ValueError(f"coding list length {len(coding)} != {len(problems)} problems")
            results_d: List[Optional[DecodedServeResult]] = [None] * len(problems)
            groups: Dict[object, List[int]] = {}
            for i, c in enumerate(coding):
                groups.setdefault(c, []).append(i)
            for c, idxs in groups.items():
                sub = _decode_soft([problems[i] for i in idxs], [soft[i] for i in idxs], c, device)
                for i, r in zip(idxs, sub):
                    results_d[i] = r
            return results_d
        return _decode_soft(problems, soft, coding, device)
    equalized = out in ("equalized", "llrs")
    factored = out == "factored"
    if not equalized:
        bad_rx = [i for i, p in enumerate(problems) if p.n_rx != 1]
        if bad_rx:
            raise ValueError(f"multi-RX problems need out='equalized'; problems {bad_rx[:5]}")
    if factored:
        if auto_time_interp_hz is not None:
            raise ValueError("out='factored' is incompatible with auto_time_interp_hz")
        bad = [i for i, p in enumerate(problems) if p.config.time_interp != "none"]
        if bad:
            raise ValueError(
                f"out='factored' requires time_interp='none'; problems {bad[:5]} differ"
            )

    if wiener_auto_delay is not None:
        problems = _snap_wiener_delay(problems, wiener_auto_delay)
    if auto_time_interp_hz is not None:
        problems = _auto_time_interp(problems, float(auto_time_interp_hz))

    buckets: Dict[Tuple, List[int]] = {}
    for i, p in enumerate(problems):
        buckets.setdefault(p.signature(), []).append(i)

    results: list = [None] * len(problems)
    pending: deque = deque()  # (scatter, host copy, chunk) not yet fetched
    for sig, idxs in buckets.items():
        hop1, hop2, config, n_layers, n_rx = sig
        if matmul_precision is not None:
            config = dataclasses.replace(config, matmul_precision=matmul_precision)
        _check_params(config, params)
        if equalized:
            fn = receiver.build_receiver_ri(
                hop1, hop2, config, n_layers, n_rx, batched=True, data_beta=data_beta,
                modulation=modulation if out == "llrs" else None, llr_scale=llr_scale,
                device=device,
            )
            fac = config.time_interp == "none"
            if out == "llrs":
                scatter = functools.partial(_scatter_out_llrs, sig=(hop1, hop2), factored=fac,
                                            llr_scale=llr_scale)
            else:
                scatter = functools.partial(_scatter_out_equalized, sig=(hop1, hop2),
                                            factored=fac)
        else:
            fn = estimator.build_ri(
                hop1, hop2, config, n_layers, batched=True,
                out_layout="factored" if factored else "serve",
            )
            scatter = (functools.partial(_scatter_out_factored, sig=(hop1, hop2))
                       if factored else _scatter_out)
        for chunk, take in _chunks(idxs, batch_size):
            res = fn(*_batch_inputs(problems, take, device, multi_rx=equalized), params)
            pending.append((scatter, _HostCopy(res), chunk))
            if len(pending) >= max(1, inflight):
                sc, copy, c = pending.popleft()
                sc(copy.get(), c, results=results)
    while pending:
        sc, copy, c = pending.popleft()
        sc(copy.get(), c, results=results)
    return results


class TrackedServer:
    """Stateful serving on `device` (the card by default): multi-slot tracking
    (models/tracking.py) per stream, `srsran_ce_tpu.serving.TrackedServer` in
    torch.

    A stream is a recurring sounding of one physical link (same plan
    signature, same cell/UE/port), named by a caller-chosen `stream_id`. The
    server buckets requests by plan signature as `process` does, runs the
    batched tracked function, and threads each stream's (h, w) state across
    calls; an unseen stream starts from the zero state (its first sounding
    passes through). Submit at most one sounding per stream per call: two
    requests for one stream in a call both read the same prior state (the
    last write wins).

    The state is keyed per (signature, mode family): the grid mode
    (out="grid", one RX port) and the receiver modes (out="equalized" /
    "llrs", a state per RX port) carry different shapes, so a stream that
    switches between the two families is reset (its next sounding passes
    through, as for a new stream). States live on the host as numpy arrays,
    as in the JAX package; in grid mode w is stored as a float."""

    def __init__(self, batch_size: int = 128, matmul_precision: Optional[str] = "high",
                 device="cuda"):
        self.batch_size = batch_size
        self.matmul_precision = matmul_precision
        self.device = devices.resolve(device)
        self._state: Dict[Tuple, tuple] = {}  # (sig, stream_id) -> (h tuple, w)
        self._mode: Dict = {}  # stream_id -> last mode family (True = receiver)

    def reset(self, stream_id=None) -> None:
        """Drop the tracking state of one stream, or of all when stream_id is None."""
        if stream_id is None:
            self._state.clear()
            self._mode.clear()
        else:
            self._state = {k: v for k, v in self._state.items() if k[1] != stream_id}
            self._mode.pop(stream_id, None)

    def process(self, problems: List[Problem], stream_ids: List, out: str = "grid",
                modulation: Optional[str] = None, data_beta: float = 1.0,
                llr_scale: float = 8.0):
        """out="grid" (default): tracked channel-estimate grids, ServeResults
        (single-port problems). out="equalized" / "llrs": the tracked multi-RX
        receiver (models/receiver.build_tracked_receiver_ri), each stream's
        per-port states threaded across soundings; `modulation` required for
        "llrs", as in `process`."""
        if out not in ("grid", "equalized", "llrs"):
            raise ValueError(f"out must be 'grid', 'equalized' or 'llrs': {out!r}")
        if out == "llrs" and modulation is None:
            raise ValueError("out='llrs' requires modulation=")
        if len(problems) != len(stream_ids):
            raise ValueError(f"{len(problems)} problems, {len(stream_ids)} stream ids")
        device = self.device
        mode = out != "grid"
        for sid in stream_ids:
            if self._mode.get(sid, mode) != mode:
                self.reset(sid)
            self._mode[sid] = mode
        buckets: Dict[Tuple, List[int]] = {}
        for i, p in enumerate(problems):
            buckets.setdefault(p.signature(), []).append(i)

        results: list = [None] * len(problems)
        for sig, idxs in buckets.items():
            hop1, hop2, config, n_layers, n_rx = sig
            if out == "grid" and n_rx != 1:
                raise ValueError("out='grid' tracks one RX port per problem")
            if self.matmul_precision is not None:
                config = dataclasses.replace(config, matmul_precision=self.matmul_precision)
            eff_sig = (hop1, hop2, config, n_layers, n_rx, mode)
            if out == "grid":
                fn = tracking.build_tracked_ri(hop1, hop2, config, n_layers, batched=True,
                                               out_layout="serve", device=device)
                zero_h, zero_w = tracking.init_state(hop1, hop2, config, n_layers, device="cpu")
                zero_w = float(zero_w)
            else:
                fn = receiver.build_tracked_receiver_ri(
                    hop1, hop2, config, n_layers, n_rx, data_beta=data_beta,
                    modulation=modulation if out == "llrs" else None, llr_scale=llr_scale,
                    batched=True, device=device,
                )
                zero_h, zero_w = tracking.init_state(hop1, hop2, config, n_layers, batch=n_rx,
                                                     device="cpu")
                zero_w = zero_w.numpy()
            zero_h = tuple(h.numpy() for h in zero_h)
            for chunk, take in _chunks(idxs, self.batch_size):
                states = [self._state.get((eff_sig, stream_ids[i]), (zero_h, zero_w))
                          for i in take]
                h_b = tuple(np.stack([s[0][j] for s in states]) for j in range(len(zero_h)))
                w_b = np.asarray([s[1] for s in states], np.float32)
                res, h_new, w_new = fn(
                    *_batch_inputs(problems, take, device, multi_rx=mode),
                    tuple(_to_device(h, device) for h in h_b), _to_device(w_b, device),
                )
                o, h_new, w_new = _HostCopy((res, h_new, w_new)).get()
                if out == "llrs":
                    _scatter_out_llrs(o, chunk, results, sig=(hop1, hop2), factored=True,
                                      llr_scale=llr_scale)
                elif out == "equalized":
                    _scatter_out_equalized(o, chunk, results, sig=(hop1, hop2), factored=True)
                else:
                    _scatter_out(o, chunk, results)
                for k, i in enumerate(chunk):
                    self._state[(eff_sig, stream_ids[i])] = (
                        tuple(h[k] for h in h_new),
                        w_new[k] if mode else float(w_new[k]),
                    )
        return results
