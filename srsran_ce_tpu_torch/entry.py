"""Entry points of the port: the flagship c2 case through the batched serve
estimator, and the multi-rank dry run of the sharded paths.

Counterpart of `__graft_entry__.entry()`: 106 PRB, 4 layers, comb 2, 30 kHz,
at matmul_precision="high", through `models.estimator.build_ri(...,
batched=True, out_layout="serve", kernels="pallas_front")`. On the card
(the default `device`) the two kernels run; with device="cpu" their plain
versions. `dryrun_multichip(n)` spawns a world of n ranks and runs
`dryrun_body` on each: the JAX checklist `__graft_entry__.dryrun_multichip`
on the port's sharded paths.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import devices
from .models import estimator
from .utils import synthetic


def entry(device="cuda", batch: int = 8):
    """(forward, (rg_ri, pil_ri, beta)): the batched serve estimator of the c2
    case at matmul_precision="high" and the case tiled to `batch` problems, as
    float32 ri tensors on `device` (the card by default; raises when there is
    none: pass device="cpu" for the plain versions on the CPU)."""
    device = devices.resolve(device)
    case = synthetic.make_case(
        seed=0, n_prbs=106, n_layers=4, comb=2, scs_hz=30e3, snr_db=30.0
    )
    rg = estimator.split_ri(case.received_rg.astype(np.complex64))
    pil = estimator.split_ri(case.pilots.astype(np.complex64))
    rg_b = torch.as_tensor(np.broadcast_to(rg, (batch,) + rg.shape).copy(), device=device)
    pil_b = torch.as_tensor(np.broadcast_to(pil, (batch,) + pil.shape).copy(), device=device)
    beta = torch.ones(batch, dtype=torch.float32, device=device)
    cfg = dataclasses.replace(case.config, matmul_precision="high")
    forward = estimator.build_ri(
        case.hop1, case.hop2, cfg, 4, batched=True, out_layout="serve", kernels="pallas_front"
    )
    return forward, (rg_b, pil_b, beta)


def dryrun_body(device=None) -> str:
    """One full sharded step on this rank of an initialized world: the port's
    counterpart of the JAX checklist `__graft_entry__.dryrun_multichip` at its
    tiny shapes. Mesh (n/2, 2) when the world size is even, else (n, 1):
    the batched estimator over dp and sp (SP, or DP with one shard), the
    hopped SP route and the factored layout; the DP receiver and its fused
    16QAM demapper; the DP decoder (array code, payload-exact); NR decoded
    serving (rate-matched BG2 words through the DP LLR receiver and the DP
    decoder, payload-exact); one data-parallel training step. Every rank
    calls it; rank 0 gets the summary (the others an empty string). A gloo
    world on the card runs eagerly (`graphs.eager()`)."""
    import contextlib

    import torch.distributed as dist

    from . import graphs

    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    gloo_card = dev.type == "cuda" and dist.get_backend() != "nccl"
    with graphs.eager() if gloo_card else contextlib.nullcontext():
        return _dryrun(dist.get_world_size(), dev)


def _dryrun(n: int, dev: torch.device) -> str:
    import torch.distributed as dist

    from . import transport
    from .models import denoiser, training
    from .ops import ldpc, nr_ldpc
    from .parallel import data_parallel as dp
    from .parallel import mesh as mesh_lib
    from .parallel import subcarrier as sp

    n_sp = 2 if n % 2 == 0 else 1
    n_dp = n // n_sp
    mesh = mesh_lib.make_mesh((n_dp, n_sp), ("dp", "sp"))
    batch = 2 * n_dp
    t = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)

    def tiled(case):
        rg = estimator.split_ri(case.received_rg.astype(np.complex64))
        pil = estimator.split_ri(case.pilots.astype(np.complex64))
        return (t(np.broadcast_to(rg, (batch,) + rg.shape)), t(np.broadcast_to(pil, (batch,) + pil.shape)),
                t(np.full(batch, case.beta)))

    case = synthetic.make_case(seed=3, n_prbs=8, n_layers=2, comb=2, scs_hz=30e3, snr_db=30.0)
    rg_b, pil_b, beta = tiled(case)
    if n_sp > 1:
        fn = sp.build_sp_batched(case.hop1, case.hop2, case.config, 2, mesh, device=dev)
        out = fn.gather_outputs(fn(*fn.shard_inputs(rg_b, pil_b), _dp_slice(beta, mesh)))
    else:
        fn = dp.build_dp_batched(case.hop1, case.hop2, case.config, 2, mesh, device=dev)
        out = fn.gather(fn(fn.shard(rg_b), fn.shard(pil_b), fn.shard(beta)))
    ch = out.channel_est_rg.cpu().numpy()
    _need(np.isfinite(ch).all() and ch.shape[0] == batch, "non-finite channel estimate")
    if n_sp > 1:
        hop = synthetic.make_case(seed=5, n_prbs=4, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0,
                                  two_hops=True)
        rg_h, pil_h, beta_h = tiled(hop)
        fn_h = sp.build_sp_batched(hop.hop1, hop.hop2, hop.config, 1, mesh, device=dev)
        out_h = fn_h.gather_outputs(fn_h(*fn_h.shard_inputs(rg_h, pil_h), _dp_slice(beta_h, mesh)))
        _need(torch.isfinite(out_h.channel_est_rg).all(), "non-finite hopped estimate")
        fn_f = sp.build_sp_batched(case.hop1, case.hop2, case.config, 2, mesh,
                                   out_layout="factored", device=dev)
        out_f = fn_f.gather_outputs(fn_f(*fn_f.shard_inputs(rg_b, pil_b), _dp_slice(beta, mesh)))
        _need(torch.isfinite(out_f.profiles).all(), "non-finite factored profiles")

    # the DP receiver, then with the 16QAM demapper fused
    n_rx = 2
    rg_rx = rg_b[:, :, None].expand(rg_b.shape[:2] + (n_rx,) + rg_b.shape[2:]).contiguous()
    fn_r = dp.build_dp_receiver(case.hop1, case.hop2, case.config, 2, mesh, device=dev)
    out_r = fn_r.gather(fn_r(fn_r.shard(rg_rx), fn_r.shard(pil_b), fn_r.shard(beta)))
    _need(torch.isfinite(out_r.x).all(), "non-finite equalized symbols")
    fn_rl = dp.build_dp_receiver(case.hop1, case.hop2, case.config, 2, mesh, modulation="16qam",
                                 device=dev)
    out_rl = fn_rl.gather(fn_rl(fn_rl.shard(rg_rx), fn_rl.shard(pil_b), fn_rl.shard(beta)))
    _need(len(out_rl.llr) == 4 and out_rl.llr[0].dtype == torch.int8, "16QAM: 4 int8 planes")
    _need(any(bool((p != 0).any()) for p in out_rl.llr), "all-zero LLRs")

    # the DP decoder over every rank (a flat dp mesh)
    flat = mesh_lib.make_mesh((n,), ("dp",))
    code = ldpc.array_code(3, 8, 13)
    lplan = ldpc.make_ldpc_plan(code)
    rng = np.random.default_rng(11)
    u = rng.integers(0, 2, (2 * n, lplan.k), dtype=np.uint8)
    cw = ldpc.encode(code, u)
    llr_in = (4.0 * (1 - 2.0 * cw) + rng.normal(0, 0.6, cw.shape)).astype(np.float32)
    dec = dp.build_dp_decoder(code, flat, n_iters=12, device=dev)
    dres = dec.gather(dec(dec.shard(t(llr_in))))
    _need(np.array_equal(dres.info.cpu().numpy(), u) and bool(dres.ok.all()), "DP decode payload")

    # NR rate-matched decoded serving: BG2 words through the DP LLR receiver
    # and the DP decoder
    nr_code = nr_ldpc.nr_base_graph(2, 16)
    nr_plan = ldpc.make_ldpc_plan(nr_code)
    coding = transport.TransportCoding(code=nr_code, rate_match="nr", n_filler=8)
    geo = synthetic.make_case(seed=21, n_prbs=8, n_layers=1, comb=2, scs_hz=30e3, snr_db=30.0)
    n_sc_g, n_sym_g = geo.received_rg.shape
    lay = transport.layout(coding, geo.hop1, geo.hop2, n_sc_g, n_sym_g, 1, 2)
    rng_nr = np.random.default_rng(23)
    u_nr = rng_nr.integers(0, 2, (lay.c_words, nr_plan.k - coding.n_filler), np.uint8)
    words = np.concatenate([u_nr, np.zeros((lay.c_words, coding.n_filler), np.uint8)], axis=1)
    bits = transport.place_codewords(lay, ldpc.encode(nr_code, words), 1, 2, fill_rng=rng_nr)
    nr_case = synthetic.make_mimo_case(seed=21, n_rx=2, modulation="qpsk", bits=bits,
                                       scramble=False, n_prbs=8, n_layers=1, snr_db=25.0)
    rg_nr, pil_nr, beta_nr = tiled(nr_case)
    fn_nr = dp.build_dp_receiver(nr_case.hop1, nr_case.hop2, nr_case.config, 1, mesh,
                                 modulation="qpsk", device=dev)
    out_nr = fn_nr.gather(fn_nr(fn_nr.shard(rg_nr), fn_nr.shard(pil_nr), fn_nr.shard(beta_nr)))
    grid = np.stack([p.cpu().numpy() for p in out_nr.llr], axis=-1)  # (B, nL, sym, sc, nbits)
    grid = np.transpose(grid, (0, 3, 2, 1, 4))
    streams = np.concatenate([transport.extract_streams(lay, grid[b]) for b in range(batch)])
    n_words = streams.shape[0]
    pad = (-n_words) % n
    if pad:
        streams = np.concatenate([streams, streams[:pad]])
    dec_nr = dp.build_dp_decoder(nr_code, flat, n_iters=12, device=dev)
    res_nr = dec_nr.gather(dec_nr(dec_nr.shard(t(streams))))
    info = res_nr.info.cpu().numpy()[:n_words, : nr_plan.k - coding.n_filler]
    _need(np.array_equal(info, np.tile(u_nr, (batch, 1))), "NR decoded serving: payload")
    _need(bool(res_nr.ok[:n_words].all()), "NR decoded serving: parity")

    # one data-parallel denoiser training step (replicated params, dp batch)
    state, tx = training.init_state(seed=0, n_re=32, device=dev)
    step = training.build_train_step(tx, mesh)
    noisy, truth = denoiser.make_training_batch(np.random.default_rng(0), 2 * n_dp, 32)
    _, _, loss = step(state.params, state.opt_state, mesh_lib.batch_slice(t(noisy), mesh),
                      mesh_lib.batch_slice(t(truth), mesh))
    _need(np.isfinite(float(loss)), "non-finite training loss")
    if dist.get_rank() != 0:
        return ""
    return (f"dryrun_multichip OK: {n} ranks ({dist.get_backend()}, {dev}), mesh dp={n_dp} x "
            f"sp={n_sp}, batch={batch}, channel {tuple(ch.shape)}; NR decoded serving: {n_words} "
            f"rate-matched BG2 words payload-exact; train step loss {float(loss):.4f}")


def _dp_slice(x, mesh):
    """This rank's rows of a batch over the mesh's "dp" axis."""
    from .parallel import mesh as mesh_lib

    return mesh_lib.batch_slice(x, mesh, "dp")


def _need(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """`dryrun_body` in a spawned world of `n_devices` ranks on `device` (the
    card by default: NCCL when there is a card a rank, gloo on the shared
    card otherwise; gloo on the CPU). Returns rank 0's summary."""
    from .parallel import launch

    dev = devices.resolve(device)
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= n_devices
    out = launch.spawn_world(dryrun_body, n_devices, "nccl" if nccl else "gloo", dev.type)
    return out[0]
