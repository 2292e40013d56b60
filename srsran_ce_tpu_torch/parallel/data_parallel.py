"""Data-parallel estimation, reception and decoding: `srsran_ce_tpu/parallel/data_parallel.py`
on `torch.distributed`.

Problems (and codewords) are independent, so data parallelism takes no
collective at all: each rank runs the port's own builder on its slice of the
batch (`mesh.batch_slice`), and `mesh.gather_batch` assembles a global result
where one is wanted (the tests, chip_smoke). The estimator and the receiver
run the "xla" tier, as the JAX builders hard-code it (data_parallel.py:71,
:136); the decoder is `ops.ldpc.build_decoder`, so on the card `kernels=
"auto"` launches K4 (`csrc/ldpc.cu`) or K3 (`csrc/ldpc_stream.cu`), once a
rank a call. On the card each call replays the local builder's CUDA graph
(the estimator and the receiver are `graphs.Graphed`).

A learned smoothing takes the denoiser's params as a trailing argument,
replicated (every rank passes the same params).
"""
from __future__ import annotations

from typing import Optional

from .. import devices
from ..config import EstimatorConfig, HopConfig
from ..models import estimator as _est
from ..models import receiver as _rcv
from ..ops import ldpc as _ldpc
from . import mesh as _mesh


class DataParallel:
    """`fn(*rank-local args)`: the local builder on this rank's slice of the
    batch, with `shard(x)` (this rank's rows of a global batch) and
    `gather(result)` (the global result) over the mesh axis `axis`."""

    def __init__(self, local, mesh, axis: str):
        self.local = local
        self.mesh = mesh
        self.axis = axis
        _mesh.axis_size(mesh, axis)  # the axis must exist

    def __call__(self, *args):
        return self.local(*args)

    def shard(self, x):
        return _mesh.batch_slice(x, self.mesh, self.axis)

    def gather(self, result):
        return _mesh.gather_batch(result, self.mesh, self.axis)


def build_dp_batched(hop1: HopConfig, hop2: Optional[HopConfig], config: EstimatorConfig,
                     n_layers: int, mesh, axis: str = "dp", out_layout: str = "ref",
                     device="cuda") -> DataParallel:
    """fn(rg_ri[b, 2, n_sc, n_sym], pil_ri[b, 2, n_re, n_dsym, nL], beta[b][, params])
    -> EstimateResult | FactoredResult for this rank's b problems, the batched
    `estimator.build_ri` on the "xla" tier in `out_layout` ("ref", "serve" or
    "factored"). `device` only checks that the device exists (the default,
    the card, raises without one); tensors run where they lie."""
    devices.resolve(device)
    return DataParallel(_est.build_ri(hop1, hop2, config, n_layers, batched=True, kernels="xla",
                                      out_layout=out_layout), mesh, axis)


def build_dp_receiver(hop1: HopConfig, hop2: Optional[HopConfig], config: EstimatorConfig,
                      n_layers: int, mesh, axis: str = "dp", mode: str = "auto",
                      data_beta: float = 1.0, modulation=None, llr_scale: float = 8.0,
                      device="cuda") -> DataParallel:
    """fn(rg_ri[b, 2, n_rx, n_sc, n_sym], pil_ri[b, ...], beta[b][, params]) ->
    ReceiverResult | LlrResult for this rank's b problems: the batched
    `receiver.build_receiver_ri` (cached per n_rx, read from the grid) on the
    "xla" tier."""
    devices.resolve(device)

    def local(rg_ri, pil_ri, beta, params=None):
        fn = _rcv.build_receiver_ri(hop1, hop2, config, n_layers, int(rg_ri.shape[2]),
                                    batched=True, mode=mode, data_beta=data_beta, kernels="xla",
                                    modulation=modulation, llr_scale=llr_scale, device=device)
        return fn(rg_ri, pil_ri, beta, params)

    return DataParallel(local, mesh, axis)


def build_dp_decoder(code, mesh, n_iters: int = 20, norm: float = 0.75, kernels: str = "auto",
                     axis: str = "dp", schedule: str = "flooding", layered_group: int = 1,
                     stream_c2v_dtype: Optional[str] = None, device="cuda") -> DataParallel:
    """fn(llr[b, n]) -> DecodeResult for this rank's b codewords:
    `ops.ldpc.build_decoder` (its tier routing included) on the local slice."""
    return DataParallel(_ldpc.build_decoder(
        code, n_iters=n_iters, norm=norm, kernels=kernels, schedule=schedule,
        layered_group=layered_group, stream_c2v_dtype=stream_c2v_dtype, device=device), mesh, axis)
