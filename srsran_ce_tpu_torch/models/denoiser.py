"""The trainable pilot-estimate denoisers of the port: `srsran_ce_tpu/models/denoiser.py`
in torch, for serving (training is not ported yet, ROADMAP.md queue 1, item 8).

Two residual CNNs, each with "same" zero padding, ReLU between the layers and a
zero-initialised last layer (an untrained network is the identity, i.e.
smoothing "none"):

  PilotDenoiser    1-D over the pilot/frequency axis, 2 -> 48 -> 48 -> 2
                   channels, kernel 13 (smoothing="learned");
  PilotDenoiser2D  2-D over the (DM-RS symbol, frequency) grid, 2 -> 32 -> 32
                   -> 2 channels, kernel (3, 9) (smoothing="learned2d").

Both take channels last, (..., n_re, 2) and (..., n_dsym, n_re, 2), as the
flax modules do. The estimator's `params` is a state dict of the module
(`state_dict()` keys, tensors or numpy arrays): `params_from_flax` makes one
from the flax pytree, `load_shipped` the shipped checkpoints (converted from
`srsran_ce_tpu/artifacts/denoiser{,2d}_ckpt` into
`srsran_ce_tpu_torch/artifacts/denoiser{,2d}.npz`, flax layout, params only).

`apply_complex` and `apply_complex_2d` run the convolutions in float32 for
float64 inputs too (the JAX functions cast to float32 and back) and pin
`torch.backends.cudnn.allow_tf32 = False` around them: a TF32 convolution
would carry ~1e-3 relative error. A params dict is moved to a device once and
kept (`module_for`); treat it as immutable after its first use.
"""
from __future__ import annotations

import collections
import contextlib
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch import nn

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
SHIPPED = {"1d": "denoiser.npz", "2d": "denoiser2d.npz"}


class PilotDenoiser(nn.Module):
    """Residual 1-D CNN over the pilot/frequency axis; input and output
    (..., n_re, 2), re/im channels last."""

    def __init__(self, features: Sequence[int] = (48, 48), kernel_size: int = 13):
        super().__init__()
        self.features = tuple(features)
        self.kernel_size = kernel_size
        chans = (2,) + self.features + (2,)
        self.convs = nn.ModuleList(
            nn.Conv1d(a, b, kernel_size, padding=kernel_size // 2)
            for a, b in zip(chans[:-1], chans[1:])
        )
        _zero_last(self.convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, n = x.shape[:-2], x.shape[-2]
        h = x.reshape(-1, n, 2).transpose(1, 2)  # (N, 2, n_re)
        return x + _stack(self.convs, h).transpose(1, 2).reshape(lead + (n, 2))


class PilotDenoiser2D(nn.Module):
    """Residual 2-D CNN over the (DM-RS symbol, frequency) grid of per-symbol LS
    estimates; input and output (..., n_dsym, n_re, 2)."""

    def __init__(self, features: Sequence[int] = (32, 32), kernel_t: int = 3, kernel_f: int = 9):
        super().__init__()
        self.features = tuple(features)
        self.kernel_t, self.kernel_f = kernel_t, kernel_f
        chans = (2,) + self.features + (2,)
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, (kernel_t, kernel_f), padding=(kernel_t // 2, kernel_f // 2))
            for a, b in zip(chans[:-1], chans[1:])
        )
        _zero_last(self.convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, (t, n) = x.shape[:-3], x.shape[-3:-1]
        h = x.reshape(-1, t, n, 2).permute(0, 3, 1, 2)  # (N, 2, n_dsym, n_re)
        return x + _stack(self.convs, h).permute(0, 2, 3, 1).reshape(lead + (t, n, 2))


def _zero_last(convs: nn.ModuleList) -> None:
    """The output layer starts at zero: the residual is then the identity."""
    with torch.no_grad():
        convs[-1].weight.zero_()
        convs[-1].bias.zero_()


def _stack(convs: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    for i, conv in enumerate(convs):
        h = conv(h)
        if i < len(convs) - 1:
            h = torch.relu(h)
    return h


def halo_width(model: PilotDenoiser | None = None) -> int:
    """Receptive-field half-width of the 1-D stack: kernel_size // 2 a layer."""
    m = model or PilotDenoiser()
    return (m.kernel_size // 2) * (len(m.features) + 1)


def halo_width_2d(model: PilotDenoiser2D | None = None) -> int:
    """Frequency-axis receptive-field half-width of the 2-D stack."""
    m = model or PilotDenoiser2D()
    return (m.kernel_f // 2) * (len(m.features) + 1)


def params_from_flax(tree) -> dict:
    """The port's params (a state dict of PilotDenoiser or PilotDenoiser2D)
    from the flax params pytree, as nested dicts of arrays ({"params": {...}}
    or its inner dict). Layers are ordered by the integer suffix of `Conv_i`;
    kernels (k, cin, cout) become (cout, cin, k), (kt, kf, cin, cout) become
    (cout, cin, kt, kf)."""
    p = tree["params"] if "params" in tree else tree
    names = sorted(p, key=lambda s: int(s.rsplit("_", 1)[1]))
    out = {}
    for i, name in enumerate(names):
        k = np.asarray(p[name]["kernel"], np.float32)
        perm = (2, 1, 0) if k.ndim == 3 else (3, 2, 0, 1)
        out[f"convs.{i}.weight"] = torch.as_tensor(np.ascontiguousarray(k.transpose(perm)))
        out[f"convs.{i}.bias"] = torch.as_tensor(np.asarray(p[name]["bias"], np.float32))
    return out


def load_flax_npz(path) -> dict:
    """A flax params pytree ({"params": {"Conv_i": {"kernel", "bias"}}}) from an
    npz written with keys "Conv_i/kernel" and "Conv_i/bias"."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = z[key]
    return {"params": tree}


def load_shipped(kind: str = "1d", device="cuda") -> dict:
    """The shipped checkpoint's params ("1d": smoothing="learned", "2d":
    "learned2d") on `device` (the card by default; raises when there is none)."""
    from .. import devices

    if kind not in SHIPPED:
        raise ValueError(f"kind={kind!r}: one of {sorted(SHIPPED)}")
    dev = devices.resolve(device)
    params = params_from_flax(load_flax_npz(ARTIFACTS / SHIPPED[kind]))
    return {k: v.to(dev) for k, v in params.items()}


_MODULES: "collections.OrderedDict" = collections.OrderedDict()


def module_for(params, two_d: bool, device) -> nn.Module:
    """The denoiser holding `params` on `device`, built on first use and kept
    (the cache holds the params object, so its id stays its own)."""
    key = (id(params), two_d, torch.device(device))
    hit = _MODULES.get(key)
    if hit is not None and hit[0] is params:
        _MODULES.move_to_end(key)
        return hit[1]
    model = PilotDenoiser2D() if two_d else PilotDenoiser()
    model.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()})
    model = model.to(device).eval().requires_grad_(False)
    _MODULES[key] = (params, model)
    if len(_MODULES) > 16:
        _MODULES.popitem(last=False)
    return model


@contextlib.contextmanager
def _no_tf32_conv():
    """cuDNN convolutions in IEEE f32 (TF32 off), the caller's setting restored."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _apply(params, h: torch.Tensor, two_d: bool) -> torch.Tensor:
    model = module_for(params, two_d, h.device)
    x = torch.stack([h.real, h.imag], dim=-1).to(torch.float32)
    with _no_tf32_conv(), torch.no_grad():
        y = model(x).to(h.real.dtype)
    return torch.complex(y[..., 0], y[..., 1])


def apply_complex(params, h_p: torch.Tensor) -> torch.Tensor:
    """Denoise (..., n_re) complex pilot estimates; same shape and dtype."""
    return _apply(params, h_p, two_d=False)


def apply_complex_2d(params, h_t: torch.Tensor) -> torch.Tensor:
    """Denoise (..., n_dsym, n_re) complex per-symbol pilot estimates."""
    return _apply(params, h_t, two_d=True)
