"""The trainable pilot-estimate denoisers of the port: `srsran_ce_tpu/models/denoiser.py`
in torch. Serving runs them through `apply_complex*`; training
(`models/training.py`) uses `init_params*`, the synthetic batches
`make_training_batch*` (numpy copies of the JAX functions: one generator
state gives identical batches in both packages) and `nmse_loss*`.

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

`init_params` / `init_params_2d` draw flax's initialisers: lecun-normal
kernels (a normal truncated at two standard deviations, variance 1/fan_in
after flax's 0.8796 correction), zero biases and a zero last layer. Flax's
draws themselves cannot be matched (another generator), only their law.
"""
from __future__ import annotations

import collections
import contextlib
from pathlib import Path
from typing import Sequence, Tuple

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


def params_from_flax(tree, dtype=np.float32) -> dict:
    """The port's params (a state dict of PilotDenoiser or PilotDenoiser2D)
    from the flax params pytree, as nested dicts of arrays ({"params": {...}}
    or its inner dict), cast to `dtype` (None keeps the arrays' own). Layers
    are ordered by the integer suffix of `Conv_i`; kernels (k, cin, cout)
    become (cout, cin, k), (kt, kf, cin, cout) become (cout, cin, kt, kf)."""
    p = tree["params"] if "params" in tree else tree
    names = sorted(p, key=lambda s: int(s.rsplit("_", 1)[1]))
    out = {}
    for i, name in enumerate(names):
        k = np.asarray(p[name]["kernel"], dtype)
        perm = (2, 1, 0) if k.ndim == 3 else (3, 2, 0, 1)
        out[f"convs.{i}.weight"] = torch.as_tensor(np.ascontiguousarray(k.transpose(perm)))
        out[f"convs.{i}.bias"] = torch.as_tensor(np.array(p[name]["bias"], dtype))
    return out


def params_to_flax(params) -> dict:
    """The flax params pytree ({"params": {"Conv_i": {"kernel", "bias"}}},
    numpy arrays in the params' dtype) of a port state dict: the inverse of
    `params_from_flax`."""
    tree = {}
    n = len(params) // 2
    for i in range(n):
        w = params[f"convs.{i}.weight"]
        w = (w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w))
        perm = (2, 1, 0) if w.ndim == 3 else (2, 3, 1, 0)
        b = params[f"convs.{i}.bias"]
        tree[f"Conv_{i}"] = {
            "kernel": np.ascontiguousarray(w.transpose(perm)),
            "bias": b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b),
        }
    return {"params": tree}


def flax_npz_entries(tree, prefix: str = "") -> dict:
    """npz entries ("<prefix>Conv_i/kernel", "<prefix>Conv_i/bias") of a flax
    params pytree, the layout `load_flax_npz` reads."""
    p = tree["params"] if "params" in tree else tree
    return {f"{prefix}{layer}/{leaf}": v for layer, d in p.items() for leaf, v in d.items()}


def load_flax_npz(path, prefix: str = "") -> dict:
    """A flax params pytree ({"params": {"Conv_i": {"kernel", "bias"}}}) from an
    npz written with keys "<prefix>Conv_i/kernel" and "<prefix>Conv_i/bias";
    other keys (a training checkpoint's optimizer state) are not read."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if not key.startswith(prefix) or key[len(prefix):].count("/") != 1:
                continue
            layer, leaf = key[len(prefix):].split("/")
            tree.setdefault(layer, {})[leaf] = z[key]
    if not tree:
        raise ValueError(f"{path}: no '{prefix}Conv_i/kernel' entries")
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


# ---------------------------------------------------------------------------
# Training: initial params, synthetic batches, the loss
# ---------------------------------------------------------------------------

#: flax's truncated-normal correction: the stddev of a unit normal truncated
#: at +-2 (jax.nn.initializers.variance_scaling, "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def _init(model: nn.Module, seed: int) -> dict:
    """`model`'s state dict drawn as flax draws it: lecun-normal kernels, zero
    biases, a zero last layer; float32 tensors on the CPU."""
    gen = torch.Generator().manual_seed(int(seed))
    out = {}
    for i, conv in enumerate(model.convs):
        w = torch.zeros_like(conv.weight)
        if i < len(model.convs) - 1:
            fan_in = w[0].numel()  # c_in x kernel positions
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
            w.mul_(std)
        out[f"convs.{i}.weight"] = w
        out[f"convs.{i}.bias"] = torch.zeros_like(conv.bias)
    return out


def init_params(seed: int = 0) -> dict:
    """Fresh params of the 1-D denoiser (a state dict, float32, CPU)."""
    return _init(PilotDenoiser(), seed)


def init_params_2d(seed: int = 0) -> dict:
    """Fresh params of the 2-D denoiser (a state dict, float32, CPU)."""
    return _init(PilotDenoiser2D(), seed)


def make_training_batch(
    rng: np.random.Generator,
    batch: int,
    n_re: int,
    snr_db_range: Tuple[float, float] = (0.0, 30.0),
    n_taps: int = 6,
    max_delay_frac: float = 0.02,
):
    """(noisy_ls, truth): (B, n_re, 2) float32 pairs.

    Physics matches utils/synthetic._tdl_frequency_response: multipath frequency
    responses sampled at comb-spaced pilot positions, pilot-despread LS estimates
    corrupted by AWGN at a per-sample random SNR.
    """
    nfft = 2048.0
    delays = rng.uniform(0.0, max_delay_frac * nfft, size=(batch, n_taps))
    delays[:, 0] = 0.0
    power = np.exp(-delays / (max_delay_frac * nfft / 3.0 + 1e-9))
    power /= power.sum(axis=1, keepdims=True)
    gains = (rng.standard_normal((batch, n_taps)) + 1j * rng.standard_normal((batch, n_taps)))
    gains *= np.sqrt(power / 2.0)
    k = np.arange(n_re, dtype=np.float64) * 2.0  # comb-2 pilot spacing
    phase = np.exp(-2j * np.pi * k[None, :, None] * delays[:, None, :] / nfft)
    truth = np.einsum("brt,bt->br", phase, gains)

    snr_db = rng.uniform(*snr_db_range, size=(batch, 1))
    noise_std = 10.0 ** (-snr_db / 20.0)
    noisy = truth + noise_std * (
        rng.standard_normal((batch, n_re)) + 1j * rng.standard_normal((batch, n_re))
    ) / np.sqrt(2.0)

    to_ri = lambda z: np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return to_ri(noisy), to_ri(truth)


def make_training_batch_2d(
    rng: np.random.Generator,
    batch: int,
    n_re: int,
    n_dsym: int = 4,
    snr_db_range: Tuple[float, float] = (0.0, 30.0),
    doppler_hz_max: float = 600.0,
    scs_hz: float = 30e3,
    n_taps: int = 6,
    max_delay_frac: float = 0.02,
):
    """(noisy_ls, truth): (B, n_dsym, n_re, 2) float32 pairs.

    Same multipath physics as make_training_batch plus per-tap Doppler rotation
    across DM-RS symbol times (utils/synthetic.make_case doppler_hz path): each
    sample draws a Doppler spread in [0, doppler_hz_max], so the model learns both
    frequency smoothing and time tracking.
    """
    nfft = 2048.0
    delays = rng.uniform(0.0, max_delay_frac * nfft, size=(batch, n_taps))
    delays[:, 0] = 0.0
    power = np.exp(-delays / (max_delay_frac * nfft / 3.0 + 1e-9))
    power /= power.sum(axis=1, keepdims=True)
    gains = (rng.standard_normal((batch, n_taps)) + 1j * rng.standard_normal((batch, n_taps)))
    gains *= np.sqrt(power / 2.0)
    k = np.arange(n_re, dtype=np.float64) * 2.0  # comb-2 pilot spacing
    phase_f = np.exp(-2j * np.pi * k[None, :, None] * delays[:, None, :] / nfft)  # (B, n_re, T)

    # DM-RS symbols spread across a 14-symbol slot; times in seconds (~1/scs units)
    sym_idx = np.unique(np.linspace(0, 13, n_dsym).round().astype(int))
    t_sym = (sym_idx * (1.0 + 144.0 / 2048.0)) / scs_hz  # (n_dsym,)
    dop = rng.uniform(0.0, doppler_hz_max, size=(batch, 1))
    f_d = rng.uniform(-1.0, 1.0, size=(batch, n_taps)) * dop  # (B, T)
    phase_t = np.exp(2j * np.pi * t_sym[None, :, None] * f_d[:, None, :])  # (B, n_dsym, T)

    truth = np.einsum("brt,bst,bt->bsr", phase_f, phase_t, gains)  # (B, n_dsym, n_re)

    snr_db = rng.uniform(*snr_db_range, size=(batch, 1, 1))
    noise_std = 10.0 ** (-snr_db / 20.0)
    noisy = truth + noise_std * (
        rng.standard_normal(truth.shape) + 1j * rng.standard_normal(truth.shape)
    ) / np.sqrt(2.0)

    to_ri = lambda z: np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    return to_ri(noisy), to_ri(truth)


def nmse_loss(model: nn.Module, noisy_ri: torch.Tensor, truth_ri: torch.Tensor) -> torch.Tensor:
    """sum (model(noisy) - truth)^2 / (sum truth^2 + 1e-12), a 0-d tensor; the
    1-D and the 2-D denoiser alike (`nmse_loss_2d` is the same function)."""
    err = torch.sum((model(noisy_ri) - truth_ri) ** 2)
    return err / (torch.sum(truth_ri ** 2) + 1e-12)


nmse_loss_2d = nmse_loss
