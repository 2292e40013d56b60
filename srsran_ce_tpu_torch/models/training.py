"""Training of the pilot denoisers: `srsran_ce_tpu/models/training.py` in torch.

AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-5) under a cosine (to 0)
or constant learning-rate schedule, as the JAX package's optax `adamw`:
`torch.optim.AdamW` with a `LambdaLR`, each `optimizer.step()` followed by
`scheduler.step()`, so the first update takes the schedule's value at count
0 as optax does. The convolutions are cuDNN's (`F.conv1d` / `F.conv2d`
through the modules of `models/denoiser.py`) and autograd runs them
backwards; the JAX package computes them in XLA, not in a Pallas kernel, so
training has no kernel of its own. `torch.backends.cudnn.allow_tf32` is
pinned off around the forward and the backward of every step.

A `TrainState` holds the params (a state dict of the port's module), the
Adam state (`AdamState`: the count that drives the bias correction, the
moments in the params' layout, and the schedule's own count) and the step.
`state_from_optax` carries a JAX state across (its Adam count continues the
bias correction), `state_to_optax` carries it back. Checkpoints are one npz
(`save_checkpoint`): the params in the flax key layout that
`denoiser.load_flax_npz` reads ("Conv_i/kernel"), the moments under "mu/"
and "nu/", and the counts; `load_checkpoint*` also read a params-only npz
(the shipped `artifacts/denoiser{,2d}.npz`) and give it a fresh optimizer.

The data-parallel step (`build_train_step(mesh=)`) belongs to the parallel
paths, which the port does not carry yet (ROADMAP.md queue 1, item 10).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import devices
from . import denoiser

BETAS = (0.9, 0.999)
EPS = 1e-8


@dataclass
class AdamState:
    """optax's ScaleByAdamState in the port's params layout, plus the count of
    the learning-rate schedule (optax's ScaleByScheduleState)."""

    count: int
    mu: dict
    nu: dict
    schedule_count: int = 0


@dataclass
class TrainState:
    params: dict
    opt_state: AdamState
    step: int


@dataclass(frozen=True)
class Optimizer:
    """The optimizer of `make_optimizer`: AdamW's settings and the schedule."""

    lr: float = 1e-3
    weight_decay: float = 1e-5
    decay_steps: int = 0

    def lr_factor(self, count: int) -> float:
        """The schedule over `lr` at `count` (optax's cosine_decay_schedule
        with alpha=0, or a constant)."""
        if self.decay_steps <= 0:
            return 1.0
        c = min(count, self.decay_steps)
        return 0.5 * (1.0 + math.cos(math.pi * c / self.decay_steps))


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-5, decay_steps: int = 0) -> Optimizer:
    """adamw; with decay_steps > 0 the lr follows a cosine decay to 0, else it
    stays constant (a state restores across both, as in JAX)."""
    return Optimizer(float(lr), float(weight_decay), int(decay_steps))


def fresh_adam_state(params: dict) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


def _on(params: dict, device) -> dict:
    return {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}


def init_state(seed: int = 0, n_re: int = 128, lr: float = 1e-3, decay_steps: int = 0,
               device="cuda") -> Tuple[TrainState, Optimizer]:
    """Fresh 1-D params (flax's initialisers) and Adam state on `device` (the
    card by default; raises when there is none). `n_re` is kept for the JAX
    signature: the model is fully convolutional."""
    params = _on(denoiser.init_params(seed), devices.resolve(device))
    return TrainState(params, fresh_adam_state(params), 0), make_optimizer(lr, decay_steps=decay_steps)


def init_state_2d(seed: int = 0, n_re: int = 128, n_dsym: int = 4, lr: float = 1e-3,
                  decay_steps: int = 0, device="cuda") -> Tuple[TrainState, Optimizer]:
    """`init_state` for the 2-D denoiser."""
    params = _on(denoiser.init_params_2d(seed), devices.resolve(device))
    return TrainState(params, fresh_adam_state(params), 0), make_optimizer(lr, decay_steps=decay_steps)


class _Trainer:
    """A denoiser, its AdamW and its LambdaLR, on the params' device and dtype,
    starting from `params` and `opt_state` (copied in)."""

    def __init__(self, params: dict, opt_state: AdamState, tx: Optimizer, two_d: bool):
        p0 = next(iter(params.values()))
        self.model = denoiser.PilotDenoiser2D() if two_d else denoiser.PilotDenoiser()
        self.model.to(device=p0.device, dtype=p0.dtype)
        self.model.load_state_dict(params)
        named = dict(self.model.named_parameters())
        self.opt = torch.optim.AdamW(named.values(), lr=tx.lr, betas=BETAS, eps=EPS,
                                     weight_decay=tx.weight_decay)
        for name, p in named.items():
            self.opt.state[p] = {
                "step": torch.tensor(float(opt_state.count)),
                "exp_avg": opt_state.mu[name].to(p).clone(),
                "exp_avg_sq": opt_state.nu[name].to(p).clone(),
            }
        for group in self.opt.param_groups:
            group["initial_lr"] = tx.lr
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, tx.lr_factor, last_epoch=opt_state.schedule_count - 1)
        self.names = list(named)

    def step(self, noisy: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        with denoiser._no_tf32_conv():
            loss = denoiser.nmse_loss(self.model, noisy, truth)
            loss.backward()
        self.opt.step()
        self.sched.step()
        return loss.detach()

    def snapshot(self) -> Tuple[dict, AdamState]:
        """Fresh copies of the params and the Adam state."""
        params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        named = dict(self.model.named_parameters())
        st = [self.opt.state[named[n]] for n in self.names]
        return params, AdamState(
            int(st[0]["step"]), {n: s["exp_avg"].clone() for n, s in zip(self.names, st)},
            {n: s["exp_avg_sq"].clone() for n, s in zip(self.names, st)},
            self.sched.last_epoch)


class TrainStep:
    """`(params, opt_state, noisy, truth) -> (params, opt_state, loss)`, the
    signature of the JAX package's jitted step. The batch goes to the params'
    device and dtype. Called again with the state it returned last, it goes
    on with the same optimizer; any other state is loaded afresh."""

    def __init__(self, tx: Optimizer, two_d: bool):
        self.tx, self.two_d = tx, two_d
        self._live = None

    def __call__(self, params, opt_state, noisy, truth):
        live = self._live
        if live is not None and live[0] is params and live[1] is opt_state:
            trainer = live[2]
        else:
            trainer = _Trainer(params, opt_state, self.tx, self.two_d)
        p0 = next(iter(params.values()))
        as_t = lambda a: torch.as_tensor(a, device=p0.device, dtype=p0.dtype)
        loss = trainer.step(as_t(noisy), as_t(truth))
        params, opt_state = trainer.snapshot()
        self._live = (params, opt_state, trainer)
        return params, opt_state, loss


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "build_train_step(mesh=...): the data-parallel step belongs to the parallel "
            "paths, not ported yet (ROADMAP.md queue 1, item 10)")


def build_train_step(tx: Optimizer, mesh=None) -> TrainStep:
    """The 1-D denoiser's training step (no mesh: one device)."""
    _no_mesh(mesh)
    return TrainStep(tx, two_d=False)


def build_train_step_2d(tx: Optimizer, mesh=None) -> TrainStep:
    """The 2-D denoiser's training step (no mesh: one device)."""
    _no_mesh(mesh)
    return TrainStep(tx, two_d=True)


def _run(state: TrainState, tx: Optimizer, two_d: bool, n_steps: int, batch_of, log_every: int,
         tag) -> Tuple[TrainState, float]:
    """n_steps of the trainer over `batch_of(i)`; one log line every
    `log_every` steps and at the last. Returns fresh params."""
    trainer = _Trainer(state.params, state.opt_state, tx, two_d)
    p0 = next(iter(state.params.values()))
    loss = torch.tensor(float("nan"))
    as_t = lambda a: torch.as_tensor(a).to(device=p0.device, dtype=p0.dtype)
    for i in range(n_steps):
        noisy, truth = batch_of(i)
        loss = trainer.step(as_t(noisy), as_t(truth))
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            print(f"step {state.step + i:5d}  {tag(i)}nmse {float(loss):.4e}", flush=True)
    params, opt_state = trainer.snapshot()
    return TrainState(params, opt_state, state.step + n_steps), float(loss)


def train(
    n_steps: int = 200,
    batch: int = 256,
    n_re=128,
    seed: int = 0,
    lr: float = 1e-3,
    mesh=None,
    log_every: int = 50,
    state: Optional[TrainState] = None,
    device="cuda",
) -> Tuple[TrainState, float]:
    """Train the 1-D denoiser on streamed synthetic batches on `device` (the
    card by default; a given `state` trains on its own params' device);
    returns (state, last_loss).

    `n_re` may be one pilot-lattice length or a tuple of them: the model is
    fully convolutional, so the steps cycle over the lengths (step i takes
    n_re[i % len]) with the batch scaled to max(8, batch * min(n_re) //
    n_re[i]), and one checkpoint covers every serving geometry. A resumed
    `state` trains at a constant lr (the cosine phase is spent)."""
    _no_mesh(mesh)
    rng = np.random.default_rng(seed)
    res = (n_re,) if isinstance(n_re, int) else tuple(n_re)
    if state is None:
        state, tx = init_state(seed, res[0], lr, decay_steps=n_steps, device=device)
    else:
        tx = make_optimizer(lr)  # resume: constant lr (the cosine phase is spent)

    def batch_of(i):
        nr_i = res[i % len(res)]
        return denoiser.make_training_batch(rng, max(8, (batch * min(res)) // nr_i), nr_i)

    return _run(state, tx, False, n_steps, batch_of, log_every,
                lambda i: f"n_re {res[i % len(res)]:4d}  ")


def train2d(
    n_steps: int = 200,
    batch: int = 128,
    n_re: int = 128,
    n_dsym: int = 4,
    seed: int = 0,
    lr: float = 1e-3,
    mesh=None,
    log_every: int = 50,
    state: Optional[TrainState] = None,
    device="cuda",
) -> Tuple[TrainState, float]:
    """Train the 2-D (time x frequency) denoiser on synthetic Doppler batches
    on `device`; as `train`."""
    _no_mesh(mesh)
    rng = np.random.default_rng(seed)
    if state is None:
        state, tx = init_state_2d(seed, n_re, n_dsym, lr, decay_steps=n_steps, device=device)
    else:
        tx = make_optimizer(lr)  # resume: constant lr (the cosine phase is spent)
    return _run(state, tx, True, n_steps,
                lambda i: denoiser.make_training_batch_2d(rng, batch, n_re, n_dsym=n_dsym),
                log_every, lambda i: "")


# ---------------------------------------------------------------------------
# The JAX package's state, carried across
# ---------------------------------------------------------------------------


def _adam_of(opt_state):
    """The ScaleByAdamState (count, mu, nu) inside an optax adamw state."""
    for s in opt_state:
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
    raise ValueError("no ScaleByAdamState (count, mu, nu) in this optax state")


def state_from_optax(params, opt_state, step: int, device="cuda") -> TrainState:
    """A TrainState from the JAX package's (flax params, optax adamw state,
    step), arrays in any numpy-convertible form, on `device`: mu and nu become
    the optimizer's exp_avg / exp_avg_sq (kernels transposed as
    `denoiser.params_from_flax` transposes them) and the Adam count each
    parameter's step, so the bias correction goes on from it. The dtype of
    the arrays is kept."""
    dev = devices.resolve(device)
    conv = lambda tree: {k: v.to(dev) for k, v in denoiser.params_from_flax(tree, None).items()}
    adam = _adam_of(opt_state)
    return TrainState(conv(params), AdamState(int(np.asarray(adam.count)), conv(adam.mu),
                                              conv(adam.nu)), int(step))


def state_to_optax(state: TrainState, like):
    """(flax params, optax adamw state, step) of a TrainState: the inverse of
    `state_from_optax`. `like` is an optax adamw state of the same model
    (`tx.init(params)` in JAX); its ScaleByAdamState gets this state's count,
    mu and nu (numpy), every other entry is kept."""
    adam = _adam_of(like)
    to = denoiser.params_to_flax
    new = adam._replace(count=np.asarray(state.opt_state.count, np.asarray(adam.count).dtype),
                        mu=to(state.opt_state.mu), nu=to(state.opt_state.nu))
    return to(state.params), type(like)(new if s is adam else s for s in like), state.step


# ---------------------------------------------------------------------------
# Checkpoints (one npz, no orbax)
# ---------------------------------------------------------------------------


def save_checkpoint(path, state: TrainState) -> None:
    """Write `state` as an npz at exactly `path` (flax key layout; see the
    module doc)."""
    flax = denoiser.params_to_flax
    with open(path, "wb") as f:
        np.savez(
            f,
            **denoiser.flax_npz_entries(flax(state.params)),
            **denoiser.flax_npz_entries(flax(state.opt_state.mu), "mu/"),
            **denoiser.flax_npz_entries(flax(state.opt_state.nu), "nu/"),
            count=np.int64(state.opt_state.count),
            schedule_count=np.int64(state.opt_state.schedule_count),
            step=np.int64(state.step),
        )


def _load(path, two_d: bool, device) -> TrainState:
    dev = devices.resolve(device)
    load = lambda prefix: {k: v.to(dev) for k, v in denoiser.params_from_flax(
        denoiser.load_flax_npz(path, prefix), None).items()}
    params = load("")
    if (params["convs.0.weight"].dim() == 4) != two_d:
        raise ValueError(f"{path}: a {'2-D' if not two_d else '1-D'} denoiser checkpoint")
    with np.load(path) as z:
        if "count" not in z.files:  # params only (the shipped npz): a fresh optimizer
            return TrainState(params, fresh_adam_state(params), 0)
        counts = int(z["count"]), int(z["schedule_count"]), int(z["step"])
    return TrainState(params, AdamState(counts[0], load("mu/"), load("nu/"), counts[1]), counts[2])


def load_checkpoint(path, device="cuda") -> TrainState:
    """The 1-D TrainState saved at `path`, on `device` (the card by default)."""
    return _load(path, False, device)


def load_checkpoint_2d(path, device="cuda") -> TrainState:
    """The 2-D TrainState saved at `path`, on `device` (the card by default)."""
    return _load(path, True, device)
