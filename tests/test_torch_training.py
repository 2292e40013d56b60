"""The port's denoiser training against the JAX package's, on the CPU.

- `make_training_batch` / `make_training_batch_2d`: one generator state gives
  batches `np.array_equal` to the JAX functions';
- `init_params*`: flax's shapes, zero biases and last layer, every other
  kernel's variance within 10 % of 1/fan_in (flax's draws themselves cannot
  be matched: another generator);
- the learning rate each update takes equals optax's `cosine_decay_schedule`
  (relative 1e-15) at every step, and the constant schedule;
- training steps from the same params, the same batches, 1-D and 2-D, after 1
  and after 5 steps, in float64 on both sides (the flax tree and the batch
  cast to float64, x64 on): losses and params within relative 1e-9
  (max-abs error over max-abs value; measured ~1e-15). Adam's first update
  is about lr * sign(g), so in float32 a gradient element near zero can
  change sign between two summation orders and move its parameter by 2 lr:
  the float32 run is held on the loss only, within relative 1e-4
  (measured <= 1.1e-6);
- a resume from the JAX orbax checkpoint `srsran_ce_tpu/artifacts/denoiser_ckpt`
  carried across by `state_from_optax` (its Adam count continues the bias
  correction), 3 steps at constant lr against the JAX step, float64,
  relative 1e-9; `state_to_optax` carries the state back array for array;
- the multi-geometry cycle's batch sizes and lengths equal to JAX `train`'s;
- checkpoints: save/load round trips, a params-only npz (the shipped one)
  loads with a fresh optimizer, a 2-D file refused as 1-D;
- `cli train --device cpu` for 3 steps, then `--resume`; the params `train`
  returns are fresh (the serving cache `denoiser.module_for` sees them).
"""
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from srsran_ce_tpu.models import denoiser as jdn
from srsran_ce_tpu.models import training as jtr
from srsran_ce_tpu_torch.models import denoiser as dn
from srsran_ce_tpu_torch.models import training as tr
from srsran_ce_tpu_torch.validation import cli

REPO = Path(__file__).resolve().parents[1]

KINDS = ["1d", "2d"]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def params_rel(port_params, flax_tree):
    """Worst relative error over the layers of the port's params against a flax tree."""
    want = dn.params_from_flax(jax.tree_util.tree_map(np.asarray, flax_tree), None)
    return max(rel(port_params[k].cpu().numpy(), want[k].numpy()) for k in want
               if float(want[k].abs().max()) > 0)


def batch(kind, rng, b, n_re, dtype=np.float64):
    make = jdn.make_training_batch_2d if kind == "2d" else jdn.make_training_batch
    noisy, truth = make(rng, b, n_re)
    return noisy.astype(dtype), truth.astype(dtype)


def jax_init(kind, n_re=40):
    key = jax.random.PRNGKey(3)
    return jdn.init_params_2d(key, 4, n_re) if kind == "2d" else jdn.init_params(key, n_re)


def step_fns(kind, tx_j, tx_t):
    if kind == "2d":
        return jtr.build_train_step_2d(tx_j), tr.build_train_step_2d(tx_t)
    return jtr.build_train_step(tx_j), tr.build_train_step(tx_t)


@pytest.mark.parametrize("kind", KINDS)
def test_training_batches_equal_jax(kind):
    for seed, b, n_re in ((0, 5, 24), (7, 3, 61)):
        jmake = jdn.make_training_batch_2d if kind == "2d" else jdn.make_training_batch
        tmake = dn.make_training_batch_2d if kind == "2d" else dn.make_training_batch
        want = jmake(np.random.default_rng(seed), b, n_re)
        got = tmake(np.random.default_rng(seed), b, n_re)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
def test_init_params_draw_flax_law(kind):
    got = dn.init_params_2d(5) if kind == "2d" else dn.init_params(5)
    tree = dn.params_to_flax(got)["params"]
    want = jax_init(kind)["params"]
    assert set(tree) == set(want)
    for layer in want:
        for leaf in ("kernel", "bias"):
            assert tree[layer][leaf].shape == want[layer][leaf].shape
            assert tree[layer][leaf].dtype == np.float32
        assert not tree[layer]["bias"].any()
    assert not tree["Conv_2"]["kernel"].any()  # zero last layer: the identity
    for layer in ("Conv_0", "Conv_1"):
        k = tree[layer]["kernel"]
        fan_in = k.size // k.shape[-1]
        assert abs(k.var() * fan_in - 1.0) < 0.1, (layer, k.var() * fan_in)
        assert np.abs(k).max() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-7
    again = dn.init_params_2d(5) if kind == "2d" else dn.init_params(5)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_lr_schedule_equals_optax():
    for decay in (0, 7):
        tx = tr.make_optimizer(2e-3, decay_steps=decay)
        sched = (optax.cosine_decay_schedule(2e-3, decay) if decay else optax.constant_schedule(2e-3))
        state, _ = tr.init_state(0, device="cpu")
        trainer = tr._Trainer(state.params, state.opt_state, tx, two_d=False)
        rng = np.random.default_rng(1)
        for i in range(10):
            want = float(sched(i))
            got = trainer.opt.param_groups[0]["lr"]  # the lr of update i
            assert abs(got - want) <= 1e-15 * 2e-3, (decay, i, got, want)
            trainer.step(*(torch.as_tensor(a) for a in dn.make_training_batch(rng, 2, 8)))


@pytest.mark.parametrize("n_steps", [1, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_match_jax_float64(kind, n_steps):
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + 0.05 * rng.standard_normal(a.shape), jax_init(kind))
    tx_j = jtr.make_optimizer(1e-3, decay_steps=5)
    step_j, step_t = step_fns(kind, tx_j, tr.make_optimizer(1e-3, decay_steps=5))
    pj, oj = tree, tx_j.init(tree)
    st = tr.state_from_optax(tree, oj, 0, device="cpu")
    pt, ot = st.params, st.opt_state
    assert pt["convs.0.weight"].dtype == torch.float64
    brng = np.random.default_rng(9)
    for i in range(n_steps):
        noisy, truth = batch(kind, brng, 6, 40)
        pj, oj, lj = step_j(pj, oj, noisy, truth)
        pt, ot, lt = step_t(pt, ot, noisy, truth)
        assert rel(float(lt), float(lj)) <= 1e-9, (i, float(lt), float(lj))
    assert params_rel(pt, pj) <= 1e-9
    assert ot.count == n_steps == ot.schedule_count
    want_mu = dn.params_from_flax(jax.tree_util.tree_map(np.asarray, oj[0].mu), None)
    assert max(rel(ot.mu[k].numpy(), want_mu[k].numpy()) for k in want_mu) <= 1e-9


@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_float32_loss(kind):
    tree = jax_init(kind)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.float32(0.05) * np.random.default_rng(2).standard_normal(
            a.shape).astype(np.float32), tree)
    tx_j = jtr.make_optimizer(1e-3, decay_steps=5)
    step_j, step_t = step_fns(kind, tx_j, tr.make_optimizer(1e-3, decay_steps=5))
    pj, oj = tree, tx_j.init(tree)
    st = tr.state_from_optax(tree, oj, 0, device="cpu")
    pt, ot = st.params, st.opt_state
    assert pt["convs.0.weight"].dtype == torch.float32
    brng = np.random.default_rng(9)
    for i in range(5):
        noisy, truth = batch(kind, brng, 6, 40, np.float32)
        pj, oj, lj = step_j(pj, oj, noisy, truth)
        pt, ot, lt = step_t(pt, ot, noisy, truth)
        assert rel(float(lt), float(lj)) <= 1e-4, (i, float(lt), float(lj))


def test_resume_from_jax_orbax_checkpoint():
    js = jtr.load_checkpoint(str(REPO / "srsran_ce_tpu" / "artifacts" / "denoiser_ckpt"))
    f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
    pj = f64(js.params)
    oj = js.opt_state[0]._replace(count=js.opt_state[0].count, mu=f64(js.opt_state[0].mu),
                                  nu=f64(js.opt_state[0].nu))
    oj = (oj,) + tuple(js.opt_state[1:])
    st = tr.state_from_optax(pj, oj, js.step, device="cpu")
    assert st.step == js.step and st.opt_state.count == int(js.opt_state[0].count) > 0
    # back across: the same arrays
    p_back, o_back, s_back = tr.state_to_optax(st, oj)
    assert s_back == js.step and int(o_back[0].count) == int(oj[0].count)
    for a, b in zip(jax.tree_util.tree_leaves((p_back, o_back[0].mu, o_back[0].nu)),
                    jax.tree_util.tree_leaves((pj, oj[0].mu, oj[0].nu))):
        assert np.array_equal(a, np.asarray(b))
    # resume at constant lr (JAX train's resume), 3 steps
    tx_j = jtr.make_optimizer(1e-3)
    step_j, step_t = step_fns("1d", tx_j, tr.make_optimizer(1e-3))
    pt, ot = st.params, st.opt_state
    brng = np.random.default_rng(21)
    for i in range(3):
        noisy, truth = batch("1d", brng, 8, 48)
        pj, oj, lj = step_j(pj, oj, noisy, truth)
        pt, ot, lt = step_t(pt, ot, noisy, truth)
        assert rel(float(lt), float(lj)) <= 1e-9
    assert params_rel(pt, pj) <= 1e-9
    assert ot.count == int(oj[0].count) == int(js.opt_state[0].count) + 3


def test_multi_geometry_cycle_batch_sizes(monkeypatch):
    seen = {"jax": [], "port": []}

    def spy(mod, key):
        real = mod.make_training_batch

        def make(rng, b, n_re, **kw):
            seen[key].append((b, n_re))
            return real(rng, b, n_re, **kw)
        monkeypatch.setattr(mod, "make_training_batch", make)

    spy(jdn, "jax")
    spy(dn, "port")
    res = (24, 64, 200)
    _, lj = jtr.train(n_steps=4, batch=40, n_re=res, seed=2, log_every=0)
    st, lt = tr.train(n_steps=4, batch=40, n_re=res, seed=2, log_every=0, device="cpu")
    assert seen["jax"] == seen["port"] == [(40, 24), (15, 64), (8, 200), (40, 24)]
    assert st.step == 4 and np.isfinite(lt)


def test_checkpoint_round_trips(tmp_path):
    state, _ = tr.init_state_2d(1, device="cpu")
    state, _ = tr.train2d(n_steps=2, batch=4, n_re=16, state=state, log_every=0, device="cpu")
    path = tmp_path / "ck.npz"
    tr.save_checkpoint(path, state)
    back = tr.load_checkpoint_2d(path, device="cpu")
    assert back.step == state.step == 2 and back.opt_state.count == 2
    for got, want in ((back.params, state.params), (back.opt_state.mu, state.opt_state.mu),
                      (back.opt_state.nu, state.opt_state.nu)):
        assert all(torch.equal(got[k], want[k]) for k in want)
    # the params load as the shipped npz load (flax layout)
    flax = dn.load_flax_npz(path)
    assert all(torch.equal(v, state.params[k]) for k, v in dn.params_from_flax(flax).items())
    with pytest.raises(ValueError, match="2-D denoiser checkpoint"):
        tr.load_checkpoint(path, device="cpu")
    # a params-only npz (the shipped one): a fresh optimizer
    shipped = tr.load_checkpoint(dn.ARTIFACTS / dn.SHIPPED["1d"], device="cpu")
    want = dn.load_shipped("1d", device="cpu")
    assert shipped.step == 0 and shipped.opt_state.count == 0
    assert all(torch.equal(shipped.params[k], want[k]) for k in want)
    assert not any(v.any() for v in shipped.opt_state.mu.values())


def test_cli_train_then_resume(tmp_path, capsys):
    ck, ck2 = tmp_path / "a.npz", tmp_path / "b.npz"
    args = ["train", "--steps", "3", "--batch", "8", "--n-re", "24", "--device", "cpu"]
    assert cli.main(args + ["--checkpoint", str(ck)]) == 0
    assert cli.main(args + ["--resume", str(ck), "--checkpoint", str(ck2)]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "after 6 total steps" in out
    st = tr.load_checkpoint(ck2, device="cpu")
    assert st.step == 6 and st.opt_state.count == 6
    assert cli.main(["train", "--model", "2d", "--steps", "1", "--batch", "2", "--n-re", "16",
                     "--device", "cpu"]) == 0


def test_train_returns_fresh_params():
    """`denoiser.module_for` keys on the params' id: the params `train`
    returns after more steps must be a new dict, so serving sees them."""
    s1, _ = tr.train(n_steps=2, batch=8, n_re=24, log_every=0, device="cpu")
    x = torch.randn(2, 24, dtype=torch.complex64)
    y1 = dn.apply_complex(s1.params, x)
    s2, _ = tr.train(n_steps=2, batch=8, n_re=24, log_every=0, state=s1, device="cpu")
    assert s2.params is not s1.params
    assert not torch.equal(dn.apply_complex(s2.params, x), y1)
    assert torch.equal(dn.apply_complex(s1.params, x), y1)


def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tr.init_state(), lambda: tr.train(n_steps=1),
                 lambda: tr.train2d(n_steps=1), lambda: tr.load_checkpoint(tmp_path / "x.npz")):
        with pytest.raises(RuntimeError, match=r"device=cuda: no CUDA device here"):
            call()
    with pytest.raises(RuntimeError, match=r"--device cuda: no CUDA device here"):
        cli.main(["train", "--steps", "1"])
