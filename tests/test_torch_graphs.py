"""What makes a builder call capturable into one CUDA graph, held on the CPU.

On the card every builder call replays one CUDA graph (`srsran_ce_tpu_torch/
graphs.py`); a graph cannot hold a host synchronisation or a tensor made from
host data inside the call. Here, with no card, each builder's call runs once
(the warm-up builds the plan's tensors), then again under
`graphs.CaptureCheck` (a TorchDispatchMode that marks every tensor alive
before the call as device memory) and with `torch.as_tensor`, `torch.tensor`
and `torch.from_numpy` watched: the call must make no tensor from numpy or a
Python list and synchronise nothing. Every tier and layout of the estimator,
the learned path, the tracked estimator, the receivers and the device decode
chunk are covered; the capture itself, the replay's bit-identity and the
staging buffers are the card's (tests/test_torch_gpu.py). Also
`cli diagnose --device cpu`, and the graphed entry points on the CPU, which
run eagerly and return the same results.
"""
import dataclasses

import numpy as np
import pytest
import torch

from srsran_ce_tpu_torch import graphs, serving, transport
from srsran_ce_tpu_torch.models import denoiser, estimator, receiver, tracking
from srsran_ce_tpu_torch.ops import ldpc
from srsran_ce_tpu_torch.utils import synthetic
from srsran_ce_tpu_torch.validation import cli

B = 3


def batch_of(case, dtype=torch.float32):
    t = lambda a: torch.as_tensor(np.stack([a] * B), dtype=dtype)
    return (t(estimator.split_ri(case.received_rg)), t(estimator.split_ri(case.pilots)),
            torch.full((B,), float(case.beta), dtype=dtype))


def assert_capturable(fn, *args, monkeypatch):
    """`fn(*args)` after a warm-up: no capture hazard, no tensor from host data."""
    want = fn(*args)
    made = []
    for name in ("as_tensor", "tensor", "from_numpy"):
        orig = getattr(torch, name)

        def watch(data, *a, _orig=orig, _name=name, **k):
            if not torch.is_tensor(data):
                made.append(f"torch.{_name}({type(data).__name__})")
            return _orig(data, *a, **k)

        monkeypatch.setattr(torch, name, watch)
    with graphs.CaptureCheck() as chk:
        got = fn(*args)
    monkeypatch.undo()
    assert not chk.hazards, chk.hazards
    assert not made, made
    assert sum(chk.ops.values()) > 50
    return want, got


CASES = {
    "c2_like": dict(n_prbs=8, n_layers=4),
    "two_hops": dict(n_prbs=6, n_layers=1, two_hops=True),
    "cnn": dict(n_prbs=6, n_layers=2, interp="cnn"),
    "wiener_wls": dict(n_prbs=6, n_layers=2, smoothing="wiener", cfo_estimator="wls"),
    "time_interp": dict(n_prbs=6, n_layers=3, time_interp="linear"),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("kernels", ["xla", "pallas", "pallas_front"])
def test_estimator_call_is_capturable(name, kernels, monkeypatch):
    case = synthetic.make_case(seed=4, snr_db=30.0, **CASES[name])
    cfg = dataclasses.replace(case.config, matmul_precision="high")
    nL = case.pilots.shape[2]
    n = 0
    for layout in ("ref", "serve", "factored"):
        try:
            fn = estimator.build_ri(case.hop1, case.hop2, cfg, nL, batched=True, kernels=kernels,
                                    out_layout=layout)
        except ValueError:  # a layout or a tier the plan does not take
            continue
        want, got = assert_capturable(fn, *batch_of(case), monkeypatch=monkeypatch)
        assert torch.equal(got.noise_est, want.noise_est)
        n += 1
    assert n or kernels == "pallas_front"


def test_per_problem_and_learned_calls_are_capturable(monkeypatch):
    case = synthetic.make_case(seed=8, n_prbs=6, n_layers=2, smoothing="learned")
    params = denoiser.load_shipped("1d", device="cpu")
    for kernels in ("xla", "pallas"):
        fn = estimator.build_ri(case.hop1, case.hop2, case.config, 2, batched=True,
                                kernels=kernels, out_layout="serve")
        assert_capturable(fn, *batch_of(case), params, monkeypatch=monkeypatch)
    case = synthetic.make_case(seed=8, n_prbs=6, n_layers=2)
    fn = estimator.build_ri(case.hop1, case.hop2, case.config, 2)
    assert_capturable(fn, *(a[0] for a in batch_of(case, torch.float64)), monkeypatch=monkeypatch)


def test_tracked_and_receiver_calls_are_capturable(monkeypatch):
    case = synthetic.make_case(seed=5, n_prbs=6, n_layers=2)
    fn = tracking.build_tracked_ri(case.hop1, case.hop2, case.config, 2, batched=True,
                                   out_layout="serve", device="cpu")
    h, w = tracking.init_state(case.hop1, case.hop2, case.config, 2, batch=B, device="cpu")
    assert_capturable(fn, *batch_of(case), h, w, monkeypatch=monkeypatch)
    m = synthetic.make_mimo_case(seed=3, n_rx=2, modulation="qpsk", n_prbs=6, snr_db=30.0,
                                 n_layers=2)
    args = batch_of(m)
    for mode, kernels in (("auto", "xla"), ("auto", "pallas"), ("dense", "pallas")):
        fn = receiver.build_receiver_ri(m.hop1, m.hop2, m.config, 2, 2, batched=True, mode=mode,
                                        kernels=kernels, modulation="qpsk", device="cpu")
        assert_capturable(fn, *args, monkeypatch=monkeypatch)
    fn = receiver.build_tracked_receiver_ri(m.hop1, m.hop2, m.config, 2, 2, batched=True,
                                            device="cpu")
    h, w = tracking.init_state(m.hop1, m.hop2, m.config, 2, batch=2, device="cpu")
    h = tuple(x.expand((B,) + x.shape).contiguous() for x in h)
    assert_capturable(fn, *args, h, w.expand(B, 2).contiguous(), monkeypatch=monkeypatch)


@pytest.mark.parametrize("kernels,schedule", [("xla", "flooding"), ("pallas", "layered")])
def test_device_decode_chunk_is_capturable(kernels, schedule, monkeypatch):
    code = ldpc.array_code(3, 8, 13)
    coding = transport.TransportCoding(code=code, n_iters=4, early_iters=None, kernels=kernels,
                                       schedule=schedule, crc="crc16")
    m = synthetic.make_mimo_case(seed=3, n_rx=1, modulation="qpsk", scramble=False, n_prbs=4,
                                 snr_db=30.0)
    fn = receiver.build_receiver_ri(m.hop1, m.hop2, m.config, 1, 1, batched=True,
                                    modulation="qpsk", device="cpu")
    n_sc, n_sym = m.received_rg.shape[-2:]
    run = serving._device_decode_builder(coding, m.hop1, m.hop2, int(n_sc), int(n_sym), 1, 2,
                                         torch.device("cpu"))
    step = serving._device_decode_chunk(fn, run)
    assert isinstance(step, graphs.Graphed)
    want, got = assert_capturable(step, *batch_of(m), None, monkeypatch=monkeypatch)
    assert torch.equal(got[0], want[0]) and got[0].dtype == torch.uint8


def test_capture_check_flags_what_a_graph_cannot_hold():
    x = torch.arange(6.0)
    with graphs.CaptureCheck() as chk:
        x[[0, 2]]  # a Python list index: a host tensor
        float(x.sum())  # .item()
        x[x > 2]  # a boolean mask
        x * torch.tensor([1.0] * 6)  # host data
        x.numpy()
        (x + 1).tolist()
        x.repeat_interleave(2)  # an int repeat: no hazard
    kinds = "\n".join(chk.hazards)
    assert len(chk.hazards) == 6, kinds
    for what in ("aten.index.Tensor: host tensor (2,)", "aten._local_scalar_dense",
                 "boolean-mask", "aten.mul.Tensor: host tensor (6,)", "Tensor.numpy",
                 "Tensor.tolist"):
        assert what in kinds, what
    assert "test_torch_graphs" not in kinds and chk.ops["aten.add.Tensor"] == 1


def test_graphed_runs_eagerly_on_the_cpu():
    calls = []

    def fwd(a, b, obj):
        calls.append(obj)
        return (a + b, {"k": obj}["k"])

    g = graphs.Graphed(fwd, "test")
    a = torch.ones(3)
    out = g(a, a, "x")
    with graphs.eager():
        assert graphs._local.eager
        out2 = g(a, a, "y")
    assert not getattr(graphs._local, "eager", False)
    assert torch.equal(out[0], out2[0]) and calls == ["x", "y"] and graphs.cached() == 0
    assert graphs.map_tensors(lambda t: t * 2, (a, None, "s"))[0].sum() == 6


def test_launch_counts_are_taken_back_and_added_by_route():
    """What a capture takes back and each replay adds: every kernel module's
    launches and, for K1 (by input form), K3 and the front's finish, its
    launches by route (`route_launches`)."""
    from srsran_ce_tpu_torch.ops.kernels import front as k1
    from srsran_ce_tpu_torch.ops.kernels import front_finish as kf
    from srsran_ce_tpu_torch.ops.kernels import ldpc_stream as k3

    mods = graphs.kernel_modules()
    before = graphs.launch_counts(mods)
    assert dict(before[mods.index(k1)][1]) == k1.route_launches
    assert dict(before[mods.index(k3)][1]) == k3.route_launches
    assert dict(before[mods.index(kf)][1]) == kf.route_launches
    assert all(by_route == {} for m, (_, by_route) in zip(mods, before) if m not in (k1, k3, kf))
    # a replay of a graph holding one pair launch of K3 and one staged launch
    # of K1
    one = tuple((int(m in (k1, k3)),
                 {"pair": 1} if m is k3 else {"staged": 1} if m is k1 else {})
                for m in mods)
    graphs.add_launch_counts(mods, one)
    after = graphs.launch_counts(mods)
    assert after[mods.index(k3)][0] == before[mods.index(k3)][0] + 1
    assert after[mods.index(k3)][1]["pair"] == before[mods.index(k3)][1]["pair"] + 1
    assert after[mods.index(k1)][0] == before[mods.index(k1)][0] + 1
    assert after[mods.index(k1)][1] == dict(before[mods.index(k1)][1],
                                            staged=before[mods.index(k1)][1]["staged"] + 1)
    graphs.add_launch_counts(mods, one, -1)  # a capture's counts taken back
    assert graphs.launch_counts(mods) == before


def test_diagnose_on_the_cpu(capsys):
    rc = cli.main(["diagnose", "--device", "cpu", "--n-prbs", "8", "--batched"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("op_count: ") == 2 and out.count("capture hazards: 0") == 2
    assert "graph_count: not measured on the CPU" in out
    assert "offload verdict: no host fallbacks" in out
