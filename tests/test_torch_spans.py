"""The program's spans and counters (`srsran_ce_tpu_torch/utils/spans.py`), on
the CPU.

Off, they record nothing and `process` gives the same results bit for bit as
with them on; nested spans split their time into self times that add up to
the root's; inside `utils/profiling.trace()` the spans are user annotations
on the profiler's timeline, with no profiler no `record_function` is
entered, and a profiler alone does not turn them on; a decoded call of two
chunks records one `serving.process`, a pack and an H2D copy a staged array
(the grids, the pilots, the betas) and a fetch wait and an unpack a chunk,
and counts the staged tensors' bytes; a `TrackedServer` call unpacks each
chunk in its `serving.unpack` span; a device decode call counts the code
blocks each chunk hands its decoder; a factored call of two chunks whose
results stand on a (simulated) card counts the fetched tensors' bytes, and
with the spans off nothing, the results bit-identical; the CUDA event pairs of `device_span`
resolve without a wait of their own; `utils/profiling.trace()` turns the
spans on.
"""
import json
import os

import numpy as np
import pytest
import torch

from srsran_ce_tpu_torch import graphs, serving, transport
from srsran_ce_tpu_torch.ops import ldpc
from srsran_ce_tpu_torch.utils import profiling, spans, synthetic

SPANS = ("serving.pack", "serving.h2d", "graphs.replay", "serving.fetch_wait", "serving.unpack",
         "serving.process")


def decoded_call(n_problems=3, batch_size=2):
    """A call that decodes on the device path, two chunks of two problems (the
    tail repeat-padded): random payloads on a 2 x 1 QPSK link, an array code."""
    cases = [synthetic.make_mimo_case(seed=900 + i, n_rx=2, modulation="qpsk", scramble=False,
                                      n_prbs=12, n_layers=1) for i in range(n_problems)]
    probs = [serving.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                             c.beta, c.hop1, c.hop2, c.config) for c in cases]
    coding = transport.TransportCoding(code=ldpc.array_code(8, 16, 61), n_iters=4, crc="crc16")

    def call():
        return serving.process(probs, batch_size=batch_size, out="decoded", modulation="qpsk",
                               coding=coding, decode_on_device=True, device="cpu")
    return probs, call


@pytest.fixture(scope="module")
def decoded():
    return decoded_call()


def test_off_records_nothing_and_on_changes_no_result(decoded):
    probs, call = decoded
    before = spans.snapshot()
    off = call()
    assert spans.snapshot() == before
    with spans.enabled():
        on = call()
    assert spans.snapshot() != before
    for a, b in zip(off, on):
        assert np.array_equal(a.info, b.info) and np.array_equal(a.ok, b.ok)
        for n in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
            assert getattr(a, n) == getattr(b, n)


def test_nested_spans_give_self_times(monkeypatch):
    ticks = iter([0, 10, 40, 50, 60, 100, 200, 205])
    monkeypatch.setattr(spans.time, "perf_counter_ns", lambda: next(ticks))
    before = spans.snapshot()
    with spans.enabled():
        with spans.span("t.outer"):
            with spans.span("t.inner"):  # 10 .. 40
                pass
            with spans.span("t.inner"):  # 50 .. 60
                pass
        with spans.span("t.outer"):  # 200 .. 205, a root of its own
            pass
    d = spans.delta(spans.snapshot(), before)["spans"]
    assert d["t.outer"] == {"count": 2, "total_ns": 105, "self_ns": 65, "roots": 2}
    assert d["t.inner"] == {"count": 2, "total_ns": 40, "self_ns": 40, "roots": 0}


def trace_events(path):
    names = [f for f in os.listdir(path) if f.endswith(".json")]
    assert names
    with open(os.path.join(path, names[0])) as f:
        return json.load(f)["traceEvents"]


def test_trace_carries_the_spans_and_no_profiler_enters_no_record_function(
        decoded, monkeypatch, tmp_path):
    probs, call = decoded
    entered = []
    real = spans._profiler.record_function

    def counting(name, *a):
        entered.append(name)
        return real(name, *a)

    monkeypatch.setattr(spans._profiler, "record_function", counting)
    with spans.enabled():
        call()
    assert entered == []
    before = spans.snapshot()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        call()  # a profiler alone: the spans stay off
    assert entered == [] and spans.snapshot() == before
    with profiling.trace(str(tmp_path)):
        call()
    assert entered.count("serving.process") == 1 and entered.count("serving.unpack") == 2
    names = {e["name"] for e in trace_events(str(tmp_path)) if e.get("cat") == "user_annotation"}
    assert {"serving.process", "serving.pack", "serving.h2d", "serving.fetch_wait",
            "serving.unpack"} <= names


def test_a_decoded_call_of_two_chunks(decoded):
    probs, call = decoded
    before = spans.snapshot()
    with spans.enabled():
        call()
    d = spans.delta(spans.snapshot(), before)
    s = d["spans"]
    assert s["serving.process"]["count"] == s["serving.process"]["roots"] == 1
    for n, per_chunk in (("serving.pack", 3), ("serving.h2d", 3), ("serving.fetch_wait", 1),
                         ("serving.unpack", 1)):
        assert (s[n]["count"], s[n]["roots"]) == (2 * per_chunk, 0), n
    assert s.get("graphs.replay", {}).get("count", 0) == 0  # no graph on the CPU
    # the six names partition the root's time: the self times add up to it
    assert sum(s[n]["self_ns"] for n in SPANS if n in s) == s["serving.process"]["total_ns"]
    # every chunk stages B = 2 grids, pilots and betas, float32 (re, im) pairs
    rg, pil = probs[0].received_rg, probs[0].pilots
    per_chunk = 2 * (2 * rg.size * 4 + 2 * pil.size * 4 + 4)
    assert d["counters"]["serving.h2d_bytes"] == 2 * per_chunk


def test_a_tracked_call_unpacks_each_chunk_in_its_span():
    """TrackedServer runs the serve loop: three chunks (five streams at batch
    2), each fetched and scattered once, its states staged beside its grids."""
    cases = [synthetic.make_case(seed=600 + k, n_prbs=8, n_layers=1) for k in range(5)]
    probs = [serving.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                             c.beta, c.hop1, c.hop2, c.config) for c in cases]
    srv = serving.TrackedServer(batch_size=2, device="cpu")
    before = spans.snapshot()
    with spans.enabled():
        srv.process(probs, [f"s{k}" for k in range(5)])
    s = spans.delta(spans.snapshot(), before)["spans"]
    assert (s["serving.unpack"]["count"], s["serving.fetch_wait"]["count"]) == (3, 3)
    assert s["serving.pack"]["count"] == s["serving.h2d"]["count"] == 3 * 5  # + h, w


def test_h2d_bytes_are_the_staged_tensors_nbytes(monkeypatch):
    sent = []
    real = serving._send

    def capture(t, device):
        sent.append(t)
        return real(t, device)

    monkeypatch.setattr(serving, "_send", capture)
    probs, call = decoded_call(n_problems=5, batch_size=4)  # chunks of 4 and 4 (padded)
    before = spans.snapshot()
    with spans.enabled():
        call()
    d = spans.delta(spans.snapshot(), before)
    assert len(sent) == 6
    assert d["counters"]["serving.h2d_bytes"] == sum(t.nbytes for t in sent)


@pytest.mark.parametrize("n_problems,batch_size,taken", [(3, 2, 4), (5, 4, 8), (2, 8, 2)])
def test_decode_words_are_the_words_each_chunk_hands_its_decoder(n_problems, batch_size, taken):
    """`serving.decode_words` counts every problem a device decode chunk
    takes, the tail's repeats included, times its code blocks; nothing with
    the spans off."""
    probs, call = decoded_call(n_problems=n_problems, batch_size=batch_size)
    p = probs[0]
    coding = transport.TransportCoding(code=ldpc.array_code(8, 16, 61), n_iters=4, crc="crc16")
    c_words = transport.layout(coding, p.hop1, p.hop2, *p.received_rg.shape[-2:], 1, 2).c_words
    before = spans.snapshot()
    call()
    assert spans.snapshot() == before
    with spans.enabled():
        res = call()
    d = spans.delta(spans.snapshot(), before)
    assert c_words > 1 and all(r.info.shape[0] == c_words for r in res)
    assert d["counters"]["serving.decode_words"] == taken * c_words


class OnCard(torch.Tensor):
    """A host tensor that `serving._HostCopy` takes for one on the card."""

    @property
    def device(self):
        return torch.device("cuda")


class CopyEvent:
    """The host side of the event `_HostCopy` records after its copies."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


def factored_call_on_a_card(monkeypatch, fetched):
    """A factored call of two chunks (3 problems, batch 2) whose chunk results
    reach `_HostCopy` as tensors on a card: the real fetch runs with the CUDA
    runtime's host calls (pinned allocation, event, stream) stood in for;
    `fetched` collects each tensor fetched."""
    cases = [synthetic.make_case(seed=700 + i, n_prbs=12, n_layers=2) for i in range(3)]
    probs = [serving.Problem(c.received_rg.astype(np.complex64), c.pilots.astype(np.complex64),
                             c.beta, c.hop1, c.hop2, c.config) for c in cases]
    real_init, real_empty = serving._HostCopy.__init__, torch.empty

    def on_card(t):
        t = t.as_subclass(OnCard)
        fetched.append(t)
        return t

    def init(self, value):
        real_init(self, graphs.map_tensors(on_card, value))

    monkeypatch.setattr(serving._HostCopy, "__init__", init)
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: real_empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "Event", CopyEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return lambda: serving.process(probs, batch_size=2, out="factored", device="cpu")


def test_d2h_bytes_are_the_fetched_tensors_nbytes(monkeypatch):
    fetched = []
    call = factored_call_on_a_card(monkeypatch, fetched)
    before = spans.snapshot()
    off = call()
    assert spans.snapshot() == before and len(fetched) > 0
    fetched.clear()
    with spans.enabled():
        on = call()
    d = spans.delta(spans.snapshot(), before)
    assert d["spans"]["serving.fetch_wait"]["count"] == 2  # two chunks, each fetched once
    assert d["counters"]["serving.d2h_bytes"] == sum(t.nbytes for t in fetched)
    # the profiles, rotations and scalars of both chunks (two problems each)
    prof = off[0].profiles
    assert d["counters"]["serving.d2h_bytes"] >= 2 * 2 * (prof.size + off[0].sym_rot.size) * 8
    assert len(off) == len(on) == 3
    for a, b in zip(off, on):
        assert np.array_equal(a.profiles, b.profiles) and np.array_equal(a.sym_rot, b.sym_rot)
        for n in ("noise_est", "rsrp", "epre", "time_alignment", "cfo_hz"):
            assert getattr(a, n) == getattr(b, n)


class FakeEvent:
    """A CUDA event's host side: done once the test says so."""

    def __init__(self, log):
        self.log, self.done, self.t = log, False, None

    def record(self, stream=None):
        self.t = len(self.log)
        self.log.append(("record", self))

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append(("wait", self))
        self.done = True

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_span_pairs_resolve_without_a_wait(monkeypatch):
    log, made = [], []

    def event():
        e = FakeEvent(log)
        made.append(e)
        return e

    monkeypatch.setattr(spans, "_event", event)
    monkeypatch.setattr(spans, "_current_stream", lambda: None)
    monkeypatch.setattr(spans, "_pending", type(spans._pending)())
    monkeypatch.setattr(spans, "_counters", {})
    monkeypatch.setattr(spans, "_free", [])
    with spans.device_span("t.ms"):  # off: no event
        pass
    assert made == []
    with spans.enabled():
        for _ in range(3):
            with spans.device_span("t.ms"):
                pass
    assert len(spans._pending) == 3 and not any(w == "wait" for w, _ in log)
    made[1].done = True  # the first pair's end: resolved at the next poll
    spans.poll()
    assert spans._counters["t.ms"] == 1.0 and len(spans._pending) == 2
    made[5].done = True  # the third's end is done but the second's is not: kept in order
    spans.poll()
    assert len(spans._pending) == 2
    snap = spans.snapshot()  # waits for the pending ends alone, then resolves them
    assert snap["counters"]["t.ms"] == 3.0 and not spans._pending
    assert [e for w, e in log if w == "wait"] == [made[3]]
    monkeypatch.setattr(spans, "MAX_PENDING", 2)
    with spans.enabled():
        for _ in range(3):
            with spans.device_span("t.ms"):
                pass
    assert len(spans._pending) <= 2  # past the bound the oldest pair is waited for


def test_trace_turns_the_spans_on(tmp_path):
    before = spans.snapshot()
    with profiling.trace(str(tmp_path)):
        with spans.span("t.traced"):
            torch.ones(2) + 1
    with spans.span("t.traced"):  # off again
        pass
    assert spans.delta(spans.snapshot(), before)["spans"]["t.traced"]["count"] == 1
    names = {e["name"] for e in trace_events(str(tmp_path)) if e.get("cat") == "user_annotation"}
    assert "t.traced" in names
