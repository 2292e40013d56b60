"""One CUDA graph per builder call on the card: the port's counterpart of the
single XLA executable that `jax.jit` gives each builder of the JAX package.

A builder wraps its tensor-only forward in `Graphed`. On CUDA inputs the first
call of a key (the device, each tensor's shape and dtype, the identity of
every other argument, such as the denoiser's params) runs the forward eagerly:
it builds the plan tensors, the kernels and the cuBLAS / cuDNN handles, and a
key that never comes again (a one-off batch size) costs no capture. The
second call of the key captures the forward once into a `torch.cuda.CUDAGraph`
on a side stream and replays it; every later call copies its inputs into the
graph's static buffers, replays the graph and returns clones of its outputs,
so that a result the caller still holds never changes on a later call. A
capture that fails raises `GraphCaptureError` naming the builder and the key;
it never falls back to eager. CPU inputs run the forward eagerly, with no
graph, and so does every call inside `eager()` or inside another capture.

Each graph holds a private memory pool, so at most `MAX_GRAPHS` are kept
(least recently used first out); the keys seen once are remembered up to
`MAX_SEEN`. The kernels' launch counters count wrapper calls on the host: a
capture launches nothing, so its counts are taken back, and each replay adds
them again, once per kernel the graph launches, so the counters go on
counting launches on the card (one call, one launch of each of its kernels).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import torch

#: graphs kept at once over every builder (each holds a private memory pool)
MAX_GRAPHS = 32
#: keys remembered as seen once (each holds its non-tensor arguments)
MAX_SEEN = 256

_local = threading.local()
_graphs: "collections.OrderedDict" = collections.OrderedDict()  # (Graphed, key) -> _Entry
_seen: "collections.OrderedDict" = collections.OrderedDict()  # key -> its non-tensor arguments
_streams: dict = {}  # device -> the side stream of its captures
#: graphed calls on the card, captures and replays made by this process
#: (`cli diagnose`, chip_smoke and the card tests read them)
calls = 0
captures = 0
replays = 0


class GraphCaptureError(RuntimeError):
    """A builder call could not be captured into a CUDA graph."""


@contextlib.contextmanager
def eager():
    """Run every graphed builder eagerly inside the block (the reference a
    graphed result is held to, bit for bit)."""
    prev = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def hold(obj) -> None:
    """Keep `obj` alive as long as the graph being captured: a cache that
    hands the forward device memory it may later drop (the denoiser's
    modules) registers it here. Outside a capture it does nothing."""
    keep = getattr(_local, "keep", None)
    if keep is not None:
        keep.append(obj)


def _side_stream(dev) -> "torch.cuda.Stream":
    """The stream captures run on, one a device."""
    st = _streams.get(dev)
    if st is None:
        st = _streams[dev] = torch.cuda.Stream(dev)
    return st


def kernel_modules():
    """The seven kernels' wrapper modules, each with its `launches` counter."""
    from .ops.kernels import (fill_rotate, fill_rotate_serve, front, inpaint, ldpc, ldpc_stream,
                              rc_smooth)

    return (front, fill_rotate_serve, rc_smooth, fill_rotate, ldpc, ldpc_stream, inpaint)


def map_tensors(fn, value):
    """`fn` over every tensor of a result (dataclass, tuple), the structure
    and everything else kept."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value)(**{f.name: map_tensors(fn, getattr(value, f.name))
                              for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(map_tensors(fn, v) for v in value)
    return fn(value) if torch.is_tensor(value) else value


@dataclasses.dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    inputs: list  # the static input buffers, in argument order (None for non-tensors)
    outputs: object  # the forward's result, in the graph's pool
    launches: tuple  # per kernel module, the launches of one replay
    keep: list  # the non-tensor arguments and what `hold` registered

    def replay(self, args):
        global replays
        for buf, a in zip(self.inputs, args):
            if buf is not None:
                buf.copy_(a)
        self.graph.replay()
        replays += 1
        for m, n in zip(kernel_modules(), self.launches):
            m.launches += n
        return map_tensors(torch.clone, self.outputs)


class Graphed:
    """`forward(*args)` replayed from one CUDA graph per key on the card.

    `forward` takes tensors and other arguments (compared by identity: keep
    them immutable) and returns a tensor, a dataclass or a tuple of them. It
    must be capturable: no host synchronisation, no host-to-device copy, no
    tensor built from host data."""

    def __init__(self, forward, name: str):
        self.forward = forward
        self.name = name

    def __call__(self, *args):
        global calls
        dev = next((a.device for a in args if torch.is_tensor(a)), None)
        if (dev is None or dev.type != "cuda" or getattr(_local, "eager", False)
                or torch.cuda.is_current_stream_capturing()):
            return self.forward(*args)
        calls += 1
        key = (self, dev) + tuple(
            (tuple(a.shape), a.dtype, a.device) if torch.is_tensor(a) else id(a) for a in args
        )
        entry = _graphs.get(key)
        if entry is not None:
            _graphs.move_to_end(key)
            return entry.replay(args)
        if key not in _seen:  # the first call: eager, the warm-up of a later capture
            _seen[key] = [a for a in args if not torch.is_tensor(a)]  # their ids stay theirs
            if len(_seen) > MAX_SEEN:
                _seen.popitem(last=False)
            return self.forward(*args)
        return self._capture(key, dev, args).replay(args)

    def signature(self, key) -> str:
        shapes = ", ".join(
            f"{tuple(k[0])} {str(k[1]).replace('torch.', '')}" if isinstance(k, tuple)
            else "object" for k in key[2:]
        )
        return f"{self.name} on {key[1]} with ({shapes})"

    def _capture(self, key, dev, args) -> _Entry:
        """The capture of `key`, whose first call (eager) was the warm-up."""
        global captures
        mods = kernel_modules()
        inputs = [a.clone() if torch.is_tensor(a) else None for a in args]
        static = [b if b is not None else a for b, a in zip(inputs, args)]
        keep = _seen[key]  # a key whose capture failed stays seen: its next call raises too
        prev_eager, prev_keep = getattr(_local, "eager", False), getattr(_local, "keep", None)
        _local.eager, _local.keep = True, keep  # nested builders run inside this graph
        try:
            before = tuple(m.launches for m in mods)
            graph = torch.cuda.CUDAGraph()
            try:
                # capture_begin / capture_end on a side stream, not
                # `torch.cuda.graph`: its device synchronisation and emptying
                # of the device and pinned-host caches cost each capture more
                # than the eager call it replaces (a traffic mix, chip_smoke
                # phase 40)
                with torch.cuda.stream(_side_stream(dev)):
                    graph.capture_begin()
                    try:
                        outputs = self.forward(*static)
                    finally:
                        graph.capture_end()
            except Exception as e:
                raise GraphCaptureError(
                    f"CUDA graph capture of {self.signature(key)} failed: {e}"
                ) from e
            finally:
                counted = tuple(m.launches - b for m, b in zip(mods, before))
                for m, b in zip(mods, before):
                    m.launches = b
        finally:
            _local.eager, _local.keep = prev_eager, prev_keep
        captures += 1
        del _seen[key]
        entry = _graphs[key] = _Entry(graph, inputs, outputs, counted, keep)
        if len(_graphs) > MAX_GRAPHS:
            torch.cuda.synchronize(dev)  # the evicted graph's pool may be in use by a replay
            _graphs.popitem(last=False)
        return entry


_SYNC_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
             "aten._unique", "aten.unique", "aten.repeat_interleave.Tensor",
             "aten._linalg_check_errors", "aten.equal")


def _caller() -> str:
    """file:line of the innermost frame of this package outside this module."""
    import traceback

    for fr in reversed(traceback.extract_stack()):
        if "srsran_ce_tpu_torch" in fr.filename and not fr.filename.endswith("graphs.py"):
            return f"{fr.filename.split('srsran_ce_tpu_torch')[-1].lstrip('/')}:{fr.lineno}"
    return "?"


class CaptureCheck:
    """What would stop a call's capture on the card, found on the CPU.

    Inside the block every aten op is counted (`ops`), and `hazards` lists the
    ops that a CUDA graph cannot hold: a tensor made from host data (numpy, a
    Python list, `torch.tensor`) meeting a tensor that was alive before the
    block (the inputs, the plan's tensors, the weights: on the card, device
    memory), a host synchronisation on such a tensor (`.item()`, `nonzero`,
    a boolean-mask index, `.numpy()`, `.tolist()`), each with its op.

        fn(*args)                  # warm-up: the plan's tensors are built
        with graphs.CaptureCheck() as chk:
            fn(*args)
        assert not chk.hazards, chk.hazards
    """

    def __init__(self):
        self.ops: "collections.Counter" = collections.Counter()
        self.hazards: list = []

    def __enter__(self):
        import gc

        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        import warnings

        with warnings.catch_warnings():  # some objects warn when their type is asked
            warnings.simplefilter("ignore")
            resident = {id(o): o for o in gc.get_objects() if isinstance(o, torch.Tensor)}
        check = self

        def is_res(t):
            return resident.get(id(t)) is t

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = str(func)
                check.ops[name] += 1
                ins = [a for a in tree_flatten((args, kwargs))[0] if torch.is_tensor(a)]
                res_in = [t for t in ins if is_res(t)]
                host_in = [t for t in ins if not is_res(t)]
                bad = None
                if res_in and name.startswith(_SYNC_OPS):
                    bad = "host synchronisation"
                elif res_in and any(t.dtype == torch.bool for t in ins[1:]) and \
                        name.startswith(("aten.index.", "aten.index_put")):
                    bad = "boolean-mask index (a host synchronisation)"
                elif res_in and host_in:
                    bad = "host tensor " + ", ".join(str(tuple(t.shape)) for t in host_in)
                if bad:
                    check.hazards.append(f"{name}: {bad} at {_caller()}")
                out = func(*args, **kwargs)
                if bad or not host_in:
                    for t in tree_flatten(out)[0]:
                        if torch.is_tensor(t):
                            resident[id(t)] = t
                return out

        def flag(method):
            orig = getattr(torch.Tensor, method)

            def wrapped(t, *a, **k):
                if is_res(t):
                    check.hazards.append(f"Tensor.{method}: host synchronisation at {_caller()}")
                return orig(t, *a, **k)

            return orig, wrapped

        self._patched = {m: flag(m) for m in ("numpy", "tolist")}
        for m, (_, w) in self._patched.items():
            setattr(torch.Tensor, m, w)
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        for m, (orig, _) in self._patched.items():
            setattr(torch.Tensor, m, orig)
        return False


def cached() -> int:
    """The number of graphs kept."""
    return len(_graphs)


def clear() -> None:
    """Drop every kept graph and every key seen (after the work on the card
    has finished): the next call of each key is eager again."""
    if _graphs and torch.cuda.is_available():
        torch.cuda.synchronize()
    _graphs.clear()
    _seen.clear()
