"""srsRAN test-vector I/O: binary .dat readers and the C++ test-header parser.

Re-implements the reference harness's vector-replay capability (SURVEY.md §2 #15-#20;
scripts/validation/validate_all.py:28-344) so the framework can replay the original
248 MATLAB-generated `port_channel_estimator` conformance vectors when a
`testvector_outputs/` directory is available. The vectors are NOT shipped with the
reference (gitignored), so the same record formats are also used by our hermetic
golden round-trip tests (tests/test_vectors_io.py), which synthesize vectors from the
float64 oracle.

Record format (srsRAN resource_grid_reader_spy::expected_entry_t dumps): little-endian
12-byte records `<HHff` = (uint16 sym<<8|port, uint16 subcarrier, float32 re, float32
im). Pilots files are raw complex64 arrays with an undocumented axis order; candidate
orderings are searched per case exactly like the reference does.

A numpy copy of `srsran_ce_tpu/utils/vectors.py` (the port cannot import the JAX
package, whose `__init__` imports `jax`); tests/test_torch_plan.py holds the two
packages' parses bit-identical. Records are parsed by the port's native C++
parser (`native/loader.py`, the counterpart of `srsran_ce_tpu/native`) when it
builds, else by the numpy branch `parse_entries_np`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from itertools import permutations
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import NRE

# ---------------------------------------------------------------------------
# Binary record I/O
# ---------------------------------------------------------------------------

_ENTRY_DTYPE = np.dtype(
    [("packed", "<u2"), ("sc", "<u2"), ("re", "<f4"), ("im", "<f4")]
)


def load_entries(path) -> np.ndarray:
    """Read expected_entry_t records into a structured array with fields
    (sym, port, sc, value). Uses the native C++ parser when available."""
    from ..native import loader as _native

    raw = Path(path).read_bytes()
    if len(raw) % 12 != 0:
        raise ValueError(f"{path}: size {len(raw)} is not a multiple of 12 bytes")
    if _native.available():
        return _native.parse_entries(raw)
    return parse_entries_np(raw)


def parse_entries_np(raw: bytes) -> np.ndarray:
    """Vectorized numpy parse of expected_entry_t records."""
    rec = np.frombuffer(raw, dtype=_ENTRY_DTYPE)
    out = np.empty(
        rec.size,
        dtype=[("sym", np.int32), ("port", np.int32), ("sc", np.int32), ("value", np.complex64)],
    )
    out["sym"] = (rec["packed"] >> 8).astype(np.int32)
    out["port"] = (rec["packed"] & 0xFF).astype(np.int32)
    out["sc"] = rec["sc"].astype(np.int32)
    out["value"] = rec["re"] + 1j * rec["im"]
    return out


def entries_to_grid(entries: np.ndarray, n_sc: int, n_sym: int, n_layers: Optional[int] = None) -> np.ndarray:
    """Scatter records into a dense (n_sc, n_sym, n_layers) complex64 grid."""
    if n_layers is None:
        n_layers = int(entries["port"].max()) + 1 if entries.size else 1
    grid = np.zeros((n_sc, n_sym, n_layers), dtype=np.complex64)
    grid[entries["sc"], entries["sym"], entries["port"]] = entries["value"]
    return grid


def write_entries(path, sym: np.ndarray, port: np.ndarray, sc: np.ndarray, values: np.ndarray) -> None:
    """Write records in expected_entry_t format (used by the hermetic golden tests
    and the synthetic-vector generator)."""
    rec = np.empty(len(values), dtype=_ENTRY_DTYPE)
    rec["packed"] = (np.asarray(sym).astype(np.uint16) << 8) | np.asarray(port).astype(np.uint16)
    rec["sc"] = np.asarray(sc).astype(np.uint16)
    v = np.asarray(values).astype(np.complex64)
    rec["re"] = v.real
    rec["im"] = v.imag
    Path(path).write_bytes(rec.tobytes())


def grid_to_entries(grid: np.ndarray, only_nonzero: bool = True):
    """Dense (n_sc, n_sym, n_layers) grid -> (sym, port, sc, values) record arrays."""
    sc, sym, port = np.nonzero(np.abs(grid) > 0) if only_nonzero else np.unravel_index(
        np.arange(grid.size), grid.shape
    )
    return sym, port, sc, grid[sc, sym, port]


# ---------------------------------------------------------------------------
# port_channel_estimator_test_data.h parser
# ---------------------------------------------------------------------------


@dataclass
class ParsedHop:
    dmrs_symbols: List[int]
    mask_prbs: List[int]
    dmrs_re_mask: List[int]
    hop_symbol: Optional[int] = None


@dataclass
class ParsedCase:
    idx: int
    scs_hz: float
    start_symbol: int
    n_alloc_syms: int
    beta_dmrs: float
    smoothing: str
    cfo_compensate: bool
    grid_size_prbs: int
    hops: List[ParsedHop] = field(default_factory=list)


def _split_case_blocks(text: str) -> List[str]:
    """Split the top-level `... port_channel_estimator_test_data = { {...}, {...} }`
    initializer into per-case brace blocks (depth-2 tracking, string-aware)."""
    anchor = text.index("port_channel_estimator_test_data")
    start = text.index("{", text.index("=", anchor))
    blocks: List[str] = []
    depth = 0
    in_str = False
    blk_start = None
    for i in range(start, len(text)):
        ch = text[i]
        if ch == '"' and text[i - 1] != "\\":
            in_str = not in_str
        if in_str:
            continue
        if ch == "{":
            depth += 1
            if depth == 2:
                blk_start = i
        elif ch == "}":
            if depth == 2 and blk_start is not None:
                blocks.append(text[blk_start : i + 1])
                blk_start = None
            depth -= 1
            if depth == 0:
                break
    return blocks


_TOKEN_RE = re.compile(r"\{[^{}]*\}|std::nullopt|[-+]?\d+")


def _tokens(block: str):
    """Flatten a C++ initializer block into ('arr', [ints]) / ('int', n) /
    ('null', None) tokens, skipping string literals inside array braces."""
    out = []
    for m in _TOKEN_RE.finditer(block):
        tok = m.group(0)
        if tok == "std::nullopt":
            out.append(("null", None))
        elif tok.startswith("{"):
            nums = []
            for part in tok.strip("{}").replace("\n", " ").split(","):
                part = part.strip()
                if not part or (part.startswith('"') and part.endswith('"')):
                    continue
                try:
                    nums.append(int(part))
                except ValueError:
                    pass
            out.append(("arr", nums))
        else:
            out.append(("int", int(tok)))
    return out


class _TokenStream:
    """Cursor over the flattened token list with named matchers — the grammar
    below consumes it production by production."""

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def eof(self) -> bool:
        return self.i >= len(self.toks)

    def _peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take_arr(self, want_len=None, multiple_of=None):
        """Consume and return the next token iff it is an array matching the
        length constraint; None (no consumption) otherwise."""
        kind, val = self._peek()
        if kind != "arr":
            return None
        if want_len is not None and len(val) not in want_len:
            return None
        if multiple_of is not None and (not val or len(val) % multiple_of):
            return None
        self.i += 1
        return val

    def take_int(self):
        kind, val = self._peek()
        if kind != "int":
            return None
        self.i += 1
        return val

    def advance(self):
        self.i += 1


def _extract_hops(tokens, n_alloc_syms: int) -> List[ParsedHop]:
    """Parse hop structures out of the flattened token stream.

    The header's hop grammar (established against the format itself and pinned
    by the full-fidelity fuzzer, validation/synth_vectors.generate_fuzz_header):

        hop     := dmrs_mask  prb_mask*  hop_symbol?  junk*  re_mask
        dmrs_mask  = array of length n_alloc_syms or 14 (per-symbol DM-RS flags)
        prb_mask   = array of length 52 (one per layer run; absent for
                     full-default cases -> a single all-zero mask stands in)
        hop_symbol = bare integer (first-hop symbol boundary; optional)
        re_mask    = first following array whose length is a positive multiple
                     of 12 (the 12 x n_cdm per-PRB RE flags); intervening
                     scalar config fields are junk at this level

    Tokens that open no production are skipped; a dmrs_mask with no re_mask
    before EOF is an incomplete trailing fragment and is dropped. One ParsedHop
    is emitted per (dmrs_mask, prb_mask) pair — repeated PRB masks are how the
    header encodes per-layer repetitions of the same hop.
    """
    ts = _TokenStream(tokens)
    hops: List[ParsedHop] = []
    dmrs_lens = {n_alloc_syms, 14}
    while not ts.eof():
        dmrs_symbols = ts.take_arr(want_len=dmrs_lens)
        if dmrs_symbols is None:
            ts.advance()
            continue
        prb_masks = []
        while True:
            pm = ts.take_arr(want_len={52})
            if pm is None:
                break
            prb_masks.append(pm)
        hop_symbol = ts.take_int()
        re_mask = None
        while not ts.eof():
            re_mask = ts.take_arr(multiple_of=NRE)
            if re_mask is not None:
                break
            ts.advance()
        if re_mask is None:
            break
        for pm in prb_masks or [[0] * 52]:
            hops.append(ParsedHop(dmrs_symbols, pm, re_mask, hop_symbol))
    return hops


def parse_test_header(path) -> List[ParsedCase]:
    """Parse all case configs from srsRAN's generated test header (the reference's
    component #17; same field heuristics as validate_all.py:200-263)."""
    text = Path(path).read_text()
    cases: List[ParsedCase] = []
    for block in _split_case_blocks(text):
        m = re.search(r"input_rg(\d+)", block)
        idx = int(m.group(1)) if m else len(cases)

        m = re.search(r"subcarrier_spacing::kHz(\d+)", block)
        scs_hz = (int(m.group(1)) if m else 15) * 1000.0

        m = re.search(r"cyclic_prefix::\w+,\s*(\d+),\s*(\d+)", block)
        start_symbol, n_alloc = (int(m.group(1)), int(m.group(2))) if m else (0, 14)

        m = re.search(r"port_channel_estimator_fd_smoothing_strategy::(\w+)", block)
        smoothing = m.group(1) if m else "filter"
        smooth_pos = m.start() if m else 0

        m = re.search(
            r"port_channel_estimator_fd_smoothing_strategy::\w+,\s*(true|false)", block
        )
        cfo_compensate = (m.group(1) == "true") if m else True

        m = re.search(
            r"port_channel_estimator_fd_smoothing_strategy::\w+,\s*(?:true|false),\s*(\d+)",
            block,
        )
        grid_size_prbs = int(m.group(1)) if m else 52

        floats = re.findall(r"[-+]?[0-9]*\.?[0-9]+", block[:smooth_pos])
        beta_dmrs = float(floats[-1]) if floats else 1.4125

        hops = _extract_hops(_tokens(block), n_alloc)
        # Collapse identical per-layer hop repetitions
        if len(hops) > 1 and all(
            h.hop_symbol == hops[0].hop_symbol
            and h.dmrs_symbols == hops[0].dmrs_symbols
            and h.mask_prbs == hops[0].mask_prbs
            and h.dmrs_re_mask == hops[0].dmrs_re_mask
            for h in hops
        ):
            hops = [hops[0]]

        cases.append(
            ParsedCase(
                idx=idx,
                scs_hz=scs_hz,
                start_symbol=start_symbol,
                n_alloc_syms=n_alloc,
                beta_dmrs=beta_dmrs,
                smoothing=smoothing,
                cfo_compensate=cfo_compensate,
                grid_size_prbs=grid_size_prbs,
                hops=hops,
            )
        )
    cases.sort(key=lambda c: c.idx)
    return cases


# ---------------------------------------------------------------------------
# Pilot-layout candidate search
# ---------------------------------------------------------------------------


def pilot_candidates(
    pilots_flat: np.ndarray, n_dsym: int, n_re: int, n_layers: int
) -> List[Tuple[str, np.ndarray]]:
    """All (sym, re, layer) axis-order and layer permutations of a raw pilot dump,
    each converted to the canonical (re, sym, layer) layout (component #20;
    validate_all.py:306-344). The conformance runner picks the ordering with lowest
    error vs the reference output."""
    out: List[Tuple[str, np.ndarray]] = []
    seen = set()
    sizes = {"sym": n_dsym, "re": n_re, "layer": n_layers}
    for order in permutations(("sym", "re", "layer")):
        arr = pilots_flat.reshape(tuple(sizes[a] for a in order))
        src = {name: i for i, name in enumerate(order)}
        canon = np.transpose(arr, (src["re"], src["sym"], src["layer"]))
        layer_perms = (
            list(permutations(range(n_layers))) if 1 < n_layers <= 4 else [tuple(range(n_layers))]
        )
        for lp in layer_perms:
            cand = np.ascontiguousarray(canon[:, :, list(lp)])
            key = cand.tobytes()
            if key in seen:
                continue
            seen.add(key)
            tag = "-".join(order) + (f":L{''.join(map(str, lp))}" if n_layers > 1 else "")
            out.append((tag, cand))
    return out


def dedupe_re_mask_columns(re_mask: np.ndarray) -> np.ndarray:
    """Keep unique DMRS RE mask columns in first-seen order."""
    if re_mask.ndim != 2 or re_mask.shape[1] <= 1:
        return re_mask
    cols, seen = [], set()
    for i in range(re_mask.shape[1]):
        key = re_mask[:, i].tobytes()
        if key not in seen:
            seen.add(key)
            cols.append(re_mask[:, i : i + 1])
    return np.concatenate(cols, axis=1)
