"""Device-resident SW engine: the port of the JAX package's
`ops/sw_engine.py::DeviceAlignDB`.

The query tokens, their int8 composition bias and the target tokens are
copied to the device once, unpadded, and addressed by int64 element
offsets.  Forward and reverse jobs are buffered per direction and
dispatched as one stage once DISPATCH_PAIRS pairs are waiting (or at
flush(); `StageBuffer`, which the target-sharded engine shares): the
stage's pairs are sorted by cell count, longest first (a
warp owns a pair and blocks start in order, so a launch ends on its
short pairs), packed into one (5, n) int64 job array (qoff, qlen, toff,
tlen, terminate) that the wrapper copies to the device once, and scored
by the `ops/sw_cuda.py` kernels on the current stream (the plain version
for CPU tensors).
Results stay on the device until collect(), which fetches every pending
stage with one device-to-host copy.  Two times are kept a direction, both
by CUDA events on the engine's card: `*_kernel_ms`, recorded by the
wrapper round its launches alone (from the fork to the join where the
stage takes the block path), and `*_wrapper_ms`, round the whole wrapper
call (host planning, the job table's copy and the launches).

On a card both stages send their long pairs to the block path
(`sw_cuda.sw_forward` / `sw_reverse`: `sw_forward_shards_block` /
`sw_reverse_shards_block` beside the warp kernel; `fwd_block_pairs`,
`fwd_block_launches`, `rev_block_pairs`, `rev_block_launches` among the
metrics), through the one-tensor pointer table of the engine's target
array, made when the engine is.

`DeviceAlignDB.with_targets(tdata)` gives an engine over another target
array that shares the resident query tensors (and makes its own pointer
table): the alternative-alignment rounds score the resident queries
against masked copies of their targets through the same kernels.

`StructureDeviceDB` is the port of `StructureDeviceDB` (the resident side
of `_sw_bucket_struct`): five resident arrays (3Di and amino-acid tokens
of both sides and the int8 3Di bias) and two int8 tables, the same
enqueue/flush/collect/run_buckets contract, and the structure kernels.

`ProfileDeviceDB` is the resident side of the profile-query search (the
JAX package scores those pairs with `ops/sw.py::sw_forward_from_profiles`
/ `sw_reverse_from_profiles` on per-batch explicit profiles): the
queries' int8 alignment profiles as one (sum of query lengths, 21)
array at the token arrays' offsets, the target tokens, and the profile
kernels; its reverse stage sends its long pairs to the block path
(`rev_block_pairs`, `rev_block_launches` among its metrics).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import trace
from . import sw_cuda
from .sw import PROF_COLS

# pairs per dispatched stage: enough to fill the card at a warp per pair
# (132 SMs x 12-16 warps) many times over, so that a stage's tail is short
DISPATCH_PAIRS = 1 << 16


def _device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is "
                           "not available")
    return device


def _check_tokens(name: str, a: np.ndarray, alpha: int) -> None:
    if len(a) and int(a.max()) >= alpha:
        raise ValueError(f"{name} token out of the {alpha}-letter alphabet")


def _upload(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    # a loaded SetDB maps its arrays read-only: copy those
    return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(device)


class StageBuffer:
    """The stage buffer of both engines: jobs buffered a (gap_open,
    gap_extend, direction) and dispatched as one stage once DISPATCH_PAIRS
    pairs wait (or at flush()).  An engine gives `_dispatch(cols,
    gap_open, gap_extend, reverse)`, which launches a stage of the six
    columns (qoff, qlen, toff, tlen, term, positions) and returns what
    `collect(pending)` takes for it."""

    _buf: dict

    def enqueue(self, jobs, gap_open: int, gap_extend: int,
                reverse: bool):
        """Buffer jobs (an iterable of (qoff, qlen, toff, tlen, term,
        positions) arrays) and dispatch the buffer as one stage once it
        holds DISPATCH_PAIRS pairs.  Returns the pending stages
        dispatched now (for collect())."""
        key = (gap_open, gap_extend, reverse)
        buf = self._buf.setdefault(key, [])
        for job in jobs:
            buf.append(tuple(np.asarray(c) for c in job))
        if sum(len(b[0]) for b in buf) >= DISPATCH_PAIRS:
            return self.flush(gap_open, gap_extend, reverse)
        return []

    def flush(self, gap_open: int, gap_extend: int, reverse: bool):
        """Dispatch whatever is buffered for this direction."""
        buf = self._buf.pop((gap_open, gap_extend, reverse), [])
        if not buf or sum(len(b[0]) for b in buf) == 0:
            return []
        cols = [np.concatenate([b[i] for b in buf]) for i in range(6)]
        with trace.span("sw.dispatch", dir="rev" if reverse else "fwd",
                        pairs=len(cols[0]),
                        cells=int((cols[1].astype(np.int64)
                                   * cols[3].astype(np.int64)).sum())):
            return [self._dispatch(cols, gap_open, gap_extend, reverse)]

    def run_buckets(self, jobs, gap_open: int, gap_extend: int,
                    reverse: bool):
        """enqueue + flush + collect for one direction."""
        return self.collect(self.enqueue(jobs, gap_open, gap_extend, reverse)
                            + self.flush(gap_open, gap_extend, reverse))


class DeviceAlignDB(StageBuffer):
    """Resident arrays for one (query DB, target DB) pair.

    qdata/qbias/tdata: concatenated uint8 tokens / int8 bias / uint8
    tokens; sub: (A, A) substitution matrix; device: where the arrays
    live and the SW runs (a CUDA device runs the kernels, the CPU the
    plain version)."""

    # the cell of sw_cuda.ENTRIES whose wrappers score a stage
    CELL = "seq"

    def __init__(self, qdata: np.ndarray, qbias: np.ndarray,
                 tdata: np.ndarray, sub: np.ndarray,
                 device: torch.device | str):
        self.device = _device(device)
        for name, a in (("query", qdata), ("target", tdata)):
            _check_tokens(name, a, sub.shape[0])
        self.qdata, self.qbias, self.tdata, self.sub = (
            _upload(a, dt, self.device)
            for a, dt in ((qdata, np.uint8), (qbias, np.int8),
                          (tdata, np.uint8), (sub, np.int8)))
        self._init_state()

    def _init_state(self) -> None:
        if self.device.type == "cuda":
            # build and load the kernels now, outside every timed stage
            sw_cuda.load(self.device)
        # the pointer table of this engine's own target array that the
        # sequence stages' block path reads, made now (one upload,
        # before every timed stage; with_targets' view makes its own)
        self._targets = (sw_cuda.ShardTargets([self.tdata])
                         if self.device.type == "cuda" and self.CELL == "seq"
                         else None)
        self._buf: dict[tuple, list] = {}
        self.metrics = {"n_batches": 0,
                        "fwd_launches": 0, "rev_launches": 0,
                        "fwd_pairs": 0, "rev_pairs": 0,
                        "fwd_cells": 0, "rev_cells": 0,
                        "fwd_kernel_ms": 0.0, "rev_kernel_ms": 0.0,
                        "fwd_wrapper_ms": 0.0, "rev_wrapper_ms": 0.0}
        # the directions whose stages take the block path too
        for reverse in (False, True):
            if sw_cuda.ENTRIES[self.CELL, reverse][1]:
                d = "rev" if reverse else "fwd"
                self.metrics.update({f"{d}_block_pairs": 0,
                                     f"{d}_block_launches": 0})

    def _resident(self) -> tuple:
        """The wrappers' leading arguments."""
        return (self.qdata, self.qbias, self.tdata, self.sub)

    def _target_alphabet(self) -> int:
        return self.sub.shape[0]

    def with_targets(self, tdata: np.ndarray) -> "DeviceAlignDB":
        """An engine over the target tokens `tdata` (uploaded now) that
        shares this one's resident query arrays (and matrix), with a
        buffer and metrics of its own."""
        if self.CELL == "struct":
            raise NotImplementedError(
                "with_targets serves one target channel only")
        _check_tokens("target", tdata, self._target_alphabet())
        view = copy.copy(self)
        view.tdata = _upload(tdata, np.uint8, self.device)
        view._init_state()
        return view

    def _dispatch(self, cols, gap_open: int, gap_extend: int,
                  reverse: bool):
        jobs = np.stack([c.astype(np.int64) for c in cols[:5]])
        cells = jobs[1] * jobs[3]
        order = np.argsort(-cells, kind="stable")
        jobs = np.ascontiguousarray(jobs[:, order])
        timed = self.device.type == "cuda"
        # (start, end) event pairs: what the wrapper records round its
        # launches ("card") and, here, round the whole call ("wrapper")
        events: dict = {}
        if timed:
            stream = torch.cuda.current_stream(self.device)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        # the wrapper, looked up at dispatch
        wrapper = getattr(sw_cuda, sw_cuda.ENTRIES[self.CELL, reverse][0])
        extra = ({"targets": self._targets}
                 if self._targets is not None else {})
        out = wrapper(*self._resident(), jobs, gap_open, gap_extend,
                      events=events, **extra)
        if timed:
            ev[1].record(stream)
            events["wrapper"] = ev
        d = "rev" if reverse else "fwd"
        m = self.metrics
        m["n_batches"] += 1
        block = events.get("block_launches", 0)
        m[f"{d}_launches"] += events.get("warp_launches", 0) + block
        if f"{d}_block_launches" in m:
            m[f"{d}_block_launches"] += block
            m[f"{d}_block_pairs"] += events.get("n_long", 0)
        m[f"{d}_pairs"] += jobs.shape[1]
        m[f"{d}_cells"] += int(cells.sum())
        return (cols[5][order], out, events, d)

    def collect(self, pending):
        """Fetch every pending stage with ONE device-to-host copy.
        Returns (positions, (score, t_end, q_end, found, fj, fi)) per
        stage."""
        if not pending:
            return []
        with trace.span("sw.fetch"):
            flat = torch.cat([o for _, o, _, _ in pending],
                             dim=1).cpu().numpy()
        out, col = [], 0
        for pos, o, events, d in pending:
            for key, name in (("wrapper", "wrapper_ms"),
                              ("card", "kernel_ms")):
                if key in events:
                    ev = events[key]
                    self.metrics[f"{d}_{name}"] += ev[0].elapsed_time(ev[1])
            n = o.shape[1]
            out.append((pos, tuple(flat[i, col:col + n] for i in range(6))))
            col += n
        return out


class StructureDeviceDB(DeviceAlignDB):
    """Resident 3Di + amino-acid arrays of the structure search: qss/qaa
    and tss/taa are the uint8 3Di and amino-acid tokens of the queries and
    targets (same offsets), qbias the int8 3Di composition bias, m3di and
    aasc the (21, 21) tables of the two score channels."""

    CELL = "struct"

    def __init__(self, qss: np.ndarray, qaa: np.ndarray, qbias: np.ndarray,
                 tss: np.ndarray, taa: np.ndarray, m3di: np.ndarray,
                 aasc: np.ndarray, device: torch.device | str):
        self.device = _device(device)
        for name, a, tab in (("query 3Di", qss, m3di),
                             ("query amino-acid", qaa, aasc),
                             ("target 3Di", tss, m3di),
                             ("target amino-acid", taa, aasc)):
            _check_tokens(name, a, tab.shape[0])
        (self.qss, self.qaa, self.qbias, self.tss, self.taa, self.m3di,
         self.aasc) = (_upload(a, dt, self.device) for a, dt in (
             (qss, np.uint8), (qaa, np.uint8), (qbias, np.int8),
             (tss, np.uint8), (taa, np.uint8), (m3di, np.int8),
             (aasc, np.int8)))
        self._init_state()

    def _resident(self) -> tuple:
        return (self.qss, self.qaa, self.qbias, self.tss, self.taa,
                self.m3di, self.aasc)


class ProfileDeviceDB(DeviceAlignDB):
    """Resident arrays of profile queries: qprof, the queries' int8
    alignment profiles as a (n, PROF_COLS) array whose row k belongs to
    query element k (the same offsets as the query tokens), and tdata,
    the uint8 target tokens (0-20).  The profile kernels score the
    stages; there is no bias."""

    CELL = "prof"

    def __init__(self, qprof: np.ndarray, tdata: np.ndarray,
                 device: torch.device | str):
        self.device = _device(device)
        if qprof.dtype != np.int8 or qprof.ndim != 2 \
                or qprof.shape[1] != PROF_COLS:
            raise ValueError(f"query profiles must be an int8 (n, "
                             f"{PROF_COLS}) array")
        _check_tokens("target", tdata, PROF_COLS)
        self.qprof = _upload(qprof.reshape(-1), np.int8, self.device)
        self.tdata = _upload(tdata, np.uint8, self.device)
        self._init_state()

    def _target_alphabet(self) -> int:
        return PROF_COLS

    def _resident(self) -> tuple:
        return (self.qprof, self.tdata)
