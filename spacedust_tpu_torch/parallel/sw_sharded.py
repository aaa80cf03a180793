"""Target-sharded batched Smith-Waterman: the port of the JAX package's
`parallel/sw_sharded.py` (the `shard_map` of the SW over a `targets`
mesh axis, `_sharded_bucket_fn`, and its `all_gather`).

Each shard keeps only its own contiguous slice of the target tokens
resident, addressed by shard-local offsets (the reference's target-split
mode keeps one split's index per MPI rank, Prefiltering.cpp:575-722);
the query tokens and their bias are resident once a device and shared by
every shard on it (`ops/sw_engine.py::DeviceAlignDB.with_targets`).  A
shard scores only the pairs whose targets lie in it, with the same kernels
as the single engine (`csrc/sw.cu::sw_forward` / `sw_reverse`, one launch
a shard and stage), so a sharded search gives the single engine's records.

A mesh is a plain list of torch devices, one a shard (`make_mesh`): shards
may share a card.  On CUDA every shard launches on a stream of its own,
so that the shards of one card overlap; a stage starts after the work
already queued on the device's current stream and that stream waits for
every shard's stream once, when the stage has been dispatched.  On the CPU
the shards run the kernels' plain version one after another.

`ShardedAlignDB` serves two callers:
  * `run_grid` / `gather_scores`, the JAX interface: a (D, B) grid of
    (qoff, qlen, shard-local toff, tlen, terminate), one row a shard, and
    the per-shard result blocks gathered to the host in shard order;
  * `enqueue` / `flush` / `collect` / `run_buckets` / `with_targets`, the
    interface of `DeviceAlignDB` that `search/alignment.py` streams
    through, with global target offsets: a stage's jobs are split by the
    shard their target lies in and every result goes back under its job's
    position (parallel/pipeline.py::ShardedAlignmentEngine).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import sw_cuda
from ..ops.sw_engine import DISPATCH_PAIRS, DeviceAlignDB
from .split import residue_balanced_splits


def _card(device: torch.device) -> torch.device:
    """`device` with the current card's index where it names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n: int | None = None, device: torch.device | str = "cuda",
              first: int = 0) -> list[torch.device]:
    """The devices of n shards.  `device` without an index ("cuda") deals
    the shards round-robin over the visible cards, starting at card
    `first` (one card: every shard on it; n defaults to the card count);
    any other device (an indexed card, "cpu") holds all n (default 1)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("device cuda requested but no CUDA card is "
                               "visible")
        n = n or count
        return [torch.device("cuda", (first + i) % count) for i in range(n)]
    return [device] * (n or 1)


class ShardedAlignDB:
    """Resident arrays of a target-sharded SW: query tokens and bias once a
    device, target shard d (tokens tok_bounds[d] of tdata) on devices[d]."""

    CELL = "seq"

    def __init__(self, devices: list, qdata: np.ndarray, qbias: np.ndarray,
                 tdata: np.ndarray, tok_bounds: list[tuple[int, int]],
                 sub: np.ndarray):
        """tok_bounds: per-shard [start, end) ranges into `tdata` (token
        positions, one entry a device of `devices`)."""
        devices = [_card(d) for d in devices]
        if len(tok_bounds) != len(devices):
            raise ValueError(f"{len(tok_bounds)} shards for "
                             f"{len(devices)} devices")
        base: dict = {}
        shards = []
        for dev, (s, e) in zip(devices, tok_bounds):
            if dev not in base:
                base[dev] = DeviceAlignDB(qdata, qbias, tdata[s:e], sub,
                                          device=dev)
                shards.append(base[dev])
            else:
                shards.append(base[dev].with_targets(tdata[s:e]))
        self._setup(devices, shards, tok_bounds)

    def _setup(self, devices: list, shards: list,
               tok_bounds: list[tuple[int, int]]) -> None:
        self.devices = devices
        self.shards = shards
        self.tok_starts = np.array([s for s, _ in tok_bounds], dtype=np.int64)
        self.tok_ends = np.array([e for _, e in tok_bounds], dtype=np.int64)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in devices]
        self._buf: dict[tuple, list] = {}
        self._stages = {"stages": 0, "stage_wall_ms": 0.0}

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _on(self, d: int):
        s = self.streams[d]
        return torch.cuda.stream(s) if s is not None else \
            contextlib.nullcontext()

    def _follow(self, d: int) -> None:
        """Shard d's next work follows what its device already queued
        (the resident arrays' uploads among it)."""
        s = self.streams[d]
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(s.device))

    # ------------------------------------------------------ the JAX grid
    def run_grid(self, bucket: tuple[int, int], qoff, qlen, toff, tlen,
                 term, gap_open: int, gap_extend: int, reverse: bool):
        """qoff..term: (D, B) int arrays, row d for shard d, toff
        shard-local; `bucket` is the JAX package's (Lq, Lt) length bucket
        and is not needed here (the kernels take any length).  Returns the
        result tuple as numpy (D, B) int32 arrays: (score, t_end, q_end)
        forward, (score, fj, fi, found) reverse, as sw_scan_core's."""
        grid = np.stack([np.asarray(a, dtype=np.int64)
                         for a in (qoff, qlen, toff, tlen, term)])
        if grid.shape[1] != self.n_shards:
            raise ValueError(f"a grid of {grid.shape[1]} rows for "
                             f"{self.n_shards} shards")
        rows = (0, 4, 5, 3) if reverse else (0, 1, 2)
        name = sw_cuda.ENTRY[reverse, self.CELL][0]
        outs = []
        for d, shard in enumerate(self.shards):
            self._follow(d)
            with self._on(d):
                outs.append(getattr(sw_cuda, name)(
                    *shard._resident(), np.ascontiguousarray(grid[:, d]),
                    gap_open, gap_extend))
        res = []
        for d, o in enumerate(outs):
            with self._on(d):
                res.append(o.cpu().numpy())
        return tuple(np.stack([r[i] for r in res]) for i in rows)

    def gather_scores(self, scores) -> np.ndarray:
        """The per-shard score blocks (a (D, B) array, or one tensor or
        array a shard, on any device) on the host in shard order, as one
        (D * B,) array: the all-gather of the JAX package within one
        process."""
        blocks = [b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
                  for b in scores]
        return np.concatenate([b.reshape(-1) for b in blocks])

    # ------------------------------------------- the DeviceAlignDB stream
    def with_targets(self, tdata: np.ndarray,
                     starts: np.ndarray) -> "ShardedAlignDB":
        """A sharded engine over the target tokens `tdata` (uploaded now,
        a shard a slice) that shares this one's resident query arrays.
        `starts`: the ascending start offsets of tdata's targets; the
        shards are cut there, residue-balanced."""
        n = len(tdata)
        starts = np.asarray(starts, dtype=np.int64)
        lens = np.diff(np.concatenate((starts, [n])))
        cuts = [int(s) for s, _ in residue_balanced_splits(
            lens, self.n_shards)] + [len(starts)]
        bounds = [(int(starts[a]) if a else 0,
                   int(starts[b]) if b < len(starts) else n)
                  for a, b in zip(cuts, cuts[1:])]
        view = ShardedAlignDB.__new__(ShardedAlignDB)
        view._setup(self.devices[:len(bounds)],
                    [self.shards[d].with_targets(tdata[s:e])
                     for d, (s, e) in enumerate(bounds)], bounds)
        return view

    def enqueue(self, jobs, gap_open: int, gap_extend: int,
                reverse: bool):
        """Buffer jobs ((qoff, qlen, toff, tlen, term, positions) arrays,
        toff global) and dispatch the buffer as one stage once it holds
        DISPATCH_PAIRS pairs.  Returns the stages dispatched now."""
        key = (gap_open, gap_extend, reverse)
        buf = self._buf.setdefault(key, [])
        for job in jobs:
            buf.append(tuple(np.asarray(c) for c in job))
        if sum(len(b[0]) for b in buf) >= DISPATCH_PAIRS:
            return self.flush(gap_open, gap_extend, reverse)
        return []

    def flush(self, gap_open: int, gap_extend: int, reverse: bool):
        """Dispatch whatever is buffered for this direction: each shard
        its own pairs, at shard-local target offsets, on its stream."""
        buf = self._buf.pop((gap_open, gap_extend, reverse), [])
        if not buf or sum(len(b[0]) for b in buf) == 0:
            return []
        cols = [np.concatenate([b[i] for b in buf]).astype(np.int64)
                for i in range(6)]
        shard = np.searchsorted(self.tok_starts, cols[2], side="right") - 1
        cards = list(dict.fromkeys(d for d in self.devices
                                   if d.type == "cuda"))
        ev = None
        if cards:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(torch.cuda.current_stream(cards[0]))
        parts = []
        for d, db in enumerate(self.shards):
            sel = np.nonzero(shard == d)[0]
            if len(sel) == 0:
                continue
            part = [c[sel] for c in cols]
            part[2] = part[2] - self.tok_starts[d]
            self._follow(d)
            with self._on(d):
                parts.append((d, db._dispatch(part, gap_open, gap_extend,
                                              reverse)))
        # the one synchronisation of the stage: each card's current stream
        # waits for its shards' streams
        for d, stream in enumerate(self.streams):
            if stream is not None:
                torch.cuda.current_stream(stream.device).wait_stream(stream)
                if stream.device != cards[0]:
                    torch.cuda.current_stream(cards[0]).wait_stream(stream)
        if ev is not None:
            ev[1].record(torch.cuda.current_stream(cards[0]))
        self._stages["stages"] += 1
        return [(parts, ev)]

    def collect(self, pending):
        """Fetch every pending stage, one device-to-host copy a shard.
        Returns (positions, (score, t_end, q_end, found, fj, fi)) per
        shard and stage, positions the jobs' own."""
        if not pending:
            return []
        by_shard: dict[int, list] = {}
        for parts, _ev in pending:
            for d, stage in parts:
                by_shard.setdefault(d, []).append(stage)
        out = []
        for d in sorted(by_shard):
            out += self.shards[d].collect(by_shard[d])
        for _parts, ev in pending:
            if ev is not None:
                # the shards fetched above need not include one on the
                # card whose stream recorded the events
                ev[1].synchronize()
                self._stages["stage_wall_ms"] += ev[0].elapsed_time(ev[1])
        return out

    def run_buckets(self, jobs, gap_open: int, gap_extend: int,
                    reverse: bool):
        """enqueue + flush + collect for one direction."""
        return self.collect(self.enqueue(jobs, gap_open, gap_extend, reverse)
                            + self.flush(gap_open, gap_extend, reverse))

    @property
    def metrics(self) -> dict:
        """The shards' engine metrics summed, each shard's launches, pairs
        and kernel ms (`shard_*`), the stages dispatched and their wall ms
        on the card (from before the first shard's launch to the end of
        the last shard's work)."""
        ms = [db.metrics for db in self.shards]
        out = {k: sum(m[k] for m in ms) for k in ms[0]}
        out.update(self._stages)
        out["shards"] = self.n_shards
        for d in ("fwd", "rev"):
            for k in ("launches", "pairs", "kernel_ms"):
                out[f"shard_{d}_{k}"] = [m[f"{d}_{k}"] for m in ms]
        return out
