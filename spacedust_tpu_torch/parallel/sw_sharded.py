"""Target-sharded batched Smith-Waterman: the port of the JAX package's
`parallel/sw_sharded.py` (the `shard_map` of the SW over a `targets`
mesh axis, `_sharded_bucket_fn`, and its `all_gather`).

Each shard keeps only its own contiguous slice of the target tokens
resident, addressed by shard-local offsets (the reference's target-split
mode keeps one split's index per MPI rank, Prefiltering.cpp:575-722);
the query tokens, their bias and the matrix are resident once a device
and serve every shard on it.  A stage is one launch a card over all of
that card's shards (`ops/sw_cuda.py::sw_forward_shards` /
`sw_reverse_shards`): the jobs carry their shard, whose base pointer the
kernels read from the card's table (`ShardTargets`), sorted longest
first across the shards; the few pairs that would outlast an even share
of the stage take the block path, a block of warps a pair, launched
first on a side stream (`sw_cuda.shard_plan`).  Each card's launches go
on its current stream, which waits for the side stream once; a stage's
events bracket all cards.  A sharded search gives the single engine's
records.  On the CPU the plain version scores each job against its
shard (`ops/sw.py::sw_shards_jobs_ref`).

A mesh is a plain list of torch devices, one a shard (`make_mesh`): shards
may share a card.

`ShardedAlignDB` serves two callers:
  * `run_grid` / `gather_scores`, the JAX interface: a (D, B) grid of
    (qoff, qlen, shard-local toff, tlen, terminate), one row a shard, and
    the per-shard result blocks gathered to the host in shard order;
  * `enqueue` / `flush` / `collect` / `run_buckets` / `with_targets`, the
    interface of `DeviceAlignDB` that `search/alignment.py` streams
    through, with global target offsets: a stage's jobs are routed to
    the shard their target lies in and every result goes back under its
    job's position (parallel/pipeline.py::ShardedAlignmentEngine).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import sw_cuda
from ..ops.sw_engine import StageBuffer, _check_tokens, _device, _upload
from ..utils import trace
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


class ShardedAlignDB(StageBuffer):
    """Resident arrays of a target-sharded SW: query tokens, bias and
    matrix once a device, target shard d (tokens tok_bounds[d] of tdata)
    on devices[d]."""

    def __init__(self, devices: list, qdata: np.ndarray, qbias: np.ndarray,
                 tdata: np.ndarray, tok_bounds: list[tuple[int, int]],
                 sub: np.ndarray):
        """tok_bounds: per-shard [start, end) ranges into `tdata` (token
        positions, one entry a device of `devices`)."""
        devices = [_device(_card(d)) for d in devices]
        if len(tok_bounds) != len(devices):
            raise ValueError(f"{len(tok_bounds)} shards for "
                             f"{len(devices)} devices")
        for name, a in (("query", qdata), ("target", tdata)):
            _check_tokens(name, a, sub.shape[0])
        queries = {dev: tuple(_upload(a, dt, dev) for a, dt in (
            (qdata, np.uint8), (qbias, np.int8), (sub, np.int8)))
            for dev in dict.fromkeys(devices)}
        self._setup(devices, queries, tdata, tok_bounds)

    def _setup(self, devices: list, queries: dict, tdata: np.ndarray,
               tok_bounds: list[tuple[int, int]]) -> None:
        """Upload each shard's targets; group the shards by card."""
        self.devices = devices
        self.queries = queries         # device -> (qdata, qbias, sub)
        self.tparts = [_upload(tdata[s:e], np.uint8, dev)
                       for dev, (s, e) in zip(devices, tok_bounds)]
        self.tok_starts = np.array([s for s, _ in tok_bounds], dtype=np.int64)
        self.tok_ends = np.array([e for _, e in tok_bounds], dtype=np.int64)
        self.cards = list(dict.fromkeys(devices))
        self.card_of = np.array([self.cards.index(d) for d in devices])
        # each shard's index among its card's shards (the jobs' shard row)
        self.local = np.zeros(len(devices), dtype=np.int64)
        self.targets = []
        for c in range(len(self.cards)):
            ds = np.nonzero(self.card_of == c)[0]
            self.local[ds] = np.arange(len(ds))
            self.targets.append(sw_cuda.ShardTargets(
                [self.tparts[d] for d in ds]))
        for dev in self.cards:
            if dev.type == "cuda":
                # build and load the kernels now, outside every timed stage
                sw_cuda.load(dev)
        self._buf: dict[tuple, list] = {}
        nd, nc = len(devices), len(self.cards)
        self._metrics = {"n_batches": 0, "stages": 0, "stage_wall_ms": 0.0}
        for d in ("fwd", "rev"):
            self._metrics.update({
                f"{d}_launches": 0, f"{d}_pairs": 0, f"{d}_cells": 0,
                f"{d}_kernel_ms": 0.0, f"{d}_wrapper_ms": 0.0,
                f"shard_{d}_pairs": [0] * nd,
                f"card_{d}_launches": [0] * nc,
                f"card_{d}_block_pairs": [0] * nc,
                f"card_{d}_kernel_ms": [0.0] * nc})

    @property
    def n_shards(self) -> int:
        return len(self.tparts)

    def resident(self, d: int) -> tuple:
        """Shard d's resident arrays as the single engine's wrappers take
        them: (qdata, qbias, its target tokens, sub)."""
        qdata, qbias, sub = self.queries[self.devices[d]]
        return (qdata, qbias, self.tparts[d], sub)

    def _launch(self, c: int, jobs: np.ndarray, gap_open: int,
                gap_extend: int, reverse: bool, events: dict | None = None):
        """Card c's stage: (6, n) jobs (qoff, qlen, shard-local toff,
        tlen, terminate, shard within the card) through the sharded
        wrapper of the direction, launches counted a card."""
        qdata, qbias, sub = self.queries[self.cards[c]]
        wrapper = (sw_cuda.sw_reverse_shards if reverse
                   else sw_cuda.sw_forward_shards)
        events = {} if events is None else events
        out = wrapper(qdata, qbias, self.targets[c], sub,
                      np.ascontiguousarray(jobs), gap_open, gap_extend,
                      events=events)
        d = "rev" if reverse else "fwd"
        launched = (events.get("warp_launches", 0)
                    + events.get("block_launches", 0))
        self._metrics[f"card_{d}_launches"][c] += launched
        self._metrics[f"{d}_launches"] += launched
        return out

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
        B = grid.shape[2]
        res = np.zeros((6, self.n_shards, B), dtype=np.int32)
        outs = []
        for c in range(len(self.cards)):
            ds = np.nonzero(self.card_of == c)[0]
            jobs = np.concatenate([grid[:, ds].reshape(5, -1),
                                   np.repeat(self.local[ds], B)[None]])
            outs.append((ds, self._launch(c, jobs, gap_open, gap_extend,
                                          reverse)))
        for ds, o in outs:
            res[:, ds] = o.cpu().numpy().reshape(6, len(ds), B)
        rows = (0, 4, 5, 3) if reverse else (0, 1, 2)
        return tuple(res[i] for i in rows)

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
        a shard a slice, with pointer tables of its own) that shares this
        one's resident query arrays.  `starts`: the ascending start
        offsets of tdata's targets; the shards are cut there,
        residue-balanced."""
        sub = self.queries[self.devices[0]][2]
        _check_tokens("target", tdata, sub.shape[0])
        n = len(tdata)
        starts = np.asarray(starts, dtype=np.int64)
        lens = np.diff(np.concatenate((starts, [n])))
        cuts = [int(s) for s, _ in residue_balanced_splits(
            lens, self.n_shards)] + [len(starts)]
        bounds = [(int(starts[a]) if a else 0,
                   int(starts[b]) if b < len(starts) else n)
                  for a, b in zip(cuts, cuts[1:])]
        view = ShardedAlignDB.__new__(ShardedAlignDB)
        devices = self.devices[:len(bounds)]
        view._setup(devices, {d: self.queries[d] for d in devices}, tdata,
                    bounds)
        return view

    def _dispatch(self, cols, gap_open: int, gap_extend: int,
                  reverse: bool):
        """The stage: each job routed to the shard its target lies in
        (offsets made shard-local), each card's jobs sorted longest first
        across its shards and launched at once."""
        cols = [c.astype(np.int64) for c in cols]
        shard = np.searchsorted(self.tok_starts, cols[2], side="right") - 1
        jobs = np.stack(cols[:5])
        jobs[2] -= self.tok_starts[shard]
        cells = jobs[1] * jobs[3]
        d = "rev" if reverse else "fwd"
        m = self._metrics
        cuda = [c for c in self.cards if c.type == "cuda"]
        ev = None
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(torch.cuda.current_stream(cuda[0]))
        parts = []
        for c, dev in enumerate(self.cards):
            sel = np.nonzero(self.card_of[shard] == c)[0]
            if len(sel) == 0:
                continue
            sel = sel[np.argsort(-cells[sel])]
            part = np.empty((6, len(sel)), dtype=np.int64)
            part[:5] = jobs[:, sel]
            part[5] = self.local[shard[sel]]
            events: dict | None = None
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                events = {"wrapper": (torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True))}
                events["wrapper"][0].record(stream)
            out = self._launch(c, part, gap_open, gap_extend, reverse,
                               events)
            if events is not None:
                events["wrapper"][1].record(stream)
                m[f"card_{d}_block_pairs"][c] += events["n_long"]
            m["n_batches"] += 1
            parts.append((c, cols[5][sel], out, events))
        for k, n_k in enumerate(np.bincount(shard, minlength=self.n_shards)):
            m[f"shard_{d}_pairs"][k] += int(n_k)
        m[f"{d}_pairs"] += len(shard)
        m[f"{d}_cells"] += int(cells.sum())
        for other in cuda[1:]:
            # the stage ends on the first card once every card's work has
            # ended
            torch.cuda.current_stream(cuda[0]).wait_stream(
                torch.cuda.current_stream(other))
        if ev is not None:
            ev[1].record(torch.cuda.current_stream(cuda[0]))
        m["stages"] += 1
        return (parts, ev, d)

    def collect(self, pending):
        """Fetch every pending stage, one device-to-host copy a card.
        Returns (positions, (score, t_end, q_end, found, fj, fi)) per card
        and stage, positions the jobs' own."""
        if not pending:
            return []
        by_card: dict[int, list] = {}
        for parts, _ev, _d in pending:
            for part in parts:
                by_card.setdefault(part[0], []).append(part)
        out = []
        with trace.span("sw.fetch"):
            for c in sorted(by_card):
                flat = torch.cat([o for _c, _p, o, _e in by_card[c]],
                                 dim=1).cpu().numpy()
                col = 0
                for _c, pos, o, _e in by_card[c]:
                    n = o.shape[1]
                    out.append((pos, tuple(flat[i, col:col + n]
                                           for i in range(6))))
                    col += n
        m = self._metrics
        for parts, ev, d in pending:
            for c, _pos, _o, events in parts:
                if events is None:
                    continue
                m[f"{d}_wrapper_ms"] += _ms(events["wrapper"])
                ms = _ms(events["card"])
                m[f"{d}_kernel_ms"] += ms
                m[f"card_{d}_kernel_ms"][c] += ms
            if ev is not None:
                # the cards fetched above need not include the one whose
                # stream recorded the stage's events
                ev[1].synchronize()
                m["stage_wall_ms"] += _ms(ev)
        return out

    @property
    def metrics(self) -> dict:
        """The engine's metrics: those of DeviceAlignDB over all cards
        (launches, pairs, cells, kernel and wrapper ms a direction), the
        stages dispatched and their wall ms on the card (from before a
        stage is routed and planned to the end of every card's work), each
        shard's pairs (`shard_{fwd,rev}_pairs`), and each card's launches,
        block-path pairs and kernel ms (`card_{fwd,rev}_*`: CUDA events
        from before the card's fork to after its join)."""
        out = {k: list(v) if isinstance(v, list) else v
               for k, v in self._metrics.items()}
        out["shards"] = self.n_shards
        out["cards"] = len(self.cards)
        return out


def _ms(ev: tuple) -> float:
    return ev[0].elapsed_time(ev[1])
