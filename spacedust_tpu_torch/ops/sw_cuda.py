"""Hand-written Hopper kernels for the SW score passes, and their wrappers.

`csrc/sw.cu` holds one CUDA DP body (see the note at its top): a warp
owns a pair and sweeps it as an anti-diagonal wavefront.  `sw_forward`
replaces the JAX package's `ops/sw_pallas.py::_kernel_rowmax` and
`sw_reverse` its `ops/sw_pallas.py::_kernel`; `sw_forward_struct` /
`sw_reverse_struct` replace the structure-mode XLA program
`ops/sw_engine.py::_sw_bucket_struct` (two score channels, 3Di with its
bias and amino acids, each cast to int8 before the sum);
`sw_forward_prof` / `sw_reverse_prof` replace the profile-query programs
`ops/sw.py::sw_forward_from_profiles` / `sw_reverse_from_profiles` (the
cell score read from a per-position int8 profile of 21 columns).  All six
take over `ops/sw_engine.py::panel_gather` as their own load stage.  The
source is compiled with nvcc for sm_90a at first use into `_build/`
beside the package (git-ignored) and bound through a plain C interface
with ctypes.

The wrappers take the resident device arrays, the substitution matrix and
a host (5, n) int64 job array (qoff, qlen, toff, tlen, terminate) and
return a (6, n) int32 tensor (score, t_end, q_end, found, fj, fi) on the
device of the resident arrays, pair p in column p whatever order the
kernels take the pairs in.  For CUDA tensors they plan the stage
(`shard_plan`) and launch it (`launch`) on the current stream; nothing
is synchronised.  For CPU tensors they run the plain version
(`ops/sw.py::sw_jobs_ref` / `sw_struct_jobs_ref` / `sw_prof_jobs_ref`).
There is no fallback between the two.  The structure wrappers take five
resident arrays (3Di and amino-acid tokens of the queries with the int8
3Di bias, and of the targets) and the two int8 tables in place of (qdata,
qbias, tdata, sub); the profile wrappers take two, the queries' profile
rows as one flat int8 array (21 values a residue, row-major, at the
element offsets of the jobs) and the target tokens.

`sw_forward_shards` / `sw_reverse_shards` run the target-sharded stage of
one card (B8, the JAX package's `parallel/sw_sharded.py::
_sharded_bucket_fn`): jobs from all of the card's shards in one table
with a sixth row, the job's shard, each shard's target tokens resident on
their own (`ShardTargets`: the tensors and the device array of their base
pointers that the kernels read).  For CPU tensors they run `ops/sw.py::
sw_shards_jobs_ref`.

Every stage is one of four cells ("seq": the single engine's sequence
stages, "struct", "prof", "shards": a card's sharded stage), and ENTRIES
names, for each cell and direction, the C entry point of its warp kernel
(and wrapper) and that of its block path, or None.  One planner serves
them all: `shard_plan` gives each pair one of the kernel's compile-time
classes of query rows per lane (LANE_ROWS, `lane_rows`) and its place in
the boundary scratch, in one launch unless the scratch would pass
SCRATCH_BYTES; where the cell has a block path, a pair whose one-warp
lane-steps exceed the stage's even share of the card's warps
(`card_warps`) goes to it (a block of BLOCK_WARPS warps a pair).  A stage
of one target array is one shard: the sequence cell's block path reads
its targets through a one-tensor ShardTargets.  The struct stages and the
profile forward stage have no block path and are never split.  One
launcher runs every plan: the block path first on a side stream of the
card, the rest on the current stream, which waits for the side stream
once.

Every launch goes to the card of its tensors: the launcher enters that
card (`torch.cuda.device`) round its C calls, records its events on its
current stream, and `load(device)` readies the kernels on each card once.

LAUNCHES counts kernel launches by C entry point.  A caller that wants a
call's own counts or the kernels' own time passes a dict as `events`:
the launcher puts there its warp and block launches ("warp_launches",
"block_launches"), the block path's pairs ("n_long") and, under "card",
one (start, end) pair of CUDA events recorded round its launches, after
the job table is on the card and every buffer is allocated, so that
neither the host planning nor that copy lies between them (from before
the fork to after the join where a stage takes the block path; see
`launch` for the keys it adds); nothing is recorded for CPU tensors.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from .sw import (PROF_COLS, sw_jobs_ref, sw_prof_jobs_ref,
                 sw_shards_jobs_ref, sw_struct_jobs_ref)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sw.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SCRATCH_BYTES = 1 << 30        # per-launch DP scratch bound
# the compile-time classes of query rows per lane (a strip is 32 lanes x R
# rows), and what a wavefront step costs beside its R cells (shuffles, the
# chunk feed, the loop), in cells.  Fitted on an H100 to the times of one
# stage with every pair forced into each class (chip_smoke.py::
# stage_detail: time / lane-steps against R by least squares, intercept
# over slope): 3.2-3.4 on the sequence forward stage and 4.8-5.4 on its
# far smaller reverse stage; 3.0-3.2 on the structure reverse stage and
# 1.5-1.6 on the structure forward stage, which is not linear in R (a row
# costs more at 16 rows a lane than at 8).  One constant serves all six
# kernels (the profile kernels' fit is printed by the same phase).
LANE_ROWS = (4, 8, 12, 16)
STEP_OVERHEAD_CELLS = 3
# bytes of boundary scratch per target column of a multi-strip pair, by
# direction (reverse?): (H, F), and the column max with its row
WARP_SCRATCH = {False: 8, True: 16}

# the block path (B8, the single engine's sequence stages and the
# profile reverse stage): the warps an SM runs at once on the sequence
# and profile warp kernels (4 blocks of 4 warps; `card_warps` multiplies
# by the card's SMs), and the warps of a block, the one width csrc/sw.cu
# compiles (see its note on W)
SM_WARPS = 16
BLOCK_WARPS = 16

# (cell, reverse?) -> the C entry point of the stage's warp kernel (and
# its wrapper's name) and that of its block path, or None: such a stage
# is never split
ENTRIES = {("seq", False): ("sw_forward", "sw_forward_shards_block"),
           ("seq", True): ("sw_reverse", "sw_reverse_shards_block"),
           ("struct", False): ("sw_forward_struct", None),
           ("struct", True): ("sw_reverse_struct", None),
           ("prof", False): ("sw_forward_prof", None),
           ("prof", True): ("sw_reverse_prof", "sw_reverse_prof_block"),
           ("shards", False): ("sw_forward_shards",
                               "sw_forward_shards_block"),
           ("shards", True): ("sw_reverse_shards",
                              "sw_reverse_shards_block")}
# C entry point -> its launches so far
LAUNCHES: collections.Counter = collections.Counter()

_LIB = None
_LOCK = threading.Lock()
_LOADED: set = set()            # the card indices the kernels are loaded on
_SIDE: dict = {}                # card index -> the block path's side stream


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the SW kernels need the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile csrc/sw.cu (content-hashed) and return the library path."""
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libsw_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        res = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{res.stderr}")
        if verbose:
            print(res.stderr, end="")
        tmp.rename(out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface's argument and result types."""
    p = ctypes.c_void_p
    i, ll = ctypes.c_int, ctypes.c_longlong
    # ..., jobs, job_stride, n, go, ge, scratch, out, out_stride, stream
    for fn in (lib.sw_forward_struct, lib.sw_reverse_struct):
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, p, i, p, i,
                       p, ll, i, i, i, p, p, ll, p]
    for fn in (lib.sw_forward, lib.sw_reverse, lib.sw_forward_shards,
               lib.sw_reverse_shards, lib.sw_forward_shards_block,
               lib.sw_reverse_shards_block):
        fn.restype = i
        fn.argtypes = [p, p, p, p, i, p, ll, i, i, i, p, p, ll, p]
    for fn in (lib.sw_forward_prof, lib.sw_reverse_prof,
               lib.sw_reverse_prof_block):
        fn.restype = i
        fn.argtypes = [p, p, p, ll, i, i, i, p, p, ll, p]
    lib.sw_load.restype = i
    return lib


def _card_index(device) -> int:
    """The index of a card (a torch device, its name or index; None or
    "cuda" without an index: the current card)."""
    if isinstance(device, int):
        return device
    if device is not None:
        device = torch.device(device)
        if device.index is not None:
            return device.index
    return torch.cuda.current_device()


def load(device=None) -> ctypes.CDLL:
    """Build and bind the kernels (once), and ready the card of `device`
    (None: the current card) unless it is ready: load the kernels onto it,
    make its side stream of the block path and launch torch's gather of
    a split stage's results once, so that no later launch on it (or
    whatever times one) pays for any of it.  Raises on the card's CUDA
    error."""
    global _LIB
    index = _card_index(device)
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        if index not in _LOADED:
            with torch.cuda.device(index):
                rc = _LIB.sw_load()
                if rc != 0:
                    raise RuntimeError(f"loading the SW kernels on "
                                       f"cuda:{index} failed: CUDA error {rc}")
                # high priority, so that the long pairs' blocks are
                # dispatched ahead of the short launch's
                _SIDE[index] = torch.cuda.Stream(index, priority=-1)
                # and the gather that hands a split stage's results back
                # in the caller's order (`launch`): torch loads a
                # kernel at its first launch, which fell in the first
                # stage that took the block path (on an H100 that stage's
                # wrapper took 23-30 ms at first use, 5-6 ms after this)
                dev = torch.device("cuda", index)
                torch.empty((6, 2), dtype=torch.int32, device=dev)[
                    :, torch.tensor([1, 0], dtype=torch.int64, device=dev)]
            _LOADED.add(index)
    return _LIB


def card_warps(device) -> int:
    """The warps the card of `device` runs at once on the warp kernels:
    its SMs x SM_WARPS (the long-pair rule's even share, `shard_plan`)."""
    props = torch.cuda.get_device_properties(_card_index(device))
    return props.multi_processor_count * SM_WARPS


def lane_rows(qlen: np.ndarray) -> np.ndarray:
    """Per pair, the class of LANE_ROWS that sweeps its query in the
    fewest lane-steps: ceil(qlen / 32R) strips, each step costing R cells
    and STEP_OVERHEAD_CELLS; ties go to the larger class.  (Looked up in
    a table over 0 .. max(qlen) when that is shorter than the batch.)"""
    qlen = np.asarray(qlen, dtype=np.int64)
    top = int(qlen.max(initial=0))
    if top + 1 < len(qlen):
        return lane_rows(np.arange(top + 1))[qlen]
    classes = np.array(LANE_ROWS[::-1], dtype=np.int64)[:, None]
    cost = -(-qlen[None, :] // (32 * classes)) * (classes
                                                 + STEP_OVERHEAD_CELLS)
    return classes[np.argmin(cost, axis=0), 0]


def _scratch_launches(table: np.ndarray, bytes_per_column: int,
                      budget: int) -> list[tuple[int, int, int]]:
    """The warp kernel's launches (start, end, scratch columns) over a
    table whose rows 0-5 are filled (a view will do), and its row 6: only
    a pair longer than one strip (qlen > 32 * rows) takes scratch, one
    column per target residue, from its row-6 column of its launch's
    scratch on; the pairs are split where a launch's scratch would pass
    `budget` bytes (a lone pair may exceed it)."""
    n = table.shape[1]
    cols = np.where(table[1] > 32 * table[5], table[3], 0)
    cum = np.concatenate(([0], np.cumsum(cols)))
    limit = budget // bytes_per_column
    launches = []
    s = 0
    while s < n:
        fit = int(np.searchsorted(cum, cum[s] + limit, side="right")) - 1
        e = max(fit, s + 1)
        table[6, s:e] = cum[s:e] - cum[s]
        launches.append((s, e, int(cum[e] - cum[s])))
        s = e
    return launches


def block_rows(qlen: np.ndarray) -> np.ndarray:
    """Per pair of the block path, the class of LANE_ROWS that sweeps its
    query soonest on BLOCK_WARPS warps: ceil(ceil(qlen / 32R) /
    BLOCK_WARPS) strips a warp, each step costing R cells and
    STEP_OVERHEAD_CELLS (a smaller R gives more strips to share); ties go
    to the larger class."""
    qlen = np.asarray(qlen, dtype=np.int64)
    classes = np.array(LANE_ROWS[::-1], dtype=np.int64)[:, None]
    strips = -(-qlen[None, :] // (32 * classes))
    cost = -(-strips // BLOCK_WARPS) * (classes + STEP_OVERHEAD_CELLS)
    return classes[np.argmin(cost, axis=0), 0]


@dataclasses.dataclass
class ShardPlan:
    """The launches of a stage.  table: the (8, n) rows the kernels read
    (qoff, qlen, toff, tlen, terminate, rows, soff, shard), its columns
    in launch order: the n_long pairs of the block path, then the short
    pairs; perm[c]: the caller's job of column c (None: the caller's
    order); long_cols: the block path's ring columns (two slots of tlen
    for each pair longer than one strip), soff counting them from 0;
    launches: the short pairs' launches (start, end, scratch columns)
    over the table's columns, as _scratch_launches cuts them."""
    table: np.ndarray
    perm: np.ndarray | None
    n_long: int
    long_cols: int
    launches: list

    @property
    def order(self) -> np.ndarray:
        """The caller's job of each column."""
        return (np.arange(self.table.shape[1]) if self.perm is None
                else self.perm)


def shard_plan(jobs: np.ndarray, cell: str, reverse: bool,
               force: bool | None = None, rows: int | None = None,
               budget: int = SCRATCH_BYTES, *, card_warps: int) -> ShardPlan:
    """Plan a stage of `cell` (ENTRIES) in the direction: (5, n) jobs
    (qoff, qlen, toff, tlen, terminate) over one target array, which is
    shard 0, or a card's sharded (6, n) jobs whose sixth row is the job's
    shard.  Where the cell has a block path, a pair goes to it when its
    one-warp lane-steps ceil(qlen / 32R) * (tlen + 31) (R its lane_rows
    class) exceed the stage's total over `card_warps` (the card's,
    `card_warps()`): it would outlast an even share of the stage.  So does
    a pair of one strip, which the block sweeps no sooner: kept on the
    warp kernel, such pairs of long targets start late in the short launch
    and lengthen it (timed on an H100, PERF.md).  There its class is
    block_rows(qlen).  A cell without a block path plans no long pairs
    and keeps the caller's order.  The checks pass `force` (True: every
    pair to the block path, False: none) and `rows` (one class for every
    pair); the wrappers leave both."""
    if ENTRIES[cell, reverse][1] is None:
        if force:
            raise ValueError(f"the {cell} stage has no block path")
        force = False
    n = jobs.shape[1]
    one = lane_rows(jobs[1]) if rows is None else np.full(n, rows)
    if force is not None:
        long = np.full(n, force)
    else:
        steps = -(-jobs[1] // (32 * one)) * (jobs[3] + 31)
        long = steps * card_warps > steps.sum()
    li = np.nonzero(long)[0]
    nl = len(li)
    # the caller's order when the long pairs lead it (as a stage sorted
    # longest first mostly has them)
    perm = (None if (li == np.arange(nl)).all()
            else np.concatenate([li, np.nonzero(~long)[0]]))
    table = np.empty((8, n), dtype=np.int64)
    table[:5] = jobs[:5] if perm is None else jobs[:5, perm]
    table[7] = (0 if len(jobs) == 5 else
                jobs[5] if perm is None else jobs[5, perm])
    table[5] = one if perm is None else one[perm]
    if rows is None:
        table[5, :nl] = block_rows(table[1, :nl])
    ring = np.where(table[1, :nl] > 32 * table[5, :nl], 2 * table[3, :nl], 0)
    table[6, :nl] = np.cumsum(ring) - ring
    launches = _scratch_launches(table[:, nl:], WARP_SCRATCH[reverse],
                                 budget)
    return ShardPlan(table, perm, nl, int(ring.sum()),
                     [(s + nl, e + nl, c) for s, e, c in launches])


def _check(named, tables, qlen_all: int, tlen_all: int, jobs: np.ndarray,
           gap_open: int, gap_extend: int) -> None:
    """named: ((name, tensor, dtype, length), ...) of the resident arrays,
    each of which must hold `length` elements on the first one's device;
    tables: ((name, table), ...); the jobs must lie inside qlen_all query
    and tlen_all target elements."""
    dev = named[0][1].device
    for name, t, dt, n in named:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on {dev}")
        if t.dim() != 1 or len(t) != n:
            raise ValueError(f"{name}: the resident arrays of a side must "
                             "have one length")
    for name, tab in tables:
        if (tab.device != dev or tab.dtype != torch.int8
                or not tab.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {torch.int8} tensor "
                             f"on {dev}")
        if tab.dim() != 2 or tab.shape[0] != tab.shape[1] or tab.shape[0] > 32:
            raise ValueError(f"{name} must be a square matrix of at most 32 "
                             "letters")
    if jobs.dtype != np.int64 or jobs.ndim != 2 or jobs.shape[0] != 5:
        raise ValueError("jobs must be a (5, n) int64 array")
    qoff, qlen, toff, tlen = jobs[:4]
    if jobs.shape[1] and not (
            (qlen >= 1).all() and (tlen >= 1).all()
            and (qlen < 2**31).all() and (tlen < 2**31).all()
            and (qoff >= 0).all() and (qoff + qlen <= qlen_all).all()
            and (toff >= 0).all() and (toff + tlen <= tlen_all).all()):
        raise ValueError("SW jobs need 1 <= length < 2**31 and offsets "
                         "inside the resident arrays")
    if gap_open < gap_extend:
        raise ValueError("the SW kernels need gap_open >= gap_extend")


def _events() -> tuple:
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


class ShardTargets:
    """The target tokens of a card's shards: one uint8 tensor a shard (on
    one device, kept alive here) and, on a card, the device array of
    their base pointers that the sharded kernels read."""

    def __init__(self, tensors: list):
        self.tensors = list(tensors)
        dev = self.tensors[0].device
        self.base = (torch.tensor([t.data_ptr() for t in self.tensors],
                                  dtype=torch.int64, device=dev)
                     if dev.type == "cuda" else None)


def _c_args(resident: tuple) -> tuple:
    """The C interface's leading arguments for a stage's resident arrays:
    a tensor's pointer, with a table's alphabet size after it, and for a
    ShardTargets the pointer of its device array of base pointers."""
    args = []
    for a in resident:
        if isinstance(a, ShardTargets):
            a = a.base
        args.append(a.data_ptr())
        if a.dim() == 2:
            args.append(int(a.shape[0]))
    return tuple(args)


def launch(cell: str, reverse: bool, resident: tuple, plan: ShardPlan,
           gap_open: int, gap_extend: int, events: dict | None = None,
           block_resident: tuple | None = None) -> torch.Tensor:
    """Launch a stage of `cell` over its shard_plan on the card of the
    resident tensors: the block path on the side stream (after what the
    current stream queued), the short pairs on the current stream, which
    then waits for the side stream; counts the launches in LAUNCHES and
    returns the (6, n) result in the caller's job order.  resident: the
    stage's arrays in the order of its warp entry point's C arguments
    (_c_args); block_resident: those of its block path where they differ
    (the sequence cell's one-tensor ShardTargets in place of its target
    array).  events: if a dict, gets the (start, end) CUDA events of the
    whole ("card": from before the fork to after the join), of the long
    launch ("long") and of the short launches ("short"), of those that
    ran, the count of block-path pairs ("n_long") and the call's launches
    ("warp_launches", "block_launches")."""
    warp_name, block_name = ENTRIES[cell, reverse]
    dev = resident[0].device
    lib = load(dev)
    n = plan.table.shape[1]
    width = WARP_SCRATCH[reverse]

    def mark(key: str, end: int, stream) -> None:
        if events is not None:
            if not end:
                events[key] = _events()
            events[key][end].record(stream)

    with torch.cuda.device(dev):
        out = torch.empty((6, n), dtype=torch.int32, device=dev)
        if n == 0:
            return out
        table_d = torch.from_numpy(plan.table).to(dev, non_blocking=False)
        # the gather's columns, copied before the launches: a copy from
        # pageable memory waits for the stream, and after them it would
        # hold the host until the stage's kernels end
        back = (None if plan.perm is None else
                torch.from_numpy(np.argsort(plan.perm)).to(dev))
        main = torch.cuda.current_stream(dev)
        # every buffer before the fork: the side stream uses them too, and
        # no allocation lies inside the card's events
        ring = torch.empty(max(plan.long_cols, 1) * width, dtype=torch.uint8,
                           device=dev)
        scratch = [torch.empty(max(cols, 1) * width, dtype=torch.uint8,
                               device=dev) for _s, _e, cols in plan.launches]
        mark("card", 0, main)
        if events is not None:
            events.update(n_long=plan.n_long, warp_launches=len(scratch),
                          block_launches=int(plan.n_long > 0))
        if plan.n_long:
            side = _SIDE[dev.index]
            side.wait_stream(main)
            mark("long", 0, side)
            rc = getattr(lib, block_name)(
                *_c_args(block_resident or resident), table_d.data_ptr(), n,
                plan.n_long, int(gap_open), int(gap_extend), ring.data_ptr(),
                out.data_ptr(), n, side.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{block_name} launch failed: CUDA error "
                                   f"{rc}")
            LAUNCHES[block_name] += 1
            mark("long", 1, side)
        if plan.launches:
            args = _c_args(resident)
            mark("short", 0, main)
            for (s, e, _cols), buf in zip(plan.launches, scratch):
                rc = getattr(lib, warp_name)(
                    *args, table_d.data_ptr() + 8 * s, n, e - s,
                    int(gap_open), int(gap_extend), buf.data_ptr(),
                    out.data_ptr() + 4 * s, n, main.cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{warp_name} launch failed: CUDA "
                                       f"error {rc}")
                LAUNCHES[warp_name] += 1
            mark("short", 1, main)
        if plan.n_long:
            # the one join; what the side stream used was allocated on this
            # one and is freed after it
            main.wait_stream(side)
        mark("card", 1, main)
        if back is not None:
            out = out[:, back]
    return out


def _plan_launch(cell: str, reverse: bool, resident: tuple, jobs: np.ndarray,
                 gap_open: int, gap_extend: int, events: dict | None,
                 block_resident: tuple | None = None) -> torch.Tensor:
    """A wrapper's stage on a card: shard_plan over the card's warps, then
    launch."""
    dev = resident[0].device
    plan = shard_plan(jobs, cell, reverse, card_warps=card_warps(dev))
    return launch(cell, reverse, resident, plan, gap_open, gap_extend,
                  events, block_resident)


def _device_of(t: torch.Tensor) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _run_seq(reverse: bool, qdata, qbias, tdata, sub, jobs: np.ndarray,
             gap_open: int, gap_extend: int, events: dict | None = None,
             targets: ShardTargets | None = None) -> torch.Tensor:
    nq, nt = len(qbias), len(tdata)
    _check((("qbias", qbias, torch.int8, nq),
            ("query tokens", qdata, torch.uint8, nq),
            ("target tokens", tdata, torch.uint8, nt)),
           (("sub", sub),), nq, nt, jobs, gap_open, gap_extend)
    if _device_of(qdata).type == "cpu":
        return sw_jobs_ref(qdata, qbias, tdata, sub, jobs, gap_open,
                           gap_extend, reverse)
    # the stage as one shard: its long pairs on the block path, which
    # reads the target array through its one-tensor pointer table
    if targets is None:
        targets = ShardTargets([tdata])
    elif len(targets.tensors) != 1 or \
            targets.tensors[0].data_ptr() != tdata.data_ptr():
        raise ValueError("targets: need the one-tensor ShardTargets of "
                         "tdata")
    return _plan_launch("seq", reverse, (qdata, qbias, tdata, sub), jobs,
                        gap_open, gap_extend, events,
                        (qdata, qbias, targets, sub))


def _run_struct(reverse: bool, qss, qaa, qbias, tss, taa, m3di, aasc,
                jobs: np.ndarray, gap_open: int, gap_extend: int,
                events: dict | None = None) -> torch.Tensor:
    nq, nt = len(qbias), len(tss)
    _check((("qbias", qbias, torch.int8, nq),
            ("query 3Di", qss, torch.uint8, nq),
            ("target 3Di", tss, torch.uint8, nt),
            ("query amino acids", qaa, torch.uint8, nq),
            ("target amino acids", taa, torch.uint8, nt)),
           (("m3di", m3di), ("aasc", aasc)), nq, nt, jobs, gap_open,
           gap_extend)
    if _device_of(qss).type == "cpu":
        return sw_struct_jobs_ref(qss, qaa, qbias, tss, taa, m3di, aasc,
                                  jobs, gap_open, gap_extend, reverse)
    return _plan_launch("struct", reverse,
                        (qss, qaa, qbias, tss, taa, m3di, aasc), jobs,
                        gap_open, gap_extend, events)


def _run_prof(reverse: bool, qprof, tdata, jobs: np.ndarray, gap_open: int,
              gap_extend: int, events: dict | None = None) -> torch.Tensor:
    if len(qprof) % PROF_COLS:
        raise ValueError(f"query profiles: need {PROF_COLS} int8 values a "
                         "residue")
    nq, nt = len(qprof) // PROF_COLS, len(tdata)
    _check((("query profiles", qprof, torch.int8, nq * PROF_COLS),
            ("target tokens", tdata, torch.uint8, nt)), (), nq, nt, jobs,
           gap_open, gap_extend)
    if _device_of(qprof).type == "cpu":
        return sw_prof_jobs_ref(qprof, tdata, jobs, gap_open, gap_extend,
                                reverse)
    return _plan_launch("prof", reverse, (qprof, tdata), jobs, gap_open,
                        gap_extend, events)


def _run_shards(reverse: bool, qdata, qbias, targets: ShardTargets, sub,
                jobs: np.ndarray, gap_open: int, gap_extend: int,
                events: dict | None) -> torch.Tensor:
    nq = len(qbias)
    if jobs.dtype != np.int64 or jobs.ndim != 2 or jobs.shape[0] != 6:
        raise ValueError("sharded jobs must be a (6, n) int64 array")
    lens = np.array([len(t) for t in targets.tensors], dtype=np.int64)
    _check((("qbias", qbias, torch.int8, nq),
            ("query tokens", qdata, torch.uint8, nq),
            *((f"shard {d} target tokens", t, torch.uint8, len(t))
              for d, t in enumerate(targets.tensors))),
           (("sub", sub),), nq, int(lens.max()), jobs[:5], gap_open,
           gap_extend)
    shard = jobs[5]
    if jobs.shape[1] and not (
            (shard >= 0).all() and (shard < len(lens)).all()
            and (jobs[2] + jobs[3] <= lens[np.clip(shard, 0,
                                                   len(lens) - 1)]).all()):
        raise ValueError("each sharded job must lie inside its shard's "
                         "target tokens")
    if _device_of(qdata).type == "cpu":
        return sw_shards_jobs_ref(qdata, qbias, targets.tensors, sub, jobs,
                                  gap_open, gap_extend, reverse)
    return _plan_launch("shards", reverse, (qdata, qbias, targets, sub),
                        jobs, gap_open, gap_extend, events)


def sw_forward(qdata, qbias, tdata, sub, jobs: np.ndarray, gap_open: int,
               gap_extend: int, events: dict | None = None,
               targets: ShardTargets | None = None) -> torch.Tensor:
    """Forward pass: (score, t_end, q_end) in rows 0-2 of the (6, n)
    result; rows 3-5 hold the (0, -1, 0) placeholders.  On a card the
    stage is planned as one shard: the long pairs on
    sw_forward_shards_block, which reads `targets` (the one-tensor
    ShardTargets of tdata that an engine makes once; None: made here),
    the rest on sw_forward, `events` as `launch` fills it."""
    return _run_seq(False, qdata, qbias, tdata, sub, jobs, gap_open,
                    gap_extend, events, targets)


def sw_reverse(qdata, qbias, tdata, sub, jobs: np.ndarray, gap_open: int,
               gap_extend: int, events: dict | None = None,
               targets: ShardTargets | None = None) -> torch.Tensor:
    """Reverse pass on the flipped prefixes: all six outputs, with
    (found, fj, fi) at the terminate score in flipped coordinates.  On a
    card the stage is planned as one shard: the long pairs on
    sw_reverse_shards_block, which reads `targets` (as sw_forward's), the
    rest on sw_reverse, `events` as `launch` fills it."""
    return _run_seq(True, qdata, qbias, tdata, sub, jobs, gap_open,
                    gap_extend, events, targets)


def sw_forward_struct(qss, qaa, qbias, tss, taa, m3di, aasc,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None) -> torch.Tensor:
    """Structure-mode forward pass: as sw_forward, with the cell score
    int8(m3di[q_ss][t_ss] + bias_i) + int8(aasc[q_aa][t_aa]); never
    split."""
    return _run_struct(False, qss, qaa, qbias, tss, taa, m3di, aasc, jobs,
                       gap_open, gap_extend, events)


def sw_reverse_struct(qss, qaa, qbias, tss, taa, m3di, aasc,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None) -> torch.Tensor:
    """Structure-mode reverse pass: as sw_reverse, with the two-channel
    cell score of sw_forward_struct; never split."""
    return _run_struct(True, qss, qaa, qbias, tss, taa, m3di, aasc, jobs,
                       gap_open, gap_extend, events)


def sw_forward_prof(qprof, tdata, jobs: np.ndarray, gap_open: int,
                    gap_extend: int, events: dict | None = None
                    ) -> torch.Tensor:
    """Profile-query forward pass: as sw_forward, with the cell score
    prof[q_i][t_j] read from the queries' int8 profile rows `qprof` (21
    values a residue, flat, at the jobs' query element offsets); never
    split."""
    return _run_prof(False, qprof, tdata, jobs, gap_open, gap_extend, events)


def sw_reverse_prof(qprof, tdata, jobs: np.ndarray, gap_open: int,
                    gap_extend: int, events: dict | None = None
                    ) -> torch.Tensor:
    """Profile-query reverse pass: as sw_reverse, with the profile cell of
    sw_forward_prof (flipped rows qoff + qlen - 1 - i).  On a card the
    stage is planned as one shard: the long pairs on
    sw_reverse_prof_block, the rest on sw_reverse_prof, `events` as
    `launch` fills it."""
    return _run_prof(True, qprof, tdata, jobs, gap_open, gap_extend, events)


def sw_forward_shards(qdata, qbias, targets: ShardTargets, sub,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None) -> torch.Tensor:
    """A card's target-sharded forward stage (B8): sw_forward's result for
    (6, n) jobs (qoff, qlen, shard-local toff, tlen, terminate, shard)
    over the card's shards `targets`, in one launch of the short pairs and
    one of the long pairs."""
    return _run_shards(False, qdata, qbias, targets, sub, jobs, gap_open,
                       gap_extend, events)


def sw_reverse_shards(qdata, qbias, targets: ShardTargets, sub,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None) -> torch.Tensor:
    """The reverse stage of sw_forward_shards: sw_reverse's result."""
    return _run_shards(True, qdata, qbias, targets, sub, jobs, gap_open,
                       gap_extend, events)
