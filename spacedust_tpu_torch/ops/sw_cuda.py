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
kernels take the pairs in.  For CUDA tensors they copy the jobs to the
card once and launch the kernel on the current stream; nothing is
synchronised.  They give each pair one of the kernel's compile-time
classes of query rows per lane (LANE_ROWS, `lane_rows`) and its place in
the boundary scratch (`warp_plan`), in one launch unless the scratch
would pass SCRATCH_BYTES.  For CPU tensors they run the plain version
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
pointers that the kernels read).  `shard_plan` splits the jobs: a pair
whose one-warp lane-steps exceed the stage's even share of the card's
warps (`card_warps`) goes to the block path (`sw_*_shards_block`, a block
of BLOCK_WARPS warps a pair, launched first on a side stream of the
card), the rest to the sequence kernel with a per-pair shard
(`sw_*_shards`) on the current stream; the current stream waits for the
side stream once.  For CPU tensors they run `ops/sw.py::
sw_shards_jobs_ref`.  `sw_forward`, `sw_reverse` and `sw_reverse_prof`
plan their stage the same way, as one shard: the long pairs of
`sw_forward` / `sw_reverse` go to `sw_forward_shards_block` /
`sw_reverse_shards_block` over a one-tensor `ShardTargets` of their target
array, those of `sw_reverse_prof` to `sw_reverse_prof_block` (the block
path with the profile cell); the rest to the direction's own warp kernel.

Every launch goes to the card of its tensors: the launchers enter that
card (`torch.cuda.device`) round their C calls, record their events on
its current stream, and `load(device)` readies the kernels on each card
once.

FORWARD_LAUNCHES / REVERSE_LAUNCHES / FORWARD_STRUCT_LAUNCHES /
REVERSE_STRUCT_LAUNCHES / FORWARD_PROF_LAUNCHES / REVERSE_PROF_LAUNCHES,
the block paths of the single engine's forward and reverse stages
(FORWARD_SEQ_BLOCK_LAUNCHES, REVERSE_SEQ_BLOCK_LAUNCHES) and of the
profile reverse stage
(REVERSE_PROF_BLOCK_LAUNCHES), which take their long pairs, and the
sharded stage's FORWARD_SHARDS_LAUNCHES / REVERSE_SHARDS_LAUNCHES
(short pairs) / FORWARD_BLOCK_LAUNCHES / REVERSE_BLOCK_LAUNCHES (long
pairs) count kernel launches (COUNTERS names them all).  A caller that
wants the kernels' own time passes a dict as `events`: the launcher puts
under "card" one (start, end) pair of CUDA events recorded round its
launches, after the job table is on the card, so that neither the host
planning nor that copy lies between them (from before the fork to after
the join where a stage takes the block path; see `_launch_split` for
the keys it adds); nothing is recorded for CPU tensors.
"""

from __future__ import annotations

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
# by the card's SMs), the compiled widths W and the one the wrappers
# take: chip_smoke.py's sharded phase times the giant pair and both
# stages at each W (its timing phase the K1, K2 and B10 reverse stages);
# on an H100 80GB HBM3 at 700 W, W = 16 took the 5,917 x 5,496 pair in
# 3.74 ms (W = 8: 4.63, W = 4: 6.60; one warp 21.51) and the reverse
# stage of `real` in 6.10 ms (7.51, 9.34), the forward stage being set by
# its short launch
SM_WARPS = 16
BLOCK_WARP_CHOICES = (4, 8, 16)
BLOCK_WARPS = 16

FORWARD_LAUNCHES = 0
REVERSE_LAUNCHES = 0
FORWARD_STRUCT_LAUNCHES = 0
REVERSE_STRUCT_LAUNCHES = 0
FORWARD_PROF_LAUNCHES = 0
REVERSE_PROF_LAUNCHES = 0
FORWARD_SEQ_BLOCK_LAUNCHES = 0
REVERSE_SEQ_BLOCK_LAUNCHES = 0
REVERSE_PROF_BLOCK_LAUNCHES = 0
FORWARD_SHARDS_LAUNCHES = 0
REVERSE_SHARDS_LAUNCHES = 0
FORWARD_BLOCK_LAUNCHES = 0
REVERSE_BLOCK_LAUNCHES = 0

# (reverse?, cell) -> the C entry point (and wrapper) and its launch
# counter; the cell is "seq", "struct" or "prof"
ENTRY = {(False, "seq"): ("sw_forward", "FORWARD_LAUNCHES"),
         (True, "seq"): ("sw_reverse", "REVERSE_LAUNCHES"),
         (False, "struct"): ("sw_forward_struct", "FORWARD_STRUCT_LAUNCHES"),
         (True, "struct"): ("sw_reverse_struct", "REVERSE_STRUCT_LAUNCHES"),
         (False, "prof"): ("sw_forward_prof", "FORWARD_PROF_LAUNCHES"),
         (True, "prof"): ("sw_reverse_prof", "REVERSE_PROF_LAUNCHES")}
# (reverse?, cell) of a wrapper whose stage takes the block path too ->
# the long pairs' C entry point and its launch counter (the sequence cell
# reads its targets through a one-tensor ShardTargets, as B8 does; a
# counter of its own, apart from B8's)
BLOCK_ENTRY = {(False, "seq"): ("sw_forward_shards_block",
                                "FORWARD_SEQ_BLOCK_LAUNCHES"),
               (True, "seq"): ("sw_reverse_shards_block",
                               "REVERSE_SEQ_BLOCK_LAUNCHES"),
               (True, "prof"): ("sw_reverse_prof_block",
                                "REVERSE_PROF_BLOCK_LAUNCHES")}
# a wrapper's count of leading resident tensors -> its cell
CELL_OF_RESIDENT = {4: "seq", 7: "struct", 2: "prof"}
# reverse? -> the sharded stage's (short-pair entry point, its counter,
# long-pair entry point, its counter)
SHARD_ENTRY = {
    False: ("sw_forward_shards", "FORWARD_SHARDS_LAUNCHES",
            "sw_forward_shards_block", "FORWARD_BLOCK_LAUNCHES"),
    True: ("sw_reverse_shards", "REVERSE_SHARDS_LAUNCHES",
           "sw_reverse_shards_block", "REVERSE_BLOCK_LAUNCHES")}
COUNTERS = tuple(c for _n, c in ENTRY.values()) + tuple(
    c for _n, c in BLOCK_ENTRY.values()) + tuple(
    e[k] for e in SHARD_ENTRY.values() for k in (1, 3))

_LIB = None
_LOCK = threading.Lock()
_LOADED: set = set()            # the card indices the kernels are loaded on
_SIDE: dict = {}                # card index -> the block path's side stream


def reset_counts() -> None:
    for counter in COUNTERS:
        globals()[counter] = 0


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
    for fn in (lib.sw_forward, lib.sw_reverse):
        fn.restype = i
        fn.argtypes = [p, p, p, p, i, p, ll, i, i, i, p, p, ll, p]
    for fn in (lib.sw_forward_struct, lib.sw_reverse_struct):
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, p, i, p, i,
                       p, ll, i, i, i, p, p, ll, p]
    for fn in (lib.sw_forward_prof, lib.sw_reverse_prof):
        fn.restype = i
        fn.argtypes = [p, p, p, ll, i, i, i, p, p, ll, p]
    for fn in (lib.sw_forward_shards, lib.sw_reverse_shards):
        fn.restype = i
        fn.argtypes = [p, p, p, p, i, p, ll, i, i, i, p, p, ll, p]
    # ..., jobs, job_stride, n, warps, go, ge, scratch, out, ...
    for fn in (lib.sw_forward_shards_block, lib.sw_reverse_shards_block):
        fn.restype = i
        fn.argtypes = [p, p, p, p, i, p, ll, i, i, i, i, p, p, ll, p]
    lib.sw_reverse_prof_block.restype = i
    lib.sw_reverse_prof_block.argtypes = [p, p, p, ll, i, i, i, i, p, p, ll,
                                          p]
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
                # in the caller's order (_launch_split): torch loads a
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


def warp_plan(jobs: np.ndarray, bytes_per_column: int,
              budget: int = SCRATCH_BYTES, rows: int | None = None
              ) -> tuple[np.ndarray, list[tuple[int, int, int]]]:
    """The kernels' launches for a (5, n) job array.

    Returns the (7, n) table the kernels read -- the jobs in the caller's
    order, with row 5 the pair's class (lane_rows, or `rows` for every
    pair) and row 6 its first column in the launch's boundary
    scratch -- and the launches (start, end, scratch columns) over its
    columns.  The wrappers leave `rows` alone; a check of one class passes
    it.  Only a pair longer than one strip (qlen > 32 * rows) takes
    scratch, one column per target residue; the pairs are split where a
    launch's scratch would pass `budget` bytes (a lone pair may exceed
    it)."""
    table = np.empty((7, jobs.shape[1]), dtype=np.int64)
    table[:5] = jobs
    table[5] = lane_rows(jobs[1]) if rows is None else rows
    return table, _scratch_launches(table, bytes_per_column, budget)


def _scratch_launches(table: np.ndarray, bytes_per_column: int,
                      budget: int) -> list[tuple[int, int, int]]:
    """warp_plan's row 6 and launches over a table whose rows 0-5 are
    filled (a view will do)."""
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


def block_rows(qlen: np.ndarray, warps: int) -> np.ndarray:
    """Per pair of the block path, the class of LANE_ROWS that sweeps its
    query soonest on `warps` warps: ceil(ceil(qlen / 32R) / warps) strips
    a warp, each step costing R cells and STEP_OVERHEAD_CELLS (a smaller R
    gives more strips to share); ties go to the larger class."""
    qlen = np.asarray(qlen, dtype=np.int64)
    classes = np.array(LANE_ROWS[::-1], dtype=np.int64)[:, None]
    strips = -(-qlen[None, :] // (32 * classes))
    cost = -(-strips // warps) * (classes + STEP_OVERHEAD_CELLS)
    return classes[np.argmin(cost, axis=0), 0]


@dataclasses.dataclass
class ShardPlan:
    """The launches of a card's target-sharded stage.  table: the (8, n)
    rows the kernels read (qoff, qlen, toff, tlen, terminate, rows, soff,
    shard), its columns in launch order: the n_long pairs of the block
    path, then the short pairs; perm[c]: the caller's job of column c
    (None: the caller's order);
    long_cols: the block path's ring columns (two slots of tlen for each
    pair longer than one strip), soff counting them from 0; launches: the
    short pairs' launches (start, end, scratch columns) over the table's
    columns, as warp_plan cuts them."""
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


def shard_plan(jobs: np.ndarray, reverse: bool, warps: int = BLOCK_WARPS,
               force: bool = False, rows: int | None = None,
               budget: int = SCRATCH_BYTES, *, card_warps: int) -> ShardPlan:
    """Plan a card's stage of (6, n) jobs (qoff, qlen, toff, tlen,
    terminate, shard).  A pair goes to the block path when its one-warp
    lane-steps ceil(qlen / 32R) * (tlen + 31) (R its lane_rows class)
    exceed the stage's total over `card_warps` (the card's, `card_warps()`):
    it would outlast an even share of the stage.  So does a pair of one
    strip, which the block sweeps no sooner: kept on the warp kernel, such
    pairs of long targets start late in the short launch and lengthen it
    (timed on an H100, PERF.md).  There its class is block_rows(qlen,
    warps).  The checks pass `force` (every pair to the block path) and
    `rows` (one class for every pair); the wrappers leave both.  A stage
    of one target array (the single engine's sequence stages and the
    profile reverse stage) is one shard: row 5 all 0."""
    if warps not in BLOCK_WARP_CHOICES:
        raise ValueError(f"the block path is compiled for {BLOCK_WARP_CHOICES}"
                         f" warps, not {warps}")
    n = jobs.shape[1]
    one = lane_rows(jobs[1]) if rows is None else np.full(n, rows)
    steps = -(-jobs[1] // (32 * one)) * (jobs[3] + 31)
    long = (np.ones(n, dtype=bool) if force
            else steps * card_warps > steps.sum())
    li = np.nonzero(long)[0]
    nl = len(li)
    # the caller's order when the long pairs lead it (as a stage sorted
    # longest first mostly has them)
    perm = (None if (li == np.arange(nl)).all()
            else np.concatenate([li, np.nonzero(~long)[0]]))
    table = np.empty((8, n), dtype=np.int64)
    table[:5] = jobs[:5] if perm is None else jobs[:5, perm]
    table[7] = jobs[5] if perm is None else jobs[5, perm]
    table[5] = one if perm is None else one[perm]
    if rows is None:
        table[5, :nl] = block_rows(table[1, :nl], warps)
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


def _launch_warp(reverse: bool, resident: tuple, plan: tuple,
                 gap_open: int, gap_extend: int,
                 events: dict | None = None) -> torch.Tensor:
    """Launch the kernel of the direction over a warp_plan of the jobs
    (its table and launches) on the card of the resident tensors,
    counting the launches; returns the (6, n) result.  resident: a
    wrapper's leading tensors, (qdata, qbias, tdata, sub), the seven of
    structure mode or the two of profile queries, which picks the entry
    point.  events: if a dict, gets under "card" the (start, end) CUDA
    events recorded round the launches."""
    name, counter = ENTRY[reverse, CELL_OF_RESIDENT[len(resident)]]
    dev = resident[0].device
    fn = getattr(load(dev), name)
    table, launches = plan
    n = table.shape[1]
    # the C interface takes a table as its pointer and its alphabet size
    args = []
    for a in resident:
        args.append(a.data_ptr())
        if a.dim() == 2:
            args.append(int(a.shape[0]))
    cell = WARP_SCRATCH[reverse]
    with torch.cuda.device(dev):
        out = torch.empty((6, n), dtype=torch.int32, device=dev)
        if n == 0:
            return out
        table_d = torch.from_numpy(table).to(dev, non_blocking=False)
        main = torch.cuda.current_stream(dev)
        if events is not None:
            events["card"] = _events()
            events["card"][0].record(main)
        for s, e, cols in launches:
            scratch = torch.empty(max(cols, 1) * cell, dtype=torch.uint8,
                                  device=dev)
            rc = fn(*args, table_d.data_ptr() + 8 * s, n, e - s,
                    int(gap_open), int(gap_extend), scratch.data_ptr(),
                    out.data_ptr() + 4 * s, n, main.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
            globals()[counter] += 1
        if events is not None:
            events["card"][1].record(main)
    return out


def _device_of(t: torch.Tensor) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _run_warp(reverse: bool, qdata, qbias, tdata, sub, jobs: np.ndarray,
              gap_open: int, gap_extend: int, events: dict | None = None,
              warps: int = BLOCK_WARPS, force: bool = False,
              rows: int | None = None,
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
    plan = shard_plan(_one_shard(jobs), reverse, warps, force, rows,
                      card_warps=card_warps(qdata.device))
    return _launch_split(reverse, (qdata, qbias, tdata, sub), plan, gap_open,
                         gap_extend, events, warps, targets)


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
    return _launch_warp(reverse, (qss, qaa, qbias, tss, taa, m3di, aasc),
                        warp_plan(jobs, WARP_SCRATCH[reverse]), gap_open,
                        gap_extend, events)


def _run_prof(reverse: bool, qprof, tdata, jobs: np.ndarray, gap_open: int,
              gap_extend: int, events: dict | None = None,
              warps: int = BLOCK_WARPS, force: bool = False,
              rows: int | None = None) -> torch.Tensor:
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
    if not reverse:
        return _launch_warp(False, (qprof, tdata),
                            warp_plan(jobs, WARP_SCRATCH[False]), gap_open,
                            gap_extend, events)
    # the reverse stage as one shard: its long pairs on the block path
    plan = shard_plan(_one_shard(jobs), True, warps, force, rows,
                      card_warps=card_warps(qprof.device))
    return _launch_split(True, (qprof, tdata), plan, gap_open, gap_extend,
                         events, warps)


def sw_forward(qdata, qbias, tdata, sub, jobs: np.ndarray, gap_open: int,
               gap_extend: int, events: dict | None = None,
               warps: int = BLOCK_WARPS, force: bool = False,
               rows: int | None = None,
               targets: ShardTargets | None = None) -> torch.Tensor:
    """Forward pass: (score, t_end, q_end) in rows 0-2 of the (6, n)
    result; rows 3-5 hold the (0, -1, 0) placeholders.  On a card the
    stage is planned as one shard (shard_plan; warps / force / rows go to
    it): the long pairs on sw_forward_shards_block, which reads `targets`
    (the one-tensor ShardTargets of tdata that an engine makes once;
    None: made here), the rest on sw_forward, `events` as _launch_split
    fills it."""
    return _run_warp(False, qdata, qbias, tdata, sub, jobs, gap_open,
                     gap_extend, events, warps, force, rows, targets)


def sw_reverse(qdata, qbias, tdata, sub, jobs: np.ndarray, gap_open: int,
               gap_extend: int, events: dict | None = None,
               warps: int = BLOCK_WARPS, force: bool = False,
               rows: int | None = None,
               targets: ShardTargets | None = None) -> torch.Tensor:
    """Reverse pass on the flipped prefixes: all six outputs, with
    (found, fj, fi) at the terminate score in flipped coordinates.  On a
    card the stage is planned as one shard (shard_plan; warps / force /
    rows go to it): the long pairs on sw_reverse_shards_block, which
    reads `targets` (the one-tensor ShardTargets of tdata that an engine
    makes once; None: made here), the rest on sw_reverse, `events` as
    _launch_split fills it."""
    return _run_warp(True, qdata, qbias, tdata, sub, jobs, gap_open,
                     gap_extend, events, warps, force, rows, targets)


def sw_forward_struct(qss, qaa, qbias, tss, taa, m3di, aasc,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None) -> torch.Tensor:
    """Structure-mode forward pass: as sw_forward, with the cell score
    int8(m3di[q_ss][t_ss] + bias_i) + int8(aasc[q_aa][t_aa])."""
    return _run_struct(False, qss, qaa, qbias, tss, taa, m3di, aasc, jobs,
                       gap_open, gap_extend, events)


def sw_reverse_struct(qss, qaa, qbias, tss, taa, m3di, aasc,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None) -> torch.Tensor:
    """Structure-mode reverse pass: as sw_reverse, with the two-channel
    cell score of sw_forward_struct."""
    return _run_struct(True, qss, qaa, qbias, tss, taa, m3di, aasc, jobs,
                       gap_open, gap_extend, events)


def sw_forward_prof(qprof, tdata, jobs: np.ndarray, gap_open: int,
                    gap_extend: int, events: dict | None = None
                    ) -> torch.Tensor:
    """Profile-query forward pass: as sw_forward, with the cell score
    prof[q_i][t_j] read from the queries' int8 profile rows `qprof` (21
    values a residue, flat, at the jobs' query element offsets)."""
    return _run_prof(False, qprof, tdata, jobs, gap_open, gap_extend, events)


def sw_reverse_prof(qprof, tdata, jobs: np.ndarray, gap_open: int,
                    gap_extend: int, events: dict | None = None,
                    warps: int = BLOCK_WARPS, force: bool = False,
                    rows: int | None = None) -> torch.Tensor:
    """Profile-query reverse pass: as sw_reverse, with the profile cell of
    sw_forward_prof (flipped rows qoff + qlen - 1 - i).  On a card the
    stage is planned as one shard (shard_plan; warps / force / rows go to
    it): the long pairs on sw_reverse_prof_block, the rest on
    sw_reverse_prof, `events` as _launch_split fills it."""
    return _run_prof(True, qprof, tdata, jobs, gap_open, gap_extend, events,
                     warps, force, rows)


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


def _one_shard(jobs: np.ndarray) -> np.ndarray:
    """(5, n) jobs of one target array as the (6, n) jobs of shard 0."""
    return np.concatenate([jobs, np.zeros((1, jobs.shape[1]), np.int64)])


def _split_entry(reverse: bool, resident: tuple,
                 targets: ShardTargets | None = None) -> tuple:
    """A split stage's leading C arguments of its long launch and of its
    short launches, and its (short-pair entry point, its counter,
    long-pair entry point, its counter): resident is (qdata, qbias,
    ShardTargets, sub) of a card's sharded stage, (qdata, qbias, tdata,
    sub) of a single engine's sequence stage with `targets` the
    one-tensor ShardTargets of tdata (the long launch reads its pointer
    table, the short one tdata), or (qprof, tdata) of a profile reverse
    stage."""
    if len(resident) == 2:
        qprof, tdata = resident
        args = (qprof.data_ptr(), tdata.data_ptr())
        return args, args, ENTRY[reverse, "prof"] + BLOCK_ENTRY[reverse,
                                                                "prof"]
    qdata, qbias, tdata, sub = resident
    head = (qdata.data_ptr(), qbias.data_ptr())
    tail = (sub.data_ptr(), int(sub.shape[0]))
    if isinstance(tdata, ShardTargets):
        args = (*head, tdata.base.data_ptr(), *tail)
        return args, args, SHARD_ENTRY[reverse]
    return ((*head, targets.base.data_ptr(), *tail),
            (*head, tdata.data_ptr(), *tail),
            ENTRY[reverse, "seq"] + BLOCK_ENTRY[reverse, "seq"])


def _launch_split(reverse: bool, resident: tuple, plan: ShardPlan,
                  gap_open: int, gap_extend: int,
                  events: dict | None = None,
                  warps: int = BLOCK_WARPS,
                  targets: ShardTargets | None = None) -> torch.Tensor:
    """Launch a stage over a shard_plan on the card of the resident
    tensors: the block path on the side stream (after what the current
    stream queued), the short pairs on the current stream, which then
    waits for the side stream; counts the launches and returns the (6, n)
    result in the caller's job order.  resident, targets: as
    _split_entry's, which picks the entry points.  events: if a dict,
    gets the (start, end) CUDA events of the whole ("card": from before
    the fork to after the join), of the long launch ("long") and of the
    short launches ("short"), of those that ran, and the count of
    block-path pairs ("n_long")."""
    long_args, short_args, (short_name, short_counter, long_name,
                            long_counter) = _split_entry(reverse, resident,
                                                         targets)
    dev = resident[0].device
    lib = load(dev)
    n = plan.table.shape[1]
    cell = WARP_SCRATCH[reverse]

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
        ring = torch.empty(max(plan.long_cols, 1) * cell, dtype=torch.uint8,
                           device=dev)
        scratch = [torch.empty(max(cols, 1) * cell, dtype=torch.uint8,
                               device=dev) for _s, _e, cols in plan.launches]
        mark("card", 0, main)
        if events is not None:
            events["n_long"] = plan.n_long
        if plan.n_long:
            side = _SIDE[dev.index]
            side.wait_stream(main)
            mark("long", 0, side)
            rc = getattr(lib, long_name)(*long_args, table_d.data_ptr(), n,
                                         plan.n_long, int(warps),
                                         int(gap_open), int(gap_extend),
                                         ring.data_ptr(), out.data_ptr(), n,
                                         side.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{long_name} launch failed: CUDA error "
                                   f"{rc}")
            globals()[long_counter] += 1
            mark("long", 1, side)
        if plan.launches:
            mark("short", 0, main)
            for (s, e, _cols), buf in zip(plan.launches, scratch):
                rc = getattr(lib, short_name)(
                    *short_args, table_d.data_ptr() + 8 * s, n, e - s,
                    int(gap_open), int(gap_extend), buf.data_ptr(),
                    out.data_ptr() + 4 * s, n, main.cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{short_name} launch failed: CUDA "
                                       f"error {rc}")
                globals()[short_counter] += 1
            mark("short", 1, main)
        if plan.n_long:
            # the one join; what the side stream used was allocated on this
            # one and is freed after it
            main.wait_stream(side)
        mark("card", 1, main)
        if back is not None:
            out = out[:, back]
    return out


def _run_shards(reverse: bool, qdata, qbias, targets: ShardTargets, sub,
                jobs: np.ndarray, gap_open: int, gap_extend: int,
                events: dict | None, warps: int, force: bool,
                rows: int | None) -> torch.Tensor:
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
    return _launch_split(reverse, (qdata, qbias, targets, sub),
                         shard_plan(jobs, reverse, warps, force, rows,
                                    card_warps=card_warps(qdata.device)),
                         gap_open, gap_extend, events, warps)


def sw_forward_shards(qdata, qbias, targets: ShardTargets, sub,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None, warps: int = BLOCK_WARPS,
                      force: bool = False, rows: int | None = None
                      ) -> torch.Tensor:
    """A card's target-sharded forward stage (B8): sw_forward's result for
    (6, n) jobs (qoff, qlen, shard-local toff, tlen, terminate, shard)
    over the card's shards `targets`, in one launch of the short pairs and
    one of the long pairs (shard_plan; warps / force / rows go to it)."""
    return _run_shards(False, qdata, qbias, targets, sub, jobs, gap_open,
                       gap_extend, events, warps, force, rows)


def sw_reverse_shards(qdata, qbias, targets: ShardTargets, sub,
                      jobs: np.ndarray, gap_open: int, gap_extend: int,
                      events: dict | None = None, warps: int = BLOCK_WARPS,
                      force: bool = False, rows: int | None = None
                      ) -> torch.Tensor:
    """The reverse stage of sw_forward_shards: sw_reverse's result."""
    return _run_shards(True, qdata, qbias, targets, sub, jobs, gap_open,
                       gap_extend, events, warps, force, rows)
