"""Every kernel launch on the card of its tensors, on the CPU: the
wrappers of ops/sw_cuda.py and the profile engine driven over stand-in
tensors on cuda:1 with a stand-in kernel library and a stand-in
`torch.cuda` that keep the current card as the CUDA runtime does.

The C entry points launch on the runtime's current device, on the stream
they are handed; a launch for another card than the current one fails on
the card.  So each wrapper must enter its tensors' card round its C calls
and record its events on that card's stream, and `load` must ready the
kernels on each card it is asked for.  The same stand-ins show how
`sw_forward`, `sw_reverse` and `sw_reverse_prof` plan their stage (the
long pairs on sw_forward_shards_block / sw_reverse_shards_block over the
engine's one-tensor pointer table, or on sw_reverse_prof_block, the rest
on the warp kernel), that the results come back in the caller's job
order, that an engine's `with_targets` view hands the block path its own
targets in both directions, that a forward profile stage and the
structure stages are never split, and that the launch counts agree."""

import collections
import contextlib
import types

import numpy as np
import pytest
import torch

from spacedust_tpu_torch.ops import sw_cuda, sw_engine
from spacedust_tpu_torch.ops.sw import PROF_COLS

CARD = 1
SMS = 132                  # an H100's SMs, as the stand-in card reports


class Memory:
    """Stand-in device memory: every tensor gets an address range of its
    own, so that a pointer handed to the library finds its tensor."""

    def __init__(self):
        self.tensors = {}
        self.top = 1 << 40

    def alloc(self, t) -> int:
        self.top += 1 << 32
        self.tensors[self.top] = t
        return self.top

    def find(self, ptr: int):
        base = max(b for b in self.tensors if b <= ptr)
        return self.tensors[base], ptr - base


class FakeTensor:
    def __init__(self, mem, shape, dtype, device, data=None):
        self.mem, self.shape, self.dtype = mem, tuple(shape), dtype
        self.device = torch.device(device)
        self.data = data
        self._ptr = mem.alloc(self)

    def data_ptr(self) -> int:
        return self._ptr

    def dim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def is_contiguous(self) -> bool:
        return True

    def to(self, device, non_blocking=False):
        return FakeTensor(self.mem, self.shape, self.dtype, device, self.data)

    def __getitem__(self, index):
        # out[:, columns]: the columns of a result that holds data
        data = (self.data[:, index[1].data] if self.data is not None
                and isinstance(index, tuple) else None)
        return FakeTensor(self.mem, self.shape, self.dtype, self.device, data)


class FakeStream:
    def __init__(self, index: int, side: bool = False):
        self.index = index
        # a handle that names its card
        self.cuda_stream = 0x1000 * (index + 1) + side

    def wait_stream(self, other) -> None:
        pass


class FakeCuda:
    """The parts of torch.cuda the port touches, with a current card."""

    def __init__(self):
        self.current = 0
        self.events = []       # the card of each recorded event's stream

    def is_available(self) -> bool:
        return True

    def device_count(self) -> int:
        return 2

    def current_device(self) -> int:
        return self.current

    def _index(self, device) -> int:
        if isinstance(device, int):
            return device
        index = None if device is None else torch.device(device).index
        return self.current if index is None else index

    @contextlib.contextmanager
    def device(self, device):
        saved, self.current = self.current, self._index(device)
        try:
            yield
        finally:
            self.current = saved

    def current_stream(self, device=None) -> FakeStream:
        return FakeStream(self._index(device))

    def Stream(self, device=None, priority=0) -> FakeStream:
        return FakeStream(self._index(device), side=True)

    def Event(self, enable_timing=False):
        cuda = self

        class Event:
            def record(self, stream=None):
                cuda.events.append((stream or cuda.current_stream()).index)

        return Event()

    def get_device_properties(self, device):
        return types.SimpleNamespace(multi_processor_count=SMS)


class FakeTorch:
    """torch with stand-in tensors on a stand-in card."""

    def __init__(self, mem, cuda):
        self.mem, self.cuda = mem, cuda

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, shape, dtype=None, device=None):
        shape = (shape,) if isinstance(shape, int) else shape
        # a result (6, n) holds data that the stand-in kernels write
        data = np.zeros(shape, np.int64) if len(shape) == 2 else None
        return FakeTensor(self.mem, shape, dtype, device, data)

    def from_numpy(self, a):
        dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
        return FakeTensor(self.mem, a.shape, dtype, "cpu", np.array(a))

    def tensor(self, data, dtype=None, device=None):
        return FakeTensor(self.mem, (len(data),), dtype, device,
                          np.asarray(data))


# every C entry point -> its count of arguments (csrc/sw.cu)
ARITY = {"sw_load": 0, "sw_forward": 14, "sw_reverse": 14,
         "sw_forward_struct": 18, "sw_reverse_struct": 18,
         "sw_forward_prof": 11, "sw_reverse_prof": 11,
         "sw_forward_shards": 14, "sw_reverse_shards": 14,
         "sw_forward_shards_block": 14, "sw_reverse_shards_block": 14,
         "sw_reverse_prof_block": 11}
# the sequence and structure entry points that write their results: name
# -> the argument index of their jobs (job stride and count follow) and
# of their output
WRITES = {"sw_forward": (5, 11), "sw_reverse": (5, 11),
          "sw_forward_shards_block": (5, 11),
          "sw_reverse_shards_block": (5, 11),
          "sw_forward_struct": (9, 15), "sw_reverse_struct": (9, 15)}


class FakeLib:
    """The kernel library: each entry point checks its count of
    arguments, records its name, the current card and its arguments, and
    returns 0.  Those of WRITES put into their output columns the jobs'
    qoff (row 0) and 1 for the block path (row 1), as a kernel writes pair
    p's result in column p."""

    def __init__(self, cuda, mem):
        self.cuda, self.mem = cuda, mem
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def entry(*args):
            assert len(args) == ARITY[name], name
            self.calls.append((name, self.cuda.current, args))
            if name in WRITES:
                at_jobs, at_out = WRITES[name]
                stride, n = args[at_jobs + 1], args[at_jobs + 2]
                table, off = self.mem.find(args[at_jobs])
                qoff = table.data.reshape(-1, stride)[0, off // 8:]
                out, at = self.mem.find(args[at_out])
                cols = slice(at // 4, at // 4 + n)
                out.data[0, cols] = qoff[:n]
                out.data[1, cols] = name.endswith("_block")
            return 0

        setattr(self, name, entry)
        return entry


@pytest.fixture
def card(monkeypatch):
    mem, cuda = Memory(), FakeCuda()
    fake = FakeTorch(mem, cuda)
    lib = FakeLib(cuda, mem)
    for mod in (sw_cuda, sw_engine):
        monkeypatch.setattr(mod, "torch", fake)
    monkeypatch.setattr(sw_cuda, "_LIB", lib)
    # raising=False: a tree whose load() keeps no set of cards fails in the
    # tests, not here
    monkeypatch.setattr(sw_cuda, "_LOADED", set(), raising=False)
    monkeypatch.setattr(sw_cuda, "_SIDE", {})
    monkeypatch.setattr(sw_cuda, "LAUNCHES", collections.Counter())
    dev = torch.device("cuda", CARD)

    def tensor(n, dtype, shape=None):
        return FakeTensor(mem, shape or (n,), dtype, dev)

    yield types.SimpleNamespace(mem=mem, cuda=cuda, lib=lib, dev=dev,
                                tensor=tensor)


def _stage(n=3000, giant=(5917, 5496), seed=0):
    """(5, n) jobs over one resident array of each side: short pairs of
    20-300 query and 20-150 target residues, pair 0 the giant one (at
    3,000 pairs the only one past an even share of an H100's warps)."""
    rng = np.random.default_rng(seed)
    qlen = rng.integers(20, 300, n)
    tlen = rng.integers(20, 150, n)
    qlen[0], tlen[0] = giant
    jobs = np.stack([np.cumsum(qlen) - qlen, qlen, np.cumsum(tlen) - tlen,
                     tlen, np.full(n, -1)]).astype(np.int64)
    return jobs, int(qlen.sum()), int(tlen.sum())


def _table(card, call, rows):
    """The job table a profile entry point read: (rows, its job stride)
    from its jobs pointer on."""
    _name, _dev, args = call
    t, off = card.mem.find(args[2])
    return t.data.reshape(rows, args[3])[:, off // 8:]


def test_every_launch_and_event_on_the_tensors_card(card):
    """The sequence, structure and profile wrappers, the sharded ones and
    the profile reverse stage's block path, on tensors on cuda:1 while
    the current card is 0: every C entry point is called with cuda:1
    current and a stream of cuda:1, every event is recorded on a stream
    of cuda:1, the kernels are loaded on cuda:1 once, and the current
    card is 0 again afterwards."""
    jobs, nq, nt = _stage(n=400)
    u8, i8 = torch.uint8, torch.int8
    sub = card.tensor(21, i8, (21, 21))
    seq = (card.tensor(nq, u8), card.tensor(nq, i8), card.tensor(nt, u8), sub)
    struct = (card.tensor(nq, u8), card.tensor(nq, u8), card.tensor(nq, i8),
              card.tensor(nt, u8), card.tensor(nt, u8), sub, sub)
    prof = (card.tensor(nq * PROF_COLS, i8), card.tensor(nt, u8))
    half = nt // 2
    targets = sw_cuda.ShardTargets([card.tensor(half, u8),
                                    card.tensor(nt - half, u8)])
    shard = (jobs[2] >= half).astype(np.int64)
    sharded = np.concatenate([jobs, shard[None]])
    sharded[2] -= shard * half
    ok = sharded[2] + sharded[3] <= np.where(shard == 1, nt - half, half)
    sharded = np.ascontiguousarray(sharded[:, ok])
    events = []
    for fn, resident, js in (
            (sw_cuda.sw_forward, seq, jobs), (sw_cuda.sw_reverse, seq, jobs),
            (sw_cuda.sw_forward_struct, struct, jobs),
            (sw_cuda.sw_reverse_struct, struct, jobs),
            (sw_cuda.sw_forward_prof, prof, jobs),
            (sw_cuda.sw_reverse_prof, prof, jobs),
            (sw_cuda.sw_forward_shards, (seq[0], seq[1], targets, sub),
             sharded),
            (sw_cuda.sw_reverse_shards, (seq[0], seq[1], targets, sub),
             sharded)):
        ev: dict = {}
        out = fn(*resident, js, 11, 1, events=ev)
        assert out.device == card.dev and "card" in ev
        events.append(ev)
    names = {name for name, _d, _a in card.lib.calls}
    assert names == {"sw_load", "sw_forward", "sw_reverse",
                     "sw_forward_struct", "sw_reverse_struct",
                     "sw_forward_prof", "sw_reverse_prof",
                     "sw_reverse_prof_block", "sw_forward_shards",
                     "sw_reverse_shards", "sw_forward_shards_block",
                     "sw_reverse_shards_block"}
    for name, current, args in card.lib.calls:
        assert current == CARD, name
        if name != "sw_load":
            assert args[-1] in (0x1000 * (CARD + 1), 0x1000 * (CARD + 1) + 1)
    assert [c for c in card.lib.calls if c[0] == "sw_load"] == [
        ("sw_load", CARD, ())]
    assert card.cuda.events and set(card.cuda.events) == {CARD}
    assert card.cuda.current == 0
    assert events[5]["n_long"] >= 1 and "long" in events[5]


def test_load_readies_each_card_once(card):
    """load(device) runs sw_load under each new card once, and no more
    for a card it has readied (index, device or the current card)."""
    sw_cuda.load(torch.device("cuda", 0))
    sw_cuda.load(torch.device("cuda", 1))
    sw_cuda.load(1)
    sw_cuda.load("cuda:0")
    sw_cuda.load(None)
    assert card.lib.calls == [("sw_load", 0, ()), ("sw_load", 1, ())]
    assert card.cuda.current == 0


def test_profile_engine_dispatch_on_its_card(card):
    """ProfileDeviceDB on cuda:1 readies the kernels there, records its
    wrapper events on cuda:1's stream, and counts its reverse stage's
    block-path pairs and launches."""
    jobs, nq, nt = _stage()
    rng = np.random.default_rng(1)
    eng = sw_engine.ProfileDeviceDB(
        rng.integers(-4, 5, (nq, PROF_COLS)).astype(np.int8),
        rng.integers(0, 21, nt).astype(np.uint8), device="cuda:1")
    assert card.lib.calls == [("sw_load", CARD, ())]
    pending = eng.enqueue([(*jobs, np.arange(jobs.shape[1]))], 11, 1,
                          reverse=True)
    pending += eng.flush(11, 1, reverse=True)
    assert len(pending) == 1
    _pos, _out, events, d = pending[0]
    assert d == "rev" and {"wrapper", "card", "long", "short"} <= set(events)
    assert set(card.cuda.events) == {CARD}
    m = eng.metrics
    assert m["rev_block_pairs"] == 1 and m["rev_block_launches"] == 1
    assert m["rev_launches"] == 2 and m["rev_pairs"] == jobs.shape[1]
    assert all(c[1] == CARD for c in card.lib.calls)


def test_profile_reverse_stage_plan(card):
    """sw_reverse_prof on a card plans the stage as one shard over the
    card's warps (SMs x 16): the giant pair, and only the pairs whose
    one-warp lane-steps exceed the stage's over the card's warps, go to
    sw_reverse_prof_block, first in the table, at block_rows' class, with
    their rings (two slots of tlen columns for a pair past one strip)
    from 0; the other pairs go to one sw_reverse_prof launch over the
    rest of the table."""
    jobs, nq, nt = _stage()
    jobs[1, 1:3], jobs[3, 1:3] = 5000, 5500       # not only the giant
    jobs[1, 3:5] = 40                             # long targets, one strip
    jobs[3, 3:5] = 200_000
    nq, nt = int((jobs[0] + jobs[1]).max()), int((jobs[2] + jobs[3]).max())
    prof = (card.tensor(nq * PROF_COLS, torch.int8),
            card.tensor(nt, torch.uint8))
    sw_cuda.sw_reverse_prof(*prof, jobs, 11, 1)
    calls = {c[0]: c for c in card.lib.calls}
    lanes = sw_cuda.lane_rows(jobs[1])
    steps = -(-jobs[1] // (32 * lanes)) * (jobs[3] + 31)
    long = np.nonzero(steps * SMS * sw_cuda.SM_WARPS > steps.sum())[0]
    assert set(long.tolist()) == {0, 1, 2, 3, 4}
    block = calls["sw_reverse_prof_block"]
    n_long = block[2][4]
    assert n_long == len(long)
    table = _table(card, block, 8)
    np.testing.assert_array_equal(table[:5, :n_long], jobs[:, long])
    np.testing.assert_array_equal(table[5, :n_long],
                                  sw_cuda.block_rows(jobs[1, long]))
    ring = np.where(table[1, :n_long] > 32 * table[5, :n_long],
                    2 * table[3, :n_long], 0)
    np.testing.assert_array_equal(table[6, :n_long], np.cumsum(ring) - ring)
    assert ring[3] == ring[4] == 0 and (table[7] == 0).all()
    short = calls["sw_reverse_prof"]
    assert short[2][4] == jobs.shape[1] - n_long
    rest = _table(card, short, 8)
    np.testing.assert_array_equal(
        rest[:5], np.delete(jobs, long, axis=1))
    assert sw_cuda.LAUNCHES == {"sw_reverse_prof_block": 1,
                                "sw_reverse_prof": 1}


def test_forward_profile_stage_is_never_split(card):
    """A forward profile stage with the same giant pairs is one
    sw_forward_prof launch over every pair, with no block path."""
    jobs, nq, nt = _stage()
    prof = (card.tensor(nq * PROF_COLS, torch.int8),
            card.tensor(nt, torch.uint8))
    ev: dict = {}
    sw_cuda.sw_forward_prof(*prof, jobs, 11, 1, events=ev)
    names = [c[0] for c in card.lib.calls if c[0] != "sw_load"]
    assert names == ["sw_forward_prof"]
    assert card.lib.calls[-1][2][4] == jobs.shape[1]
    assert "card" in ev and "long" not in ev
    assert ev["n_long"] == ev["block_launches"] == 0
    assert ev["warp_launches"] == 1
    assert sw_cuda.LAUNCHES == {"sw_forward_prof": 1}


def _engine(nq: int, nt: int, seed: int = 1) -> sw_engine.DeviceAlignDB:
    """A sequence engine on the stand-in card over random arrays."""
    rng = np.random.default_rng(seed)
    return sw_engine.DeviceAlignDB(
        rng.integers(0, 21, nq).astype(np.uint8),
        rng.integers(-3, 4, nq).astype(np.int8),
        rng.integers(0, 21, nt).astype(np.uint8),
        rng.integers(-4, 5, (21, 21)).astype(np.int8), device=f"cuda:{CARD}")


def _giants(jobs: np.ndarray, at=(0, 1, 2)) -> np.ndarray:
    """The jobs with three pairs of many strips at `at` (the giant one and
    two of 5,000 x 5,500), each past an even share of an H100's warps."""
    jobs = jobs.copy()
    jobs[1, list(at)] = (5917, 5000, 5000)
    jobs[3, list(at)] = (5496, 5500, 5500)
    qlen, tlen = jobs[1], jobs[3]
    jobs[0] = np.cumsum(qlen) - qlen
    jobs[2] = np.cumsum(tlen) - tlen
    return jobs


def _seq_table(card, call) -> np.ndarray:
    """The job table a sequence entry point read (8 rows, its job stride)
    from its jobs pointer on."""
    _name, _dev, args = call
    t, off = card.mem.find(args[5])
    return t.data.reshape(8, args[6])[:, off // 8:]


def _engine_stage(eng, jobs, reverse=True):
    """One stage of the engine in the direction over jobs (positions
    0..n-1)."""
    pending = eng.enqueue([(*jobs, np.arange(jobs.shape[1]))], 11, 1,
                          reverse=reverse)
    return pending + eng.flush(11, 1, reverse=reverse)


# direction -> (warp entry point, block entry point, the engine's metrics
# prefix)
SEQ = {True: ("sw_reverse", "sw_reverse_shards_block", "rev"),
       False: ("sw_forward", "sw_forward_shards_block", "fwd")}


def _stage_plan(card, reverse: bool) -> None:
    """DeviceAlignDB's stage of the direction on cuda:1 is planned as one
    shard over the card's warps: its three pairs of many strips go first
    in the table to the sequence block kernel, at block_rows' class, with
    their rings (two slots of tlen columns of the direction's boundary
    cell) from 0, reading the engine's one-tensor pointer table (made with
    the engine, before every stage) on the side stream; the other pairs
    go to one launch of the warp kernel over the rest of the table in
    cells order, which reads the target array itself; every C call is
    under cuda:1 on a stream of cuda:1, every event on cuda:1; the
    metrics count the block pairs and both launches, and no launch of
    B8's short kernel is counted."""
    warp, block_name, d = SEQ[reverse]
    jobs, _nq, _nt = _stage()
    jobs = _giants(jobs)
    nq, nt = int(jobs[0, -1] + jobs[1, -1]), int(jobs[2, -1] + jobs[3, -1])
    eng = _engine(nq, nt)
    assert card.lib.calls == [("sw_load", CARD, ())]
    before = card.mem.top
    pending = _engine_stage(eng, jobs, reverse)
    assert len(pending) == 1
    _pos, _out, events, got_d = pending[0]
    assert got_d == d
    assert {"wrapper", "card", "long", "short"} <= set(events)
    assert set(card.cuda.events) == {CARD}
    calls = {c[0]: c for c in card.lib.calls}
    assert set(calls) == {"sw_load", warp, block_name}
    # the block launch first, on the side stream; the short one on the
    # current stream
    assert [c[0] for c in card.lib.calls[1:]] == [block_name, warp]
    for name, current, args in card.lib.calls[1:]:
        assert current == CARD, name
    assert calls[block_name][2][-1] == 0x1000 * (CARD + 1) + 1
    assert calls[warp][2][-1] == 0x1000 * (CARD + 1)
    block, short = calls[block_name], calls[warp]
    base, at = card.mem.find(block[2][2])
    assert base is eng._targets.base and at == 0
    assert base.data.tolist() == [eng.tdata.data_ptr()]
    assert base.data_ptr() <= before
    assert short[2][2] == eng.tdata.data_ptr()
    n_long = block[2][7]
    assert n_long == 3
    table = _seq_table(card, block)
    np.testing.assert_array_equal(table[:5, :3], jobs[:, :3])
    np.testing.assert_array_equal(table[5, :3],
                                  sw_cuda.block_rows(jobs[1, :3]))
    assert (table[1, :3] > 32 * table[5, :3]).all()
    ring = 2 * table[3, :3]
    np.testing.assert_array_equal(table[6, :3], np.cumsum(ring) - ring)
    ring_buf, _at = card.mem.find(block[2][10])
    assert ring_buf.shape == (int(ring.sum())
                              * sw_cuda.WARP_SCRATCH[reverse],)
    assert (table[7] == 0).all()
    rest = _seq_table(card, short)
    assert short[2][7] == jobs.shape[1] - 3
    order = np.argsort(-(jobs[1, 3:] * jobs[3, 3:]), kind="stable") + 3
    np.testing.assert_array_equal(rest[:5, :short[2][7]], jobs[:, order])
    m = eng.metrics
    assert m[f"{d}_block_pairs"] == 3 and m[f"{d}_block_launches"] == 1
    assert m[f"{d}_launches"] == 2 and m[f"{d}_pairs"] == jobs.shape[1]
    assert sw_cuda.LAUNCHES == {block_name: 1, warp: 1}   # none of B8's
    other = "rev" if d == "fwd" else "fwd"
    assert m[f"{other}_block_pairs"] == m[f"{other}_block_launches"] == 0


def test_sequence_reverse_stage_plan(card):
    """K2 in the single engine: the reverse stage's plan (_stage_plan)."""
    _stage_plan(card, reverse=True)


def test_sequence_forward_stage_plan(card):
    """K1 in the single engine: the forward stage's plan (_stage_plan),
    the forward mirror of the reverse stage's; and the wrapper called
    alone hands back the split stage's events and its block pairs."""
    _stage_plan(card, reverse=False)
    jobs, _nq, _nt = _stage()
    jobs = _giants(jobs)
    nq, nt = int(jobs[0, -1] + jobs[1, -1]), int(jobs[2, -1] + jobs[3, -1])
    u8 = torch.uint8
    seq = (card.tensor(nq, u8), card.tensor(nq, torch.int8),
           card.tensor(nt, u8), card.tensor(21, torch.int8, (21, 21)))
    ev: dict = {}
    sw_cuda.sw_forward(*seq, jobs, 11, 1, events=ev)
    assert {"card", "long", "short"} <= set(ev) and ev["n_long"] == 3
    assert ev["block_launches"] == ev["warp_launches"] == 1
    assert sw_cuda.LAUNCHES["sw_forward_shards_block"] == 2
    assert sw_cuda.LAUNCHES["sw_forward_shards"] == 0


def _results_in_job_order(card, reverse: bool) -> None:
    """The wrapper of the direction on a card hands back column p for the
    caller's job p whatever order the plan launches them in: the giant
    pairs sit at 7, 100 and 2,000 of the caller's order, the block path
    takes them first, and the stand-in kernels write each job's qoff (and
    1 on the block path) where the table puts it.  A pointer table of
    another array is refused."""
    fn = getattr(sw_cuda, SEQ[reverse][0])
    jobs, _nq, _nt = _stage(giant=(100, 100))
    jobs = _giants(jobs, at=(7, 100, 2000))
    nq, nt = int(jobs[0, -1] + jobs[1, -1]), int(jobs[2, -1] + jobs[3, -1])
    u8 = torch.uint8
    seq = (card.tensor(nq, u8), card.tensor(nq, torch.int8),
           card.tensor(nt, u8), card.tensor(21, torch.int8, (21, 21)))
    out = fn(*seq, jobs, 11, 1)
    np.testing.assert_array_equal(out.data[0], jobs[0])
    long = np.zeros(jobs.shape[1], np.int64)
    long[[7, 100, 2000]] = 1
    np.testing.assert_array_equal(out.data[1], long)
    other = sw_cuda.ShardTargets([card.tensor(nt, u8)])
    with pytest.raises(ValueError, match="one-tensor ShardTargets"):
        fn(*seq, jobs, 11, 1, targets=other)


def test_sequence_reverse_results_in_job_order(card):
    """sw_reverse: _results_in_job_order."""
    _results_in_job_order(card, reverse=True)


def test_sequence_forward_results_in_job_order(card):
    """sw_forward: _results_in_job_order."""
    _results_in_job_order(card, reverse=False)


def _view_reads_its_own_targets(card, reverse: bool) -> None:
    """An engine's with_targets view (the --alt-ali rounds' masked
    targets) makes its own pointer table when it is made, and the block
    path of its stage in the direction reads the view's target array, not
    the parent's: the block launch's pointer table holds the view's
    tdata, the short launch reads it too.  The planted fault -- the view
    keeping the parent's table, as copy.copy would leave it -- is refused,
    not scored against the unmasked targets."""
    warp, block_name, d = SEQ[reverse][:3]
    jobs, _nq, _nt = _stage()
    jobs = _giants(jobs)
    nq, nt = int(jobs[0, -1] + jobs[1, -1]), int(jobs[2, -1] + jobs[3, -1])
    eng = _engine(nq, nt)
    masked = np.full(nt, 20, np.uint8)
    view = eng.with_targets(masked)
    assert view._targets is not eng._targets
    assert view.qdata is eng.qdata and view.tdata is not eng.tdata
    before = card.mem.top
    _engine_stage(view, jobs, reverse)
    block = next(c for c in card.lib.calls if c[0] == block_name)
    short = next(c for c in card.lib.calls if c[0] == warp)
    base, _at = card.mem.find(block[2][2])
    assert base is view._targets.base
    assert base.data.tolist() == [view.tdata.data_ptr()]
    assert view.tdata.data_ptr() != eng.tdata.data_ptr()
    assert short[2][2] == view.tdata.data_ptr()
    # no pointer table was made during the stage
    assert base.data_ptr() <= before
    assert all(t.shape != (1,) for b, t in card.mem.tensors.items()
               if b > before)
    assert view.metrics[f"{d}_block_pairs"] == 3
    assert eng.metrics[f"{d}_block_pairs"] == 0

    faulty = eng.with_targets(masked)
    faulty._targets = eng._targets       # the planted fault: a shared table
    with pytest.raises(ValueError, match="one-tensor ShardTargets"):
        _engine_stage(faulty, jobs, reverse)


def test_with_targets_view_reads_its_own_targets(card):
    """The reverse stage (K2's block path): _view_reads_its_own_targets."""
    _view_reads_its_own_targets(card, reverse=True)


def test_with_targets_view_forward_reads_its_own_targets(card):
    """The forward stage (K1's block path), as the --alt-ali rounds'
    forward stages run it: _view_reads_its_own_targets."""
    _view_reads_its_own_targets(card, reverse=False)


def _struct_stage_unsplit(card, reverse: bool) -> None:
    """A structure stage of the direction goes through the one launcher on
    its tensors' card, unsplit: one launch of the structure warp kernel
    under cuda:1 on cuda:1's current stream over the 8-row table of every
    pair in the caller's order (giant pairs at 7, 100 and 2,000 stay
    there; shard row 0), every event on cuda:1, the results in the
    caller's order, and the call's counts in `events` and LAUNCHES."""
    name = "sw_reverse_struct" if reverse else "sw_forward_struct"
    fn = getattr(sw_cuda, name)
    jobs, _nq, _nt = _stage(giant=(100, 100))
    jobs = _giants(jobs, at=(7, 100, 2000))
    nq, nt = int(jobs[0, -1] + jobs[1, -1]), int(jobs[2, -1] + jobs[3, -1])
    u8, i8 = torch.uint8, torch.int8
    table = card.tensor(21, i8, (21, 21))
    struct = (card.tensor(nq, u8), card.tensor(nq, u8), card.tensor(nq, i8),
              card.tensor(nt, u8), card.tensor(nt, u8), table, table)
    ev: dict = {}
    out = fn(*struct, jobs, 11, 1, events=ev)
    calls = [c for c in card.lib.calls if c[0] != "sw_load"]
    assert [c[0] for c in calls] == [name]
    _name, current, args = calls[0]
    assert current == CARD and args[-1] == 0x1000 * (CARD + 1)
    assert args[11] == jobs.shape[1]
    t, off = card.mem.find(args[9])
    got = t.data.reshape(8, args[10])[:, off // 8:]
    np.testing.assert_array_equal(got[:5], jobs)
    np.testing.assert_array_equal(got[5], sw_cuda.lane_rows(jobs[1]))
    assert (got[7] == 0).all()
    np.testing.assert_array_equal(out.data[0], jobs[0])
    assert (out.data[1] == 0).all()
    assert {"card", "short"} <= set(ev) and "long" not in ev
    assert ev["n_long"] == ev["block_launches"] == 0
    assert ev["warp_launches"] == 1
    assert set(card.cuda.events) == {CARD} and card.cuda.current == 0
    assert sw_cuda.LAUNCHES == {name: 1}


def test_struct_forward_stage_unsplit(card):
    """sw_forward_struct: _struct_stage_unsplit."""
    _struct_stage_unsplit(card, reverse=False)


def test_struct_reverse_stage_unsplit(card):
    """sw_reverse_struct: _struct_stage_unsplit."""
    _struct_stage_unsplit(card, reverse=True)


def test_engine_launch_counts_agree(card):
    """A sequence engine's forward stages on cuda:1, one with three pairs
    of many strips and one of shorter pairs: its `fwd_launches` and
    `fwd_block_launches` are the launches LAUNCHES counts by entry point,
    one warp launch a stage and a block launch where a stage has long
    pairs."""
    jobs, _nq, _nt = _stage()
    big = _giants(jobs)
    short, _nq, _nt = _stage(giant=(100, 100))
    nq = int(max(big[0, -1] + big[1, -1], short[0, -1] + short[1, -1]))
    nt = int(max(big[2, -1] + big[3, -1], short[2, -1] + short[3, -1]))
    eng = _engine(nq, nt)
    _engine_stage(eng, big, reverse=False)
    _engine_stage(eng, short, reverse=False)
    m = eng.metrics
    assert m["n_batches"] == 2
    assert sw_cuda.LAUNCHES["sw_forward"] == 2
    assert m["fwd_block_launches"] == sw_cuda.LAUNCHES[
        "sw_forward_shards_block"] >= 1
    assert m["fwd_launches"] == sum(sw_cuda.LAUNCHES.values())
    assert m["fwd_launches"] - m["fwd_block_launches"] == sw_cuda.LAUNCHES[
        "sw_forward"]
    assert m["fwd_block_pairs"] >= 3
    assert m["rev_launches"] == m["rev_block_launches"] == 0
