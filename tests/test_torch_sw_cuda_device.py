"""Every kernel launch on the card of its tensors, on the CPU: the
wrappers of ops/sw_cuda.py and the profile engine driven over stand-in
tensors on cuda:1 with a stand-in kernel library and a stand-in
`torch.cuda` that keep the current card as the CUDA runtime does.

The C entry points launch on the runtime's current device, on the stream
they are handed; a launch for another card than the current one fails on
the card.  So each wrapper must enter its tensors' card round its C calls
and record its events on that card's stream, and `load` must ready the
kernels on each card it is asked for.  The same stand-ins show how
`sw_reverse_prof` plans its stage (the long pairs on
sw_reverse_prof_block, the rest on sw_reverse_prof) and that a forward
profile stage is never split."""

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
        return FakeTensor(self.mem, self.shape, self.dtype, self.device)


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
        return FakeTensor(self.mem, shape, dtype, device)

    def from_numpy(self, a):
        dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
        return FakeTensor(self.mem, a.shape, dtype, "cpu", np.array(a))

    def tensor(self, data, dtype=None, device=None):
        return FakeTensor(self.mem, (len(data),), dtype, device,
                          np.asarray(data))


class FakeLib:
    """The kernel library: each entry point records its name, the
    current card and its arguments, and returns 0."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, self.cuda.current, args))
            return 0

        setattr(self, name, entry)
        return entry


@pytest.fixture
def card(monkeypatch):
    mem, cuda = Memory(), FakeCuda()
    fake = FakeTorch(mem, cuda)
    lib = FakeLib(cuda)
    for mod in (sw_cuda, sw_engine):
        monkeypatch.setattr(mod, "torch", fake)
    monkeypatch.setattr(sw_cuda, "_LIB", lib)
    # raising=False: a tree whose load() keeps no set of cards fails in the
    # tests, not here
    monkeypatch.setattr(sw_cuda, "_LOADED", set(), raising=False)
    monkeypatch.setattr(sw_cuda, "_SIDE", {})
    sw_cuda.reset_counts()
    dev = torch.device("cuda", CARD)

    def tensor(n, dtype, shape=None):
        return FakeTensor(mem, shape or (n,), dtype, dev)

    yield types.SimpleNamespace(mem=mem, cuda=cuda, lib=lib, dev=dev,
                                tensor=tensor)
    sw_cuda.reset_counts()


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
    assert n_long == len(long) and block[2][5] == sw_cuda.BLOCK_WARPS
    table = _table(card, block, 8)
    np.testing.assert_array_equal(table[:5, :n_long], jobs[:, long])
    np.testing.assert_array_equal(
        table[5, :n_long], sw_cuda.block_rows(jobs[1, long],
                                              sw_cuda.BLOCK_WARPS))
    ring = np.where(table[1, :n_long] > 32 * table[5, :n_long],
                    2 * table[3, :n_long], 0)
    np.testing.assert_array_equal(table[6, :n_long], np.cumsum(ring) - ring)
    assert ring[3] == ring[4] == 0 and (table[7] == 0).all()
    short = calls["sw_reverse_prof"]
    assert short[2][4] == jobs.shape[1] - n_long
    rest = _table(card, short, 8)
    np.testing.assert_array_equal(
        rest[:5], np.delete(jobs, long, axis=1))
    assert sw_cuda.REVERSE_PROF_BLOCK_LAUNCHES == 1
    assert sw_cuda.REVERSE_PROF_LAUNCHES == 1


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
    assert set(ev) == {"card"}
    assert sw_cuda.REVERSE_PROF_BLOCK_LAUNCHES == 0
