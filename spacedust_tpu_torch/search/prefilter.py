"""K-mer prefilter: double-diagonal match + ungapped rescore.

Host side: the k-mer index build and the per-query matcher run in the
native OpenMP engine (native/prefilter_engine.cpp); this module builds
the seed tables and the index and drives the engine over contiguous
query ranges.  The engine reproduces the reference's prefiltering
(lib/mmseqs/src/prefiltering/):

  * spaced 6-mers, pattern {1,1,0,1,0,1,0,0,1,1} (Sequence.h:24), over a
    20-letter alphabet (X excluded; Prefiltering.cpp:530-533)
  * targets are tantan-masked (IndexBuilder.cpp:131) and only k-mers with
    self-score >= kmerThr on the VTML80 8-bit-scaled seed matrix are
    indexed (IndexTable.h:144-152); postings carry (seqId, windowPos)
  * per query window: composition bias (float32 chain, VTML80 scale)
    shifts the k-mer threshold (QueryMatcher.cpp:230-236); similar k-mers
    enumerated via sorted 3-mer product tables with threshold pruning
    (KmerGenerator.cpp:104-230)
  * double-diagonal detection: an arrival-ordered hit is "double" when
    the previous hit of the same target had the same u8 diagonal —
    including the zero-init quirk where a first hit on diagonal 0 counts
    (CacheFriendlyOperations.cpp:193-208)
  * surviving (target, diagonal) pairs are rescored by an ungapped
    Kadane scan of the blosum62 2-bit profile (+bias/4) along the
    diagonal, clamped at 255 (UngappedAlignment.cpp:30-43,385-414)
  * per-target max score, histogram-capped at --max-seqs with
    min-ungapped-score 15 floor (QueryMatcher.h:206-216)

Profile queries (`query_profiles`, the later rounds of the iterative
search) run through the engine's profile matcher: per query position the
PSSM row ranked descending (`ranked_desc_sort20`), the k-mer beam as the
product of the ranked rows with per-level pruning, the profile k-mer
threshold table, no composition bias, and the pssm/4 rescore.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..constants import X_INDEX
from ..db.setdb import SetDB
from ..native import tantan_mask_batch
from ..stats.submat import SubstitutionMatrix, load_pinned_matrix
from ..utils import trace

SPACED_PATTERN_6 = np.array([0, 1, 3, 5, 8, 9], dtype=np.int32)
KMER_SIZE = 6
SEED_ALPHA = 20          # X excluded from seeding

# spaced seed patterns per k (Sequence.h:24-33 spaced_seed_k)
KMER_PATTERNS = {
    6: SPACED_PATTERN_6,
    7: np.array([0, 1, 3, 5, 6, 9, 10], dtype=np.int32),
}


def kmer_pattern(kmer_size: int, spaced: bool = True) -> np.ndarray:
    """Seed pattern for one k: the spaced pattern (Sequence.h:24-33,
    --spaced-kmer-mode 1, the default) or the consecutive window
    (--spaced-kmer-mode 0, Sequence.cpp spacedKmer=false)."""
    if spaced:
        return KMER_PATTERNS[kmer_size]
    return np.arange(kmer_size, dtype=np.int32)


# IndexTable::computeKmerSize boundary (IndexTable.h:439-441); module
# constant so tests can scale it down and exercise the size-triggered
# k=7 path end-to-end without a 3.35 G-residue database
K7_THRESHOLD_RESIDUES = 3350000000


def compute_kmer_size(total_residues: int) -> int:
    """IndexTable::computeKmerSize (IndexTable.h:439-441): k=6 below
    ~3.35 G residues, k=7 above."""
    return 6 if total_residues < K7_THRESHOLD_RESIDUES else 7


def kmer_score_threshold(sensitivity: float, kmer_size: int = 6,
                         profile: bool = False) -> int:
    """Prefiltering::getKmerThreshold tables (Prefiltering.cpp:1020-1065);
    profile values are the no-context-pseudocount table."""
    if profile:
        table = {5: (108.8, 4.7), 6: (134.35, 6.15), 7: (149.15, 6.85)}
    else:
        table = {5: (160.75, 12.75), 6: (163.2, 8.917), 7: (186.15, 11.22)}
    base, per_step = table[kmer_size]
    return int(np.float32(base) - np.float32(sensitivity) * np.float32(per_step))


_SORT20_NETWORK: list[tuple[int, int]] = [
    # Util::rankedDescSort20's fixed sorting network (Util.cpp:88-114);
    # ties resolve exactly as the swap sequence dictates.
    (0, 16), (1, 17), (2, 18), (3, 19), (4, 12), (5, 13), (6, 14), (7, 15),
    (0, 8), (1, 9), (2, 10), (3, 11),
    (8, 16), (9, 17), (10, 18), (11, 19), (0, 4), (1, 5), (2, 6), (3, 7),
    (8, 12), (9, 13), (10, 14), (11, 15), (4, 16), (5, 17), (6, 18), (7, 19),
    (0, 2), (1, 3),
    (4, 8), (5, 9), (6, 10), (7, 11), (12, 16), (13, 17), (14, 18), (15, 19),
    (0, 1),
    (4, 6), (5, 7), (8, 10), (9, 11), (12, 14), (13, 15), (16, 18), (17, 19),
    (2, 16), (3, 17), (6, 12), (7, 13), (18, 19),
    (2, 8), (3, 9), (10, 16), (11, 17),
    (2, 4), (3, 5), (6, 8), (7, 9), (10, 12), (11, 13), (14, 16), (15, 17),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13), (14, 15), (16, 17),
    (1, 16), (3, 18), (5, 12), (7, 14),
    (1, 8), (3, 10), (9, 16), (11, 18),
    (1, 4), (3, 6), (5, 8), (7, 10), (9, 12), (11, 14), (13, 16), (15, 18),
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
    (17, 18),
]


def ranked_desc_sort20(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Network-sort each row of (L, 20) descending; returns (scores, idx)."""
    v = vals.astype(np.int16).copy()
    idx = np.tile(np.arange(SEED_ALPHA, dtype=np.int32), (v.shape[0], 1))
    for x, y in _SORT20_NETWORK:
        swap = v[:, x] < v[:, y]
        vx, vy = v[swap, x].copy(), v[swap, y].copy()
        v[swap, x], v[swap, y] = vy, vx
        ix, iy = idx[swap, x].copy(), idx[swap, y].copy()
        idx[swap, x], idx[swap, y] = iy, ix
    return v, idx


@dataclass
class SeedTables:
    """Sorted part-k-mer score tables (ExtendedSubstitutionMatrix
    equivalent): (R, R) with R = 20^part_size (8000 for 3-mers, 400 for
    the 2-mer tables of odd k)."""
    scores: np.ndarray   # (R, R) int16, per row sorted desc
    idx: np.ndarray      # (R, R) int16, part-k-mer indices per sorted row


@lru_cache(maxsize=8)
def _build_part_tables(matrix_name: str, part: int) -> SeedTables:
    """Sorted part-k-mer product tables for part in {2, 3}
    (ExtendedSubstitutionMatrix two/three)."""
    from ..utils.cache import artifact_path
    sc_path = artifact_path(f"seed{part}_{matrix_name}_scores.npy")
    id_path = artifact_path(f"seed{part}_{matrix_name}_idx.npy")
    if sc_path.exists() and id_path.exists():
        sorted_scores = np.load(sc_path, mmap_mode="r")
        order = np.load(id_path, mmap_mode="r")
    else:
        m = load_pinned_matrix(matrix_name)
        sub = m.sub_int[:SEED_ALPHA, :SEED_ALPHA].astype(np.int32)
        # scores[(x0..xp),(y0..yp)] = sum_i sub[xi, yi] with index packing
        # idx = sum_i xi * 20^i (Indexer.h:21-35)
        one = np.ones((SEED_ALPHA, SEED_ALPHA), dtype=np.int32)
        scores = np.zeros((SEED_ALPHA ** part,) * 2, dtype=np.int32)
        for i in range(part):
            # digit i (fastest = 0) varies with the i-th innermost factor
            t = sub
            for _ in range(i):
                t = np.kron(t, one)
            for _ in range(part - 1 - i):
                t = np.kron(one, t)
            scores = scores + t
        # tie order: the reference stable-sorts in cartesian-product order,
        # i.e. lexicographic in (x0..xp) — the digit-REVERSED packing
        # (ExtendedSubstitutionMatrix.cpp:38-56). rev is a bijection, so
        # the composite (-score, rev) key is unique and a plain unstable
        # argsort reproduces lexsort((rev, -score)) exactly.
        R = SEED_ALPHA ** part
        j = np.arange(R, dtype=np.int32)
        rev = np.zeros(R, dtype=np.int32)
        tmp = j.copy()
        for _ in range(part):
            rev = rev * SEED_ALPHA + tmp % SEED_ALPHA
            tmp = tmp // SEED_ALPHA
        key = (-scores << 13) + rev[None, :]
        order = np.argsort(key, axis=1, kind="quicksort").astype(np.int16)
        sorted_scores = np.take_along_axis(
            scores.astype(np.int16), order.astype(np.int64), axis=1)
        # per-process temporaries: concurrent first builds must not
        # write into one file
        tmp_sc = sc_path.with_suffix(f".{os.getpid()}.tmp.npy")
        tmp_id = id_path.with_suffix(f".{os.getpid()}.tmp.npy")
        np.save(tmp_sc, sorted_scores)
        np.save(tmp_id, order)
        tmp_sc.rename(sc_path)
        tmp_id.rename(id_path)
        sorted_scores = np.load(sc_path, mmap_mode="r")
        order = np.load(id_path, mmap_mode="r")
    return SeedTables(scores=sorted_scores, idx=order)


def build_seed_tables(matrix_name: str = "vtml80_bf8_bias") -> SeedTables:
    return _build_part_tables(matrix_name, 3)


def build_seed_tables2(matrix_name: str = "vtml80_bf8_bias") -> SeedTables:
    return _build_part_tables(matrix_name, 2)


def spaced_kmers(seq: np.ndarray, kmer_size: int = 6,
                 pattern: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """All spaced k-mer windows: returns (window_starts, kmer_residues (N,k))."""
    if pattern is None:
        pattern = KMER_PATTERNS[kmer_size]
    span = int(pattern[-1]) + 1
    L = len(seq)
    n = L - span + 1
    if n <= 0:
        return np.empty(0, np.int32), np.empty((0, kmer_size), np.uint8)
    starts = np.arange(n, dtype=np.int32)
    cols = starts[:, None] + pattern[None, :]
    return starts, seq[cols]


def pack_kmers(kmers: np.ndarray) -> np.ndarray:
    """Indexer::int2index packing: idx = sum kmer[i] * 20^i (Indexer.h:21-90)."""
    powers = SEED_ALPHA ** np.arange(kmers.shape[1], dtype=np.int64)
    return (kmers.astype(np.int64) * powers[None, :]).sum(axis=1)


class KmerIndex:
    """Dense sorted k-mer posting index over the (masked) target DB.

    Built in three native phases, each on the calling thread's OpenMP
    team and each a span inside the caller's (`prefilter.index_build`,
    `structure.index`): `prefilter.index_mask` (tantan over every
    sequence, into the one concatenated `t_data`),
    `prefilter.index_postings` (the postings in (kmer, seq, pos) order)
    and `prefilter.index_hash` (the posting-range hash)."""

    def __init__(self, target_db: SetDB, kmer_thr: int,
                 seed_matrix: SubstitutionMatrix | None = None,
                 mask: bool = True, kmer_size: int = 6,
                 pattern: np.ndarray | None = None):
        self.tdb = target_db
        self.seed = seed_matrix or load_pinned_matrix("vtml80_bf8_bias")
        self.kmer_thr = kmer_thr
        self.kmer_size = kmer_size
        self.pattern = (pattern if pattern is not None
                        else KMER_PATTERNS[kmer_size])
        offsets = target_db.offsets
        # concatenated masked target residues (the engine's rescore
        # input); masking keeps lengths (Masker semantics)
        with trace.span("prefilter.index_mask"):
            if mask:
                ratio = self.seed.prob / (self.seed.p_back[:, None]
                                          * self.seed.p_back[None, :])
                self.t_data = tantan_mask_batch(target_db.seq_data, offsets,
                                                ratio, X_INDEX)
            else:
                self.t_data = target_db.seq_data[
                    offsets[0]:offsets[-1]].astype(np.uint8)
        self.t_offsets = (offsets[:-1] - offsets[0]).astype(np.int64)
        # native parallel build (IndexBuilder::fillDatabase analog);
        # emits postings in (kmer, seq, pos) order.  The posting-range
        # structure is a compact hash + occupancy bitmap, NOT a dense
        # 20^6 offset table: two 256 MB fresh tables per process cost
        # seconds of first-touch page faults on the target host.
        from ..native import build_kmer_index
        with trace.span("prefilter.index_postings") as sp:
            (self.kmers, self.seq_ids, self.positions,
             threads) = build_kmer_index(
                self.t_data, self.t_offsets, target_db.lengths,
                np.diagonal(self.seed.sub_int).astype(np.int32),
                X_INDEX, self.kmer_thr, kmer_size=self.kmer_size,
                pattern=self.pattern)
            sp.attrs.update(postings=len(self.kmers), threads=threads)
        self._finish_hash()

    @property
    def masked(self) -> list[np.ndarray]:
        """Each target's masked residues: views into `t_data`."""
        bounds = np.append(self.t_offsets, len(self.t_data))
        return [self.t_data[bounds[i]:bounds[i + 1]]
                for i in range(len(self.t_offsets))]

    def _finish_hash(self) -> None:
        # compact posting-range hash + occupancy bitmap for the native
        # match engine
        from ..native import build_kmer_hash
        with trace.span("prefilter.index_hash") as sp:
            (self.hkeys, self.hoff, self.hcnt, self.occupied,
             unique) = build_kmer_hash(self.kmers,
                                       SEED_ALPHA ** self.kmer_size)
            sp.attrs.update(unique_kmers=unique)

    # -- persistence (the PrefilteringIndexReader analog,
    #    lib/mmseqs/src/prefiltering/PrefilteringIndexReader.cpp): the
    #    sorted postings + masked tokens are saved; the dense offset
    #    table is rebuilt on load (the native fill takes ~0.15 s, far
    #    cheaper than persisting 256 MB). The cache key carries the
    #    build settings + DB shape.
    FORMAT_VERSION = 2

    def save(self, path: str | Path) -> None:
        path = str(path)
        np.savez(path, version=self.FORMAT_VERSION, kmer_thr=self.kmer_thr,
                 kmer_size=self.kmer_size,
                 n_seqs=self.tdb.size, total_res=self.tdb.total_residues,
                 kmers=self.kmers,
                 seq_ids=self.seq_ids, positions=self.positions,
                 t_data=self.t_data, t_offsets=self.t_offsets)

    @classmethod
    def load(cls, path: str | Path, target_db: SetDB, kmer_thr: int,
             seed_matrix: SubstitutionMatrix | None = None,
             kmer_size: int = 6,
             pattern: np.ndarray | None = None) -> "KmerIndex | None":
        try:
            z = np.load(path)
        except (OSError, ValueError):
            return None
        if (int(z["version"]) != cls.FORMAT_VERSION
                or int(z["kmer_thr"]) != kmer_thr
                or int(z.get("kmer_size", 6)) != kmer_size
                or int(z["n_seqs"]) != target_db.size
                or int(z["total_res"]) != target_db.total_residues):
            return None
        self = cls.__new__(cls)
        self.tdb = target_db
        self.seed = seed_matrix or load_pinned_matrix("vtml80_bf8_bias")
        self.kmer_thr = kmer_thr
        self.kmer_size = kmer_size
        self.pattern = (pattern if pattern is not None
                        else KMER_PATTERNS[kmer_size])
        self.t_data = z["t_data"]
        self.t_offsets = z["t_offsets"]
        self.kmers = z["kmers"]
        self.seq_ids = z["seq_ids"]
        self.positions = z["positions"]
        self._finish_hash()
        return self


@dataclass
class PrefilterHit:
    seq_id: int
    score: int
    diagonal: int  # u16 semantics (i - j wrapped)


class PrefilterEngine:
    def __init__(self, query_db: SetDB, target_db: SetDB,
                 sensitivity: float = 5.7,
                 max_seqs: int = 300,
                 min_diag_score: int = 15,
                 same_qt_db: bool | None = None,
                 comp_bias_correction: bool = True,
                 mask: bool = True,
                 cov_thr: float = 0.0,
                 cov_mode: int = 0,
                 query_profiles: dict[int, np.ndarray] | None = None,
                 index: "KmerIndex | None" = None,
                 seed_matrix_name: str = "vtml80_bf8_bias",
                 ungapped_matrix_name: str = "blosum62_bf2_bias",
                 kmer_thr: int | None = None,
                 kmer_size: int | None = None,
                 spaced_kmer_mode: int = 1):
        """`query_profiles` maps query keys to (L, 20) int16 PSSM scores
        (the 8-bit-scaled profile_score rows, Sequence.cpp:241-264); such
        queries use per-position k-mer generation, the profile k-mer
        threshold table and no composition bias, and the target index is
        built at threshold 0.  An existing `index` can be shared across
        engines."""
        self.qdb = query_db
        self.tdb = target_db
        self.query_profiles = query_profiles or {}
        # the prefilter builds matrices with scoreBias=-0.2 (Prefiltering.cpp:992)
        self.seed = load_pinned_matrix(seed_matrix_name)
        self.ungapped = load_pinned_matrix(ungapped_matrix_name)
        # k auto-raises to 7 on >3.35 G-residue DBs
        # (IndexTable::computeKmerSize, IndexTable.h:439-441)
        self.kmer_size = (kmer_size if kmer_size is not None
                          else compute_kmer_size(target_db.total_residues))
        self.spaced_kmer_mode = spaced_kmer_mode
        self.pattern = kmer_pattern(self.kmer_size, spaced_kmer_mode != 0)
        self.kmer_thr = (kmer_thr if kmer_thr is not None
                         else kmer_score_threshold(
                             sensitivity, self.kmer_size,
                             profile=bool(self.query_profiles)))
        self.max_seqs = max_seqs
        self.min_diag_score = min_diag_score
        self.comp_bias = comp_bias_correction
        self.cov_thr = cov_thr
        self.cov_mode = cov_mode
        self.same_qt_db = (same_qt_db if same_qt_db is not None
                           else query_db is target_db)
        self.tables = build_seed_tables(seed_matrix_name)
        self.tables2 = (build_seed_tables2(seed_matrix_name)
                        if self.kmer_size % 3 != 0 else None)
        # with profile queries the index is seeded at threshold 0
        # (localKmerThr, Prefiltering.cpp:525-528): every k-mer is posted
        index_thr = 0 if self.query_profiles else self.kmer_thr
        if index is not None:
            self.index = index
        else:
            self.index = None
            cache = None
            if getattr(target_db, "path", None):
                from pathlib import Path as _P
                import hashlib as _h
                # cheap content fingerprint: first/last residue bytes +
                # offsets, so a same-shaped DB with different contents
                # cannot load a stale index (ADVICE r2)
                sd = target_db.seq_data
                fp = _h.sha1(sd[:4096].tobytes() + sd[-4096:].tobytes()
                             + target_db.offsets.tobytes()).hexdigest()[:10]
                sp = ("" if spaced_kmer_mode != 0
                      else f"_sp{spaced_kmer_mode}")
                cache = (_P(target_db.path)
                         / f"kmeridx_k{self.kmer_size}_t{index_thr}"
                           f"_m{int(mask)}_{seed_matrix_name}{sp}_{fp}.npz")
                if cache.exists():
                    self.index = KmerIndex.load(cache, target_db, index_thr,
                                                self.seed,
                                                kmer_size=self.kmer_size,
                                                pattern=self.pattern)
            if self.index is None:
                self.index = KmerIndex(target_db, index_thr, self.seed,
                                       mask=mask, kmer_size=self.kmer_size,
                                       pattern=self.pattern)
                if cache is not None:
                    try:
                        with trace.span("prefilter.index_save"):
                            self.index.save(cache)
                    except OSError:
                        pass
        self._bin_count = compute_bin_count(target_db.size)
        self._tlens = target_db.lengths

    def match_all(self, qkeys: list[int] | None = None
                  ) -> dict[int, list[PrefilterHit]]:
        """Prefilter the queries `qkeys` (default: all): the profile
        queries in one batch of the profile matcher, then the sequence
        queries in their order, each run of consecutive keys one
        match_range call, so that a same-DB search keeps its identity
        semantics for any key list (the native engine maps batch rows to
        keys by range start)."""
        keys = list(range(self.qdb.size) if qkeys is None else qkeys)
        out: dict[int, list[PrefilterHit]] = {}
        prof_keys = [qk for qk in keys if qk in self.query_profiles]
        if prof_keys:
            out.update(self._match_profiles(prof_keys))
            keys = [qk for qk in keys if qk not in self.query_profiles]
        s = 0
        while s < len(keys):
            e = s + 1
            while e < len(keys) and keys[e] == keys[e - 1] + 1:
                e += 1
            out.update(self.match_range(keys[s], keys[e - 1] + 1))
            s = e
        return out

    def _match_profiles(self, pkeys: list[int]
                        ) -> dict[int, list[PrefilterHit]]:
        """Profile queries through the native batch matcher: ranked PSSM
        rows and the per-position product beam, the pssm/4 rescore, the
        identity slot by explicit per-row key."""
        from ..native import prefilter_match_profile_batch
        pssms = [np.ascontiguousarray(self.query_profiles[qk],
                                      dtype=np.int16) for qk in pkeys]
        lens = np.array([p.shape[0] for p in pssms], dtype=np.int32)
        qoffs = np.concatenate(([0], np.cumsum(lens, dtype=np.int64)))
        cat = np.concatenate(pssms)
        rs, ri = ranked_desc_sort20(cat)
        qseq = np.concatenate([self.qdb.sequence(qk) for qk in pkeys])
        identity = (np.array(pkeys, dtype=np.int32) if self.same_qt_db
                    else None)
        idx = self.index
        # the profile matcher seeds with the spaced pattern of the k-mer
        # size, whatever --spaced-kmer-mode says
        o_seq, o_score, o_diag, o_cnt, _raw = prefilter_match_profile_batch(
            np.ascontiguousarray(rs, dtype=np.int16),
            np.ascontiguousarray(ri.astype(np.uint8)),
            np.ascontiguousarray(cat, dtype=np.int16),
            np.ascontiguousarray(qseq, dtype=np.uint8), X_INDEX,
            qoffs, lens,
            idx.hkeys, idx.hoff, idx.hcnt, idx.occupied,
            np.ascontiguousarray(idx.seq_ids, dtype=np.int32),
            np.ascontiguousarray(idx.positions, dtype=np.int32),
            np.ascontiguousarray(idx.t_data, dtype=np.uint8),
            np.ascontiguousarray(idx.t_offsets, dtype=np.int64),
            np.ascontiguousarray(self._tlens, dtype=np.int32),
            21, self.kmer_thr, self.max_seqs, self.min_diag_score,
            self._bin_count, identity, self.cov_thr, self.cov_mode,
            kmer_size=self.kmer_size,
            pattern=KMER_PATTERNS[self.kmer_size])
        out: dict[int, list[PrefilterHit]] = {}
        for bi, qk in enumerate(pkeys):
            n = int(o_cnt[bi])
            base = bi * self.max_seqs
            out[qk] = [PrefilterHit(seq_id=int(o_seq[base + i]),
                                    score=int(o_score[base + i]),
                                    diagonal=int(o_diag[base + i]))
                       for i in range(n)]
        return out

    def match_range(self, start: int, end: int
                    ) -> dict[int, list[PrefilterHit]]:
        """Prefilter a contiguous query-key range (the streaming loop's
        unit of work; identity semantics preserved via identity_base)."""
        qdb = self.qdb
        qoffs_all = qdb.offsets
        qdata = np.ascontiguousarray(
            qdb.seq_data[qoffs_all[start]:qoffs_all[end]], dtype=np.uint8)
        qoffs = np.ascontiguousarray(
            qoffs_all[start:end] - qoffs_all[start], dtype=np.int64)
        qlens = np.ascontiguousarray(qdb.lengths[start:end], dtype=np.int32)
        base = start if self.same_qt_db else -1
        # a chunk is named by its first query key (`prefilter.wait` too)
        with trace.span("prefilter.match", chunk=int(start),
                        queries=int(end - start)):
            hits = self._match_native(qdata, qoffs, qlens, base)
            return {start + i: h for i, h in enumerate(hits)}

    def _match_native(self, qdata, qoffs, qlens, identity_base
                      ) -> list[list[PrefilterHit]]:
        from ..native import prefilter_match_batch
        idx = self.index
        o_seq, o_score, o_diag, o_cnt, _raw = prefilter_match_batch(
            qdata, qoffs, qlens,
            np.ascontiguousarray(self.seed.sub_int, dtype=np.int32),
            np.ascontiguousarray(self.seed.p_back, dtype=np.float64),
            self.comp_bias,
            np.ascontiguousarray(self.tables.scores, dtype=np.int16),
            np.ascontiguousarray(self.tables.idx, dtype=np.int16),
            idx.hkeys, idx.hoff, idx.hcnt, idx.occupied,
            np.ascontiguousarray(idx.seq_ids, dtype=np.int32),
            np.ascontiguousarray(idx.positions, dtype=np.int32),
            np.ascontiguousarray(idx.t_data, dtype=np.uint8),
            np.ascontiguousarray(idx.t_offsets, dtype=np.int64),
            np.ascontiguousarray(self._tlens, dtype=np.int32),
            np.ascontiguousarray(self.ungapped.sub_int, dtype=np.int32),
            X_INDEX, self.kmer_thr, self.max_seqs, self.min_diag_score,
            self._bin_count, identity_base, self.cov_thr, self.cov_mode,
            kmer_size=self.kmer_size, pattern=self.pattern,
            sc2=(np.ascontiguousarray(self.tables2.scores, dtype=np.int16)
                 if self.tables2 is not None else None),
            id2=(np.ascontiguousarray(self.tables2.idx, dtype=np.int16)
                 if self.tables2 is not None else None))
        n_q = len(qlens)
        out = []
        for bi in range(n_q):
            n = int(o_cnt[bi])
            base = bi * self.max_seqs
            out.append([PrefilterHit(seq_id=int(o_seq[base + i]),
                                     score=int(o_score[base + i]),
                                     diagonal=int(o_diag[base + i]))
                        for i in range(n)])
        # prefilter statistics (the printStatistics analog,
        # Prefiltering.cpp:953-975), accumulated across streamed chunks
        counts = np.asarray(o_cnt[:n_q], dtype=np.int64)
        prev = getattr(self, "stats", None) or {
            "db_matches": 0, "sum_passed": 0, "empty_lists": 0,
            "queries": 0, "_counts": []}
        prev.setdefault("_counts", [])
        prev["db_matches"] = prev.get("db_matches", 0) + int(_raw)
        prev["sum_passed"] = prev.get("sum_passed", 0) + int(counts.sum())
        prev["empty_lists"] += int((counts == 0).sum())
        prev["queries"] += n_q
        prev["_counts"].append(counts)
        nq = max(1, prev["queries"])
        prev["db_matches_per_seq"] = prev["db_matches"] // nq
        prev["passed_per_seq"] = prev["sum_passed"] / nq
        prev["median_result_list"] = int(
            np.median(np.concatenate(prev["_counts"])))
        self.stats = prev
        return out


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def compute_bin_count(db_size: int) -> int:
    """QueryMatcher::initDiagonalMatcher's L2-derived bin count
    (QueryMatcher.cpp:424-451); affects only the order of tie-scored hits
    at the --max-seqs cut."""
    try:
        l2 = os.sysconf("SC_LEVEL2_CACHE_SIZE")
        if l2 <= 0:
            l2 = 2 * 1024 * 1024
    except (ValueError, OSError):
        l2 = 2 * 1024 * 1024
    for n in (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024):
        if db_size // n < l2:
            return n
    return 2048


def _find_double_diagonals(seqs: np.ndarray, diags: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Arrival-order double-diagonal detection + consecutive dedup
    (CacheFriendlyOperations::findDuplicates, computeTotalScore=false)."""
    if len(seqs) == 0:
        return (np.empty(0, np.int32), np.empty(0, np.uint16),
                np.empty(0, np.int64))
    diag8 = (diags & 0xFF).astype(np.uint8)
    order = np.argsort(seqs, kind="stable")  # per-seq arrival order preserved
    s_sorted = seqs[order]
    d_sorted = diag8[order]
    first = np.concatenate(([True], s_sorted[1:] != s_sorted[:-1]))
    prev = np.concatenate(([0], d_sorted[:-1]))
    # zero-init quirk: first element of a seq matches prev diag 0
    detected = np.where(first, d_sorted == 0, d_sorted == prev)

    det_idx = np.nonzero(detected)[0]
    if len(det_idx) == 0:
        return (np.empty(0, np.int32), np.empty(0, np.uint16),
                np.empty(0, np.int64))
    ds = s_sorted[det_idx]
    dd = d_sorted[det_idx]
    dfull = diags[order][det_idx]
    arrival = order[det_idx]  # global arrival position of each detection
    # phase 2: drop consecutive same-diag duplicates per seq
    first2 = np.concatenate(([True], ds[1:] != ds[:-1]))
    prev2 = np.concatenate(([0], dd[:-1]))
    keep = first2 | (dd != prev2)
    ds = ds[keep]
    dfull = dfull[keep]
    arrival = arrival[keep]
    # dedupe (seq, diag) keeping the FIRST occurrence in per-seq arrival
    # order — keepMaxElement later keeps the first max-scored entry
    # (CacheFriendlyOperations.cpp:358-377)
    key = ds.astype(np.int64) * (1 << 16) + dfull.astype(np.int64)
    _, first_idx = np.unique(key, return_index=True)
    first_idx.sort()
    return (ds[first_idx].astype(np.int32), dfull[first_idx].astype(np.uint16),
            arrival[first_idx].astype(np.int64))


def _per_target_max(seqs: np.ndarray, diags: np.ndarray, scores: np.ndarray,
                    arrival: np.ndarray, bin_count: int) -> np.ndarray:
    """Keep the max-scoring diagonal per target — FIRST in per-seq arrival
    order among ties (keepMaxElement) — and return entries in the
    bin-major (seq & mask) detection-stream order that feeds the radix
    sort. Returns (N,3) [seq, diag, score].
    """
    if len(seqs) == 0:
        return np.empty((0, 3), np.int64)
    order = np.lexsort((np.arange(len(seqs)), -scores, seqs))
    s = seqs[order]
    first = np.concatenate(([True], s[1:] != s[:-1]))
    sel = order[first]
    bins = seqs[sel].astype(np.int64) & (bin_count - 1)
    stream = np.lexsort((arrival[sel], bins))
    sel = sel[stream]
    return np.stack([seqs[sel].astype(np.int64), diags[sel].astype(np.int64),
                     scores[sel].astype(np.int64)], axis=1)


def _score_threshold(hits: np.ndarray, max_hits: int) -> int:
    """computeScoreThreshold (QueryMatcher.h:206-216)."""
    bins = np.bincount(np.clip(hits[:, 2], 0, 255).astype(np.int64),
                       minlength=256) if len(hits) else np.zeros(256, np.int64)
    found = 0
    for thr in range(255, 0, -1):
        found += int(bins[thr])
        if found >= max_hits:
            return thr
    return 0
