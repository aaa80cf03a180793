"""Native (C++/OpenMP) host engines: k-mer index and prefilter (sequence
and profile queries; the cached-beam probes of the concurrent target
split), tantan masking, composition bias, banded traceback (sequence,
profile and profile-profile), the banded nucleotide aligner,
clusterhits, and the profile helpers (global PSSM bias correction,
target-profile k-mer postings).

The sources are the JAX package's, copied, but for `profile_native.cpp`,
which is the port's own (the JAX package runs those two as numpy loops,
search/profile.py and search/profilesearch.py); `banded_sw.cpp` here writes its compressed
CIGARs without the one-byte overrun of the original.  The
shared library is compiled with g++ at first use into the package's
`_build/` directory (content-hashed, git-ignored).  Only the symbols the
port's paths call are bound, and `banded_align_profile_profile`, which no
command calls in either package (library parity).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
_SOURCES = ["banded_sw.cpp", "tantan.cpp", "simd_helpers.cpp",
            "prefilter_engine.cpp", "clusterhits_engine.cpp",
            "profile_native.cpp", "nucl_align.cpp"]
_LIB = None
_LOCK = threading.Lock()


def build() -> Path:
    srcs = [_DIR / s for s in _SOURCES]
    tag = hashlib.sha1(b"".join(s.read_bytes() for s in srcs)).hexdigest()[:12]
    out = BUILD_DIR / f"_native_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             *[str(s) for s in srcs], "-o", str(tmp)],
            check=True, capture_output=True)
        tmp.rename(out)
    return out


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P = ctypes.POINTER
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.comp_bias_batch.restype = None
    lib.comp_bias_batch.argtypes = [
        P(ctypes.c_uint8), P(i64), P(i32), ctypes.c_int,
        P(i32), ctypes.c_int, P(ctypes.c_double), P(ctypes.c_int8)]
    lib.prefilter_match_batch.restype = ctypes.c_int
    lib.prefilter_match_batch.argtypes = [
        P(ctypes.c_uint8),   # qdata
        P(i64),              # qoffs
        P(i32),              # qlens
        ctypes.c_int,        # nq
        P(i32),              # seed_sub
        P(ctypes.c_double),  # p_back
        ctypes.c_int, ctypes.c_int,       # nsym, do_bias
        P(ctypes.c_int16),   # sc3
        P(ctypes.c_int16),   # id3
        P(ctypes.c_int16),   # sc2 (nullable for k%3==0)
        P(ctypes.c_int16),   # id2
        ctypes.c_int,        # kmer_size
        P(i32),              # spaced pattern
        P(i32),              # hash keys
        P(i32),              # hash range starts
        P(i32),              # hash range counts
        i64,                 # hash capacity
        P(ctypes.c_uint64),  # occupied bitmap
        P(i32),              # post_seq
        P(i32),              # post_pos
        P(ctypes.c_uint8),   # tdata
        P(i64),              # toffs
        P(i32),              # tlens
        ctypes.c_int,        # nt
        P(i32),              # ungapped_sub
        ctypes.c_int, ctypes.c_int,       # alpha, x_index
        ctypes.c_int, ctypes.c_int,       # kmer_thr, max_seqs
        ctypes.c_int, ctypes.c_int,       # min_diag_score, bin_count
        ctypes.c_int,                     # same_db
        ctypes.c_float, ctypes.c_int,     # cov_thr, cov_mode
        i64,                 # match buffer cap (0=auto)
        P(i32), P(i32), P(i32), P(i32),   # out_seq/score/diag/cnt
        P(i64),              # total_raw_out
    ]
    lib.prefilter_match_profile_batch.restype = ctypes.c_int
    lib.prefilter_match_profile_batch.argtypes = [
        P(ctypes.c_int16),   # rank_s (Ltot, 20)
        P(ctypes.c_uint8),   # rank_i (Ltot, 20)
        P(ctypes.c_int16),   # qprof (Ltot, 20)
        P(ctypes.c_uint8),   # qseq (profile residues)
        ctypes.c_int,        # x_index
        P(i64),              # qoffs (position offsets)
        P(i32),              # qlens
        ctypes.c_int,        # nq
        ctypes.c_int,        # kmer_size
        P(i32),              # spaced pattern
        P(i32),              # hash keys
        P(i32),              # hash range starts
        P(i32),              # hash range counts
        i64,                 # hash capacity
        P(ctypes.c_uint64),  # occupied bitmap
        P(i32),              # post_seq
        P(i32),              # post_pos
        P(ctypes.c_uint8),   # tdata
        P(i64),              # toffs
        P(i32),              # tlens
        ctypes.c_int,        # nt
        ctypes.c_int,        # alpha
        ctypes.c_int, ctypes.c_int,       # kmer_thr, max_seqs
        ctypes.c_int, ctypes.c_int,       # min_diag_score, bin_count
        P(i32),              # identity_keys (nullable)
        ctypes.c_float, ctypes.c_int,     # cov_thr, cov_mode
        P(i32), P(i32), P(i32), P(i32),   # out_seq/score/diag/cnt
        P(i64),              # total_raw_out
    ]
    lib.tantan_mask.restype = ctypes.c_int
    lib.tantan_mask.argtypes = [
        P(ctypes.c_uint8),                # seq (in/out)
        ctypes.c_int,                     # n
        P(ctypes.c_double),               # ratio matrix
        ctypes.c_int,                     # alpha
        ctypes.c_int,                     # max_offset
        ctypes.c_double, ctypes.c_double,  # repeat_prob, repeat_end_prob
        ctypes.c_double, ctypes.c_double,  # decay, min_mask_prob
        ctypes.c_uint8,                   # mask_to
        P(ctypes.c_float),                # probs_out (nullable)
    ]
    lib.build_kmer_index.restype = ctypes.c_int
    lib.build_kmer_index.argtypes = [
        P(ctypes.c_uint8), P(i64), P(i32), ctypes.c_int, P(i32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, P(i32), P(i32), P(i32),
        P(i32), P(i64)]
    lib.build_kmer_hash.restype = ctypes.c_int
    lib.build_kmer_hash.argtypes = [
        P(i32), i64, P(i32), P(i32), P(i32), i64, P(ctypes.c_uint64), i64]
    lib.banded_align_batch.restype = ctypes.c_int
    lib.banded_align_batch.argtypes = [
        P(ctypes.c_uint8), P(i64), P(ctypes.c_uint8), P(i64),
        P(ctypes.c_int8), P(ctypes.c_int8), ctypes.c_int, ctypes.c_int,
        P(i32), P(i32), P(i32), P(i32), P(i32), P(i32), P(i32),
        ctypes.c_int, ctypes.c_int, P(i64), ctypes.c_char_p, P(i32), P(i32),
        ctypes.c_char_p, P(i32)]
    lib.banded_align_profile.restype = ctypes.c_int
    lib.banded_align_profile.argtypes = [
        P(ctypes.c_uint8),                # t
        ctypes.c_int, ctypes.c_int,       # q_len, t_len
        P(ctypes.c_int8),                 # prof [aa][qpos]
        ctypes.c_int, ctypes.c_int,       # prof_qlen, query_start
        ctypes.c_int,                     # score
        ctypes.c_int, ctypes.c_int,       # gap_open, gap_extend
        ctypes.c_int,                     # band_width
        ctypes.c_char_p, ctypes.c_int]    # out, cap
    lib.banded_align_profile_profile.restype = ctypes.c_int
    lib.banded_align_profile_profile.argtypes = [
        P(ctypes.c_uint8), P(ctypes.c_uint8),   # t, qcons (consensus)
        ctypes.c_int, ctypes.c_int,       # q_len, t_len
        P(ctypes.c_int8),                 # qprof [aa][qpos]
        ctypes.c_int, ctypes.c_int,       # qprof_qlen, query_start
        P(ctypes.c_int8),                 # tprof [aa][tpos]
        ctypes.c_int, ctypes.c_int,       # tprof_tlen, target_start
        ctypes.c_int,                     # score
        ctypes.c_int, ctypes.c_int,       # gap_open, gap_extend
        ctypes.c_int,                     # band_width
        ctypes.c_char_p, ctypes.c_int]    # out, cap
    lib.global_aa_bias_correction.restype = None
    lib.global_aa_bias_correction.argtypes = [
        P(ctypes.c_int8), P(ctypes.c_float), i64, P(ctypes.c_int8)]
    lib.profile_kmer_postings.restype = ctypes.c_int
    lib.profile_kmer_postings.argtypes = [
        P(ctypes.c_int16), P(i64), ctypes.c_int, P(i32), ctypes.c_int,
        ctypes.c_int, P(ctypes.c_uint8), P(i64), P(i64), P(i32)]
    lib.w_contrib_rcp.restype = None
    lib.w_contrib_rcp.argtypes = [P(i32), P(i32), ctypes.c_int,
                                  P(ctypes.c_float)]
    lib.banded_align_profile_u16.restype = ctypes.c_int
    lib.banded_align_profile_u16.argtypes = [
        P(ctypes.c_uint16),               # t (wide symbols)
        ctypes.c_int, ctypes.c_int,       # q_len, t_len
        P(ctypes.c_int8),                 # prof [sym][qpos]
        ctypes.c_int, ctypes.c_int,       # prof_qlen, query_start
        ctypes.c_int,                     # score
        ctypes.c_int, ctypes.c_int,       # gap_open, gap_extend
        ctypes.c_int,                     # band_width
        ctypes.c_char_p, ctypes.c_int]    # out, cap
    lib.cluster_hits_engine.restype = ctypes.c_int
    lib.cluster_hits_engine.argtypes = [
        P(i64), P(i64), P(ctypes.c_uint8), P(ctypes.c_uint8), ctypes.c_int,
        P(ctypes.c_double), i64, i64, ctypes.c_double, ctypes.c_double,
        P(i32), P(i32), P(ctypes.c_double)]
    lib.spacedust_set_threads.restype = ctypes.c_int
    lib.spacedust_set_threads.argtypes = [ctypes.c_int]
    # the concurrent target split: one screened beam a query, partitioned
    # by shard and probed against each shard's index
    lib.prefilter_generate_beams.restype = ctypes.c_int
    lib.prefilter_generate_beams.argtypes = [
        P(ctypes.c_uint8),   # qdata
        P(i64),              # qoffs
        P(i32),              # qlens
        ctypes.c_int,        # nq
        P(i32),              # seed_sub
        P(ctypes.c_double),  # p_back
        ctypes.c_int, ctypes.c_int,       # nsym, do_bias
        P(ctypes.c_int16),   # sc3
        P(ctypes.c_int16),   # id3
        P(ctypes.c_int16),   # sc2 (nullable for k%3==0)
        P(ctypes.c_int16),   # id2
        ctypes.c_int,        # kmer_size
        P(i32),              # spaced pattern
        P(ctypes.c_uint64),  # global bitmap (nullable)
        ctypes.c_int, ctypes.c_int,       # x_index, kmer_thr
        P(P(i32)),           # out kmer
        P(P(i32)),           # out win
        P(i64),              # out_offs (nq+1)
        P(ctypes.c_int8),    # out_corr8 (nullable)
    ]
    lib.free_beam_buffers.restype = None
    lib.free_beam_buffers.argtypes = [P(i32), P(i32)]
    lib.build_shard_mask_table.restype = ctypes.c_int
    lib.build_shard_mask_table.argtypes = [
        P(ctypes.c_uint64),  # shard bitmaps (concat)
        ctypes.c_int, i64,   # n_shards, words_per_shard
        P(ctypes.c_uint8),   # table (words*64 bytes)
    ]
    lib.partition_beams.restype = ctypes.c_int
    lib.partition_beams.argtypes = [
        P(i32),              # beam_kmer
        P(i32),              # beam_win
        P(i64),              # beam_offs
        ctypes.c_int,        # nq
        P(ctypes.c_uint8),   # shard mask table
        ctypes.c_int,        # n_shards
        P(P(i32)),           # out kmer
        P(P(i32)),           # out win
        P(i64),              # out_offs (n_shards*nq+1)
    ]
    lib.prefilter_match_beams.restype = ctypes.c_int
    lib.prefilter_match_beams.argtypes = [
        P(ctypes.c_uint8),   # qdata
        P(i64),              # qoffs
        P(i32),              # qlens
        ctypes.c_int,        # nq
        P(i32),              # seed_sub
        P(ctypes.c_double),  # p_back
        ctypes.c_int, ctypes.c_int,       # nsym, do_bias
        P(ctypes.c_int8),    # corr8 (nullable)
        P(i32),              # beam_kmer
        P(i32),              # beam_win
        P(i64),              # beam_offs
        P(i32),              # hash keys
        P(i32),              # hash range starts
        P(i32),              # hash range counts
        i64,                 # hash capacity
        P(ctypes.c_uint64),  # occupied bitmap (shard)
        P(i32),              # post_seq
        P(i32),              # post_pos
        P(ctypes.c_uint8),   # tdata
        P(i64),              # toffs
        P(i32),              # tlens
        ctypes.c_int,        # nt
        P(i32),              # ungapped_sub
        ctypes.c_int,        # alpha
        ctypes.c_int, ctypes.c_int,       # max_seqs, min_diag_score
        ctypes.c_int, ctypes.c_int,       # bin_count, identity_base
        ctypes.c_float, ctypes.c_int,     # cov_thr, cov_mode
        P(i32), P(i32), P(i32), P(i32),   # out seq / score / diag / cnt
        P(i64)]                           # total_raw_out
    lib.nucl_banded_align.restype = ctypes.c_int
    lib.nucl_banded_align.argtypes = [
        P(ctypes.c_uint8), ctypes.c_int, P(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, P(i32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        P(i32), ctypes.c_char_p, ctypes.c_int]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def tantan_mask(seq: np.ndarray, ratio: np.ndarray, mask_to: int,
                max_offset: int = 50, repeat_prob: float = 0.005,
                repeat_end_prob: float = 0.05, decay: float = 0.9,
                min_mask_prob: float = 0.9) -> np.ndarray:
    """Masked copy of `seq` with low-complexity/tandem repeats set to
    `mask_to`."""
    lib = get_lib()
    out = np.ascontiguousarray(seq, dtype=np.uint8).copy()
    ratio = np.ascontiguousarray(ratio, dtype=np.float64)
    lib.tantan_mask(_ptr(out, ctypes.c_uint8), len(out),
                    _ptr(ratio, ctypes.c_double), ratio.shape[0],
                    max_offset, repeat_prob, repeat_end_prob, decay,
                    min_mask_prob, mask_to, ctypes.POINTER(ctypes.c_float)())
    return out


def comp_bias_batch(qdata, qoffs, qlens, sub_int, p_back):
    """int8 SW-profile composition bias for every query, concatenated in
    the same layout as qdata."""
    lib = get_lib()
    out = np.zeros(len(qdata), dtype=np.int8)
    lib.comp_bias_batch(
        _ptr(qdata, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(qlens, ctypes.c_int32), len(qlens),
        _ptr(sub_int, ctypes.c_int32), sub_int.shape[0],
        _ptr(p_back, ctypes.c_double), _ptr(out, ctypes.c_int8))
    return out


def build_kmer_index(tdata: np.ndarray, toffs: np.ndarray,
                     tlens: np.ndarray, diag_scores: np.ndarray,
                     x_index: int, kmer_thr: int, kmer_size: int,
                     pattern: np.ndarray):
    """Parallel k-mer index build (IndexBuilder::fillDatabase analog).
    Returns (kmers, seq_ids, positions) in (kmer, seq, pos) posting
    order."""
    lib = get_lib()
    pattern = np.ascontiguousarray(pattern, dtype=np.int32)
    span = int(pattern[-1]) + 1
    tdata = np.ascontiguousarray(tdata, dtype=np.uint8)
    toffs = np.ascontiguousarray(toffs, dtype=np.int64)
    tlens = np.ascontiguousarray(tlens, dtype=np.int32)
    diag_scores = np.ascontiguousarray(diag_scores, dtype=np.int32)
    cap = int(np.maximum(tlens.astype(np.int64) - (span - 1), 0).sum())
    out_kmer = np.empty(max(cap, 1), dtype=np.int32)
    out_seq = np.empty(max(cap, 1), dtype=np.int32)
    out_pos = np.empty(max(cap, 1), dtype=np.int32)
    n_out = ctypes.c_int64(0)
    rc = lib.build_kmer_index(
        _ptr(tdata, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(tlens, ctypes.c_int32), len(tlens),
        _ptr(diag_scores, ctypes.c_int32), int(x_index), int(kmer_thr),
        int(kmer_size), _ptr(pattern, ctypes.c_int32),
        _ptr(out_kmer, ctypes.c_int32), _ptr(out_seq, ctypes.c_int32),
        _ptr(out_pos, ctypes.c_int32), ctypes.byref(n_out))
    if rc != 0:
        raise RuntimeError(f"build_kmer_index failed: {rc}")
    n = int(n_out.value)
    return out_kmer[:n], out_seq[:n], out_pos[:n]


def build_kmer_hash(post_kmer: np.ndarray, n_bits: int):
    """Compact posting-range hash + occupancy bitmap from the sorted
    posting k-mer column."""
    lib = get_lib()
    post_kmer = np.ascontiguousarray(post_kmer, dtype=np.int32)
    n_unique = int(len(np.unique(post_kmer))) if len(post_kmer) else 0
    cap = 1
    while cap < max(2 * n_unique, 2):
        cap *= 2
    hkeys = np.empty(cap, dtype=np.int32)
    hoff = np.empty(cap, dtype=np.int32)
    hcnt = np.empty(cap, dtype=np.int32)
    bitmap = np.empty((n_bits + 63) // 64, dtype=np.uint64)
    rc = lib.build_kmer_hash(
        _ptr(post_kmer, ctypes.c_int32), ctypes.c_int64(len(post_kmer)),
        _ptr(hkeys, ctypes.c_int32), _ptr(hoff, ctypes.c_int32),
        _ptr(hcnt, ctypes.c_int32), ctypes.c_int64(cap),
        _ptr(bitmap, ctypes.c_uint64), ctypes.c_int64(n_bits))
    if rc != 0:
        raise RuntimeError(f"build_kmer_hash failed: {rc}")
    return hkeys, hoff, hcnt, bitmap


def prefilter_match_batch(qdata, qoffs, qlens, seed_sub, p_back, do_bias,
                          sc3, id3, hkeys, hoff, hcnt, occupied,
                          post_seq, post_pos,
                          tdata, toffs, tlens, ungapped_sub, x_index,
                          kmer_thr, max_seqs, min_diag_score, bin_count,
                          identity_base, cov_thr, cov_mode,
                          kmer_size: int, pattern, sc2=None, id2=None):
    """OpenMP k-mer prefilter over a query batch (see prefilter_engine.cpp).

    identity_base >= 0: same-DB search, batch row qi is target key
    identity_base + qi (streaming chunks pass their range start); -1 for
    different query/target DBs.

    Returns (out_seq, out_score, out_diag, out_cnt, total_raw): per query
    qi the hits are rows [qi*max_seqs : qi*max_seqs+out_cnt[qi]].
    """
    lib = get_lib()
    nq = len(qlens)
    nt = len(tlens)
    pattern = np.ascontiguousarray(pattern, dtype=np.int32)
    out_seq = np.empty(nq * max_seqs, dtype=np.int32)
    out_score = np.empty(nq * max_seqs, dtype=np.int32)
    out_diag = np.empty(nq * max_seqs, dtype=np.int32)
    out_cnt = np.zeros(nq, dtype=np.int32)
    total_raw = ctypes.c_int64(0)
    null16 = ctypes.POINTER(ctypes.c_int16)()
    rc = lib.prefilter_match_batch(
        _ptr(qdata, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(qlens, ctypes.c_int32), nq,
        _ptr(seed_sub, ctypes.c_int32), _ptr(p_back, ctypes.c_double),
        seed_sub.shape[0], int(do_bias),
        _ptr(sc3, ctypes.c_int16), _ptr(id3, ctypes.c_int16),
        _ptr(sc2, ctypes.c_int16) if sc2 is not None else null16,
        _ptr(id2, ctypes.c_int16) if id2 is not None else null16,
        int(kmer_size), _ptr(pattern, ctypes.c_int32),
        _ptr(hkeys, ctypes.c_int32), _ptr(hoff, ctypes.c_int32),
        _ptr(hcnt, ctypes.c_int32), ctypes.c_int64(len(hkeys)),
        _ptr(occupied, ctypes.c_uint64),
        _ptr(post_seq, ctypes.c_int32), _ptr(post_pos, ctypes.c_int32),
        _ptr(tdata, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(tlens, ctypes.c_int32), nt,
        _ptr(ungapped_sub, ctypes.c_int32), ungapped_sub.shape[0],
        int(x_index), int(kmer_thr), int(max_seqs), int(min_diag_score),
        int(bin_count), int(identity_base), float(cov_thr), int(cov_mode),
        ctypes.c_int64(0),
        _ptr(out_seq, ctypes.c_int32), _ptr(out_score, ctypes.c_int32),
        _ptr(out_diag, ctypes.c_int32), _ptr(out_cnt, ctypes.c_int32),
        ctypes.byref(total_raw))
    if rc != 0:
        raise RuntimeError(f"prefilter_match_batch failed: {rc}")
    return out_seq, out_score, out_diag, out_cnt, int(total_raw.value)


def _pattern_arr(pattern, kmer_size):
    if pattern is None:
        from ..search.prefilter import KMER_PATTERNS
        pattern = KMER_PATTERNS[kmer_size]
    return np.ascontiguousarray(pattern, dtype=np.int32)


def prefilter_generate_beams(qdata, qoffs, qlens, seed_sub, p_back, do_bias,
                             sc3, id3, global_bitmap, x_index, kmer_thr,
                             want_corr8: bool = False,
                             kmer_size: int = 6, sc2=None, id2=None,
                             pattern=None):
    """Per-query similar-k-mer beams in exact generation order, screened
    against a global occupancy bitmap (None = keep all).  Returns
    (beam_kmer int32[N], beam_win int32[N], beam_offs int64[nq+1]) plus,
    with want_corr8, the precomputed int8 rescore bias correction per
    query position (same layout as qdata)."""
    lib = get_lib()
    nq = len(qlens)
    out_offs = np.empty(nq + 1, dtype=np.int64)
    corr8 = np.zeros(max(len(qdata), 1), dtype=np.int8) if want_corr8 else None
    pk = ctypes.POINTER(ctypes.c_int32)()
    pw = ctypes.POINTER(ctypes.c_int32)()
    null16 = ctypes.POINTER(ctypes.c_int16)()
    rc = lib.prefilter_generate_beams(
        _ptr(qdata, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(qlens, ctypes.c_int32), nq,
        _ptr(seed_sub, ctypes.c_int32), _ptr(p_back, ctypes.c_double),
        seed_sub.shape[0], int(do_bias),
        _ptr(sc3, ctypes.c_int16), _ptr(id3, ctypes.c_int16),
        _ptr(sc2, ctypes.c_int16) if sc2 is not None else null16,
        _ptr(id2, ctypes.c_int16) if id2 is not None else null16,
        int(kmer_size), _ptr(_pattern_arr(pattern, kmer_size),
                             ctypes.c_int32),
        (_ptr(global_bitmap, ctypes.c_uint64) if global_bitmap is not None
         else ctypes.POINTER(ctypes.c_uint64)()),
        int(x_index), int(kmer_thr),
        ctypes.byref(pk), ctypes.byref(pw),
        _ptr(out_offs, ctypes.c_int64),
        (_ptr(corr8, ctypes.c_int8) if corr8 is not None
         else ctypes.POINTER(ctypes.c_int8)()))
    if rc != 0:
        raise RuntimeError(f"prefilter_generate_beams failed: {rc}")
    n = int(out_offs[-1])
    try:
        beam_kmer = np.ctypeslib.as_array(pk, shape=(max(n, 1),))[:n].copy()
        beam_win = np.ctypeslib.as_array(pw, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.free_beam_buffers(pk, pw)
    if want_corr8:
        return beam_kmer, beam_win, out_offs, corr8
    return beam_kmer, beam_win, out_offs


def build_shard_mask_table(shard_bitmaps: np.ndarray) -> np.ndarray:
    """Per-k-mer byte of shard-occupancy bits (n_shards <= 8) from the
    stacked shard occupancy bitmaps (n_shards, words) uint64."""
    lib = get_lib()
    n_shards, words = shard_bitmaps.shape
    if n_shards > 8:
        raise ValueError("mask table supports <= 8 shards per group")
    table = np.empty(words * 64, dtype=np.uint8)
    rc = lib.build_shard_mask_table(
        _ptr(shard_bitmaps, ctypes.c_uint64), n_shards,
        ctypes.c_int64(words), _ptr(table, ctypes.c_uint8))
    if rc != 0:
        raise RuntimeError(f"build_shard_mask_table failed: {rc}")
    return table


def partition_beams(beam_kmer, beam_win, beam_offs, mask_table, n_shards):
    """Split screened beams into per-shard sub-beams via the shard mask
    table (build_shard_mask_table).  Returns (kmer, win, offs) with
    shard-major segment layout: shard s, query qi =
    [offs[s*nq+qi], offs[s*nq+qi+1])."""
    lib = get_lib()
    nq = len(beam_offs) - 1
    out_offs = np.empty(n_shards * nq + 1, dtype=np.int64)
    pk = ctypes.POINTER(ctypes.c_int32)()
    pw = ctypes.POINTER(ctypes.c_int32)()
    rc = lib.partition_beams(
        _ptr(beam_kmer, ctypes.c_int32), _ptr(beam_win, ctypes.c_int32),
        _ptr(beam_offs, ctypes.c_int64), nq,
        _ptr(mask_table, ctypes.c_uint8), n_shards,
        ctypes.byref(pk), ctypes.byref(pw),
        _ptr(out_offs, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"partition_beams failed: {rc}")
    n = int(out_offs[-1])
    try:
        km = np.ctypeslib.as_array(pk, shape=(max(n, 1),))[:n].copy()
        wn = np.ctypeslib.as_array(pw, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.free_beam_buffers(pk, pw)
    return km, wn, out_offs


def prefilter_match_beams(qdata, qoffs, qlens, seed_sub, p_back, do_bias,
                          beam_kmer, beam_win, beam_offs,
                          hkeys, hoff, hcnt, occupied, post_seq, post_pos,
                          tdata, toffs, tlens, ungapped_sub,
                          max_seqs, min_diag_score, bin_count,
                          identity_base, cov_thr, cov_mode, corr8=None):
    """Probe a (shard-local) posting index with cached beams; same output
    contract as prefilter_match_batch.  occupied=None skips the bitmap
    screen (pre-partitioned sub-beams); corr8 skips the per-shard bias
    recompute."""
    lib = get_lib()
    nq = len(qlens)
    out_seq = np.empty(nq * max_seqs, dtype=np.int32)
    out_score = np.empty(nq * max_seqs, dtype=np.int32)
    out_diag = np.empty(nq * max_seqs, dtype=np.int32)
    out_cnt = np.zeros(nq, dtype=np.int32)
    total_raw = ctypes.c_int64(0)
    rc = lib.prefilter_match_beams(
        _ptr(qdata, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(qlens, ctypes.c_int32), nq,
        _ptr(seed_sub, ctypes.c_int32), _ptr(p_back, ctypes.c_double),
        seed_sub.shape[0], int(do_bias),
        (_ptr(corr8, ctypes.c_int8) if corr8 is not None
         else ctypes.POINTER(ctypes.c_int8)()),
        _ptr(beam_kmer, ctypes.c_int32), _ptr(beam_win, ctypes.c_int32),
        _ptr(beam_offs, ctypes.c_int64),
        _ptr(hkeys, ctypes.c_int32), _ptr(hoff, ctypes.c_int32),
        _ptr(hcnt, ctypes.c_int32), ctypes.c_int64(len(hkeys)),
        (_ptr(occupied, ctypes.c_uint64) if occupied is not None
         else ctypes.POINTER(ctypes.c_uint64)()),
        _ptr(post_seq, ctypes.c_int32), _ptr(post_pos, ctypes.c_int32),
        _ptr(tdata, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(tlens, ctypes.c_int32), len(tlens),
        _ptr(ungapped_sub, ctypes.c_int32), ungapped_sub.shape[0],
        int(max_seqs), int(min_diag_score), int(bin_count),
        int(identity_base), float(cov_thr), int(cov_mode),
        _ptr(out_seq, ctypes.c_int32), _ptr(out_score, ctypes.c_int32),
        _ptr(out_diag, ctypes.c_int32), _ptr(out_cnt, ctypes.c_int32),
        ctypes.byref(total_raw))
    if rc != 0:
        raise RuntimeError(f"prefilter_match_beams failed: {rc}")
    return out_seq, out_score, out_diag, out_cnt, int(total_raw.value)


def nucl_banded_align(q: np.ndarray, t: np.ndarray, diagonal: int,
                      mat: np.ndarray, gap_open: int = 5, gap_extend: int = 2,
                      zdrop: int = 40, band: int = 64):
    """BandedNucleotideAligner::align equivalent (nucl_align.cpp).
    q must be strand-correct (reverse hits pass the reverse complement).
    Returns (score, qstart, qend, tstart, tend, n_ident, ops)."""
    lib = get_lib()
    q = np.ascontiguousarray(q, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    mat = np.ascontiguousarray(mat, dtype=np.int32)
    out = np.zeros(9, dtype=np.int32)
    cap = len(q) + len(t) + 8
    buf = ctypes.create_string_buffer(cap)
    n = lib.nucl_banded_align(
        _ptr(q, ctypes.c_uint8), len(q), _ptr(t, ctypes.c_uint8), len(t),
        int(diagonal), _ptr(mat, ctypes.c_int32), mat.shape[0],
        gap_open, gap_extend, zdrop, band,
        _ptr(out, ctypes.c_int32), buf, cap)
    if n < 0:
        raise RuntimeError(f"nucl_banded_align failed: {n}")
    return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
            int(out[4]), int(out[5]), buf.raw[:n].decode("ascii"))


def prefilter_match_profile_batch(rank_s, rank_i, qprof, qseq, x_index,
                                  qoffs, qlens,
                                  hkeys, hoff, hcnt, occupied,
                                  post_seq, post_pos, tdata, toffs, tlens,
                                  alpha, kmer_thr, max_seqs,
                                  min_diag_score, bin_count,
                                  identity_keys, cov_thr, cov_mode,
                                  kmer_size: int, pattern):
    """OpenMP profile-query prefilter (per-position PSSM beam; see
    prefilter_engine.cpp).  Same output contract as
    prefilter_match_batch; identity_keys: per-row identity target key
    or None."""
    lib = get_lib()
    nq = len(qlens)
    pattern = np.ascontiguousarray(pattern, dtype=np.int32)
    out_seq = np.empty(nq * max_seqs, dtype=np.int32)
    out_score = np.empty(nq * max_seqs, dtype=np.int32)
    out_diag = np.empty(nq * max_seqs, dtype=np.int32)
    out_cnt = np.zeros(nq, dtype=np.int32)
    total_raw = ctypes.c_int64(0)
    rc = lib.prefilter_match_profile_batch(
        _ptr(rank_s, ctypes.c_int16), _ptr(rank_i, ctypes.c_uint8),
        _ptr(qprof, ctypes.c_int16),
        _ptr(qseq, ctypes.c_uint8), int(x_index),
        _ptr(qoffs, ctypes.c_int64), _ptr(qlens, ctypes.c_int32), nq,
        int(kmer_size), _ptr(pattern, ctypes.c_int32),
        _ptr(hkeys, ctypes.c_int32), _ptr(hoff, ctypes.c_int32),
        _ptr(hcnt, ctypes.c_int32), ctypes.c_int64(len(hkeys)),
        _ptr(occupied, ctypes.c_uint64),
        _ptr(post_seq, ctypes.c_int32), _ptr(post_pos, ctypes.c_int32),
        _ptr(tdata, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(tlens, ctypes.c_int32), len(tlens),
        int(alpha), int(kmer_thr), int(max_seqs), int(min_diag_score),
        int(bin_count),
        (_ptr(identity_keys, ctypes.c_int32)
         if identity_keys is not None
         else ctypes.POINTER(ctypes.c_int32)()),
        float(cov_thr), int(cov_mode),
        _ptr(out_seq, ctypes.c_int32), _ptr(out_score, ctypes.c_int32),
        _ptr(out_diag, ctypes.c_int32), _ptr(out_cnt, ctypes.c_int32),
        ctypes.byref(total_raw))
    if rc != 0:
        raise RuntimeError(f"prefilter_match_profile_batch failed: {rc}")
    return out_seq, out_score, out_diag, out_cnt, int(total_raw.value)


def cluster_hits_native(qpos, tpos, qstrand, tstrand, lookup,
                        max_gene_gaps: int, s_min: float, q0: float = 0.001):
    """Native agglomeration (clusterhits_engine.cpp). Returns
    (node_member_lists, node_scores) in nodes-index order."""
    lib = get_lib()
    K = len(qpos)
    qpos = np.ascontiguousarray(qpos, dtype=np.int64)
    tpos = np.ascontiguousarray(tpos, dtype=np.int64)
    qstrand = np.ascontiguousarray(qstrand, dtype=np.uint8)
    tstrand = np.ascontiguousarray(tstrand, dtype=np.uint8)
    lookup = np.ascontiguousarray(lookup, dtype=np.float64)
    members = np.empty(K, dtype=np.int32)
    sizes = np.empty(K, dtype=np.int32)
    scores = np.empty(K, dtype=np.float64)
    lib.cluster_hits_engine(
        _ptr(qpos, ctypes.c_int64), _ptr(tpos, ctypes.c_int64),
        _ptr(qstrand, ctypes.c_uint8), _ptr(tstrand, ctypes.c_uint8),
        K, _ptr(lookup, ctypes.c_double), ctypes.c_int64(len(lookup)),
        ctypes.c_int64(max_gene_gaps), ctypes.c_double(s_min),
        ctypes.c_double(q0),
        _ptr(members, ctypes.c_int32), _ptr(sizes, ctypes.c_int32),
        _ptr(scores, ctypes.c_double))
    out, off = [], 0
    for n in range(K):
        sz = int(sizes[n])
        out.append([int(x) for x in members[off:off + sz]])
        off += sz
    return out, scores


def banded_align_batch(qdata, qoffs, tdata, toffs, bias_data, mat_int8,
                       qk, tk, qstart, qend, tstart, tend, score,
                       gap_open: int, gap_extend: int):
    """Batched banded tracebacks (OpenMP over pairs).  Returns
    (ops_list, n_ident array, cigar_list); raises on any failed
    traceback."""
    lib = get_lib()
    n = len(qk)
    qk = np.ascontiguousarray(qk, dtype=np.int32)
    tk = np.ascontiguousarray(tk, dtype=np.int32)
    qstart = np.ascontiguousarray(qstart, dtype=np.int32)
    qend = np.ascontiguousarray(qend, dtype=np.int32)
    tstart = np.ascontiguousarray(tstart, dtype=np.int32)
    tend = np.ascontiguousarray(tend, dtype=np.int32)
    score = np.ascontiguousarray(score, dtype=np.int32)
    caps = ((qend - qstart + 1).astype(np.int64)
            + (tend - tstart + 1).astype(np.int64) + 8)
    out_offs = np.concatenate(([0], np.cumsum(caps)))
    out_ops = ctypes.create_string_buffer(int(out_offs[-1]))
    out_len = np.empty(n, dtype=np.int32)
    out_ident = np.empty(n, dtype=np.int32)
    # worst case (alternating ops) doubles the length
    out_cigar = ctypes.create_string_buffer(2 * int(out_offs[-1]))
    out_clen = np.empty(n, dtype=np.int32)
    bad = lib.banded_align_batch(
        _ptr(qdata, ctypes.c_uint8), _ptr(qoffs, ctypes.c_int64),
        _ptr(tdata, ctypes.c_uint8), _ptr(toffs, ctypes.c_int64),
        _ptr(bias_data, ctypes.c_int8),
        _ptr(mat_int8, ctypes.c_int8), mat_int8.shape[0],
        n, _ptr(qk, ctypes.c_int32), _ptr(tk, ctypes.c_int32),
        _ptr(qstart, ctypes.c_int32), _ptr(qend, ctypes.c_int32),
        _ptr(tstart, ctypes.c_int32), _ptr(tend, ctypes.c_int32),
        _ptr(score, ctypes.c_int32), gap_open, gap_extend,
        _ptr(out_offs, ctypes.c_int64), out_ops,
        _ptr(out_len, ctypes.c_int32), _ptr(out_ident, ctypes.c_int32),
        out_cigar, _ptr(out_clen, ctypes.c_int32))
    if bad:
        raise RuntimeError(f"banded_align_batch: {bad} failed tracebacks")
    raw = out_ops.raw
    ops = [raw[int(out_offs[i]):int(out_offs[i]) + int(out_len[i])]
           .decode("ascii") for i in range(n)]
    craw = out_cigar.raw
    cigs = [craw[2 * int(out_offs[i]):2 * int(out_offs[i])
                 + int(out_clen[i])].decode("ascii") for i in range(n)]
    return ops, out_ident, cigs


def banded_align_profile(t: np.ndarray, q_len: int, prof_aa_qpos: np.ndarray,
                         query_start: int, score: int,
                         gap_open: int = 11, gap_extend: int = 1) -> str:
    """Profile-query CIGAR: prof_aa_qpos is the (alpha, full_query_len)
    int8 alignment profile; the rectangle is [query_start, query_start+q_len)
    x [0, len(t)).  Returns the expanded ops string."""
    t = np.ascontiguousarray(t, dtype=np.uint8)
    prof = np.ascontiguousarray(prof_aa_qpos, dtype=np.int8)
    cap = q_len + len(t) + 8
    buf = ctypes.create_string_buffer(cap)
    n = get_lib().banded_align_profile(
        _ptr(t, ctypes.c_uint8), q_len, len(t), _ptr(prof, ctypes.c_int8),
        prof.shape[1], query_start, int(score), gap_open, gap_extend,
        abs(len(t) - q_len) + 1, buf, cap)
    if n < 0:
        raise RuntimeError(f"banded_align_profile failed: {n}")
    return buf.raw[:n].decode("ascii")


def banded_align_profile_profile(t_consens: np.ndarray,
                                 q_consens: np.ndarray,
                                 qprof_aa_qpos: np.ndarray,
                                 query_start: int,
                                 tprof_aa_tpos: np.ndarray,
                                 target_start: int, score: int,
                                 gap_open: int = 11,
                                 gap_extend: int = 1) -> str:
    """PROFILE_PROFILE CIGAR (StripedSmithWaterman.cpp:1461-1470): both
    sides are profiles; t_consens/q_consens are the consensus residues
    over the aligned rectangle, the profiles are (alpha, full_len) int8
    in [aa][pos] layout.  Cell score = the reference's rounded mean of
    qprof[t_j][qs+i] and tprof[q_i][ts+j].  Returns the expanded ops
    string."""
    t = np.ascontiguousarray(t_consens, dtype=np.uint8)
    qc = np.ascontiguousarray(q_consens, dtype=np.uint8)
    qprof = np.ascontiguousarray(qprof_aa_qpos, dtype=np.int8)
    tprof = np.ascontiguousarray(tprof_aa_tpos, dtype=np.int8)
    q_len = len(qc)
    cap = q_len + len(t) + 8
    buf = ctypes.create_string_buffer(cap)
    n = get_lib().banded_align_profile_profile(
        _ptr(t, ctypes.c_uint8), _ptr(qc, ctypes.c_uint8), q_len, len(t),
        _ptr(qprof, ctypes.c_int8), qprof.shape[1], int(query_start),
        _ptr(tprof, ctypes.c_int8), tprof.shape[1], int(target_start),
        int(score), gap_open, gap_extend, abs(len(t) - q_len) + 1, buf, cap)
    if n < 0:
        raise RuntimeError(f"banded_align_profile_profile failed: {n}")
    return buf.raw[:n].decode("ascii")


def w_contrib_rcp(n: np.ndarray, naa: np.ndarray) -> np.ndarray:
    """Hardware-exact approximate-reciprocal weight contributions
    (PSSMCalculator.cpp:505-517). n: (ncol, 24) int32, naa: (ncol,) int32."""
    n = np.ascontiguousarray(n, dtype=np.int32)
    naa = np.ascontiguousarray(naa, dtype=np.int32)
    out = np.empty((n.shape[0], 24), dtype=np.float32)
    get_lib().w_contrib_rcp(_ptr(n, ctypes.c_int32), _ptr(naa, ctypes.c_int32),
                            n.shape[0], _ptr(out, ctypes.c_float))
    return out


def global_aa_bias_correction(pssm: np.ndarray, p_null: np.ndarray
                              ) -> np.ndarray:
    """The corrected (L, 20) int8 PSSM of search/profile.py::
    global_aa_bias_correction (profile_native.cpp), given the int8 PSSM
    and its (L,) float32 background-weighted row sums p_null."""
    pssm = np.ascontiguousarray(pssm, dtype=np.int8)
    p_null = np.ascontiguousarray(p_null, dtype=np.float32)
    if pssm.ndim != 2 or pssm.shape[1] != 20 or p_null.shape != pssm.shape[:1]:
        raise ValueError("global_aa_bias_correction: bad shapes")
    out = np.empty_like(pssm)
    get_lib().global_aa_bias_correction(
        _ptr(pssm, ctypes.c_int8), _ptr(p_null, ctypes.c_float),
        pssm.shape[0], _ptr(out, ctypes.c_int8))
    return out


def profile_kmer_postings(pssm: np.ndarray, offs: np.ndarray,
                          pattern: np.ndarray, thr: int, want: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Target-profile k-mer postings (profile_native.cpp): pssm is the
    (offs[-1], 20) int16 rows of the profiles, profile q's from offs[q]
    on; want the (20^k,) uint8 table of the k-mers to post.  Returns
    (counts per profile, packed k-mers int64, first windows int32), the
    postings profile after profile, each profile's k-mers ascending."""
    pssm = np.ascontiguousarray(pssm, dtype=np.int16)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    pattern = np.ascontiguousarray(pattern, dtype=np.int32)
    want = np.ascontiguousarray(want, dtype=np.uint8)
    n = len(offs) - 1
    if want.shape != (20 ** len(pattern),) or pssm.shape != (offs[-1], 20):
        raise ValueError("profile_kmer_postings: bad shapes")
    lib = get_lib()
    counts = np.zeros(n, dtype=np.int64)
    args = (_ptr(pssm, ctypes.c_int16), _ptr(offs, ctypes.c_int64), n,
            _ptr(pattern, ctypes.c_int32), len(pattern), int(thr),
            _ptr(want, ctypes.c_uint8), _ptr(counts, ctypes.c_int64))
    null64 = ctypes.POINTER(ctypes.c_int64)()
    null32 = ctypes.POINTER(ctypes.c_int32)()
    if lib.profile_kmer_postings(*args, null64, null32) != 0:
        raise RuntimeError("profile_kmer_postings failed")
    total = int(counts.sum())
    kmer = np.empty(total, dtype=np.int64)
    pos = np.empty(total, dtype=np.int32)
    if lib.profile_kmer_postings(*args, _ptr(kmer, ctypes.c_int64),
                                 _ptr(pos, ctypes.c_int32)) != 0:
        raise RuntimeError("profile_kmer_postings failed")
    return counts, kmer, pos


def banded_align_profile_u16(tsym: np.ndarray, q_len: int,
                             prof: np.ndarray, query_start: int, score: int,
                             gap_open: int, gap_extend: int) -> str:
    """Banded traceback of one pair over a wide (up to 65,536-symbol)
    alphabet: target symbols `tsym` (uint16) against the query rows
    [query_start, query_start + q_len) of the int8 profile `prof`
    (symbols x query positions).  Returns the expanded ops string."""
    tsym = np.ascontiguousarray(tsym, dtype=np.uint16)
    prof = np.ascontiguousarray(prof, dtype=np.int8)
    cap = q_len + len(tsym) + 8
    buf = ctypes.create_string_buffer(cap)
    n = get_lib().banded_align_profile_u16(
        _ptr(tsym, ctypes.c_uint16), q_len, len(tsym),
        _ptr(prof, ctypes.c_int8), prof.shape[1], query_start, int(score),
        gap_open, gap_extend, abs(len(tsym) - q_len) + 1, buf, cap)
    if n < 0:
        raise RuntimeError(f"banded_align_profile_u16 failed: {n}")
    return buf.raw[:n].decode("ascii")


def set_num_threads(n: int) -> None:
    """--threads analog: cap the OpenMP team of every native engine."""
    get_lib().spacedust_set_threads(int(n))
