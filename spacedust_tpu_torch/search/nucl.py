"""Nucleotide search mode (blastn-style): split -> k-mer prefilter ->
banded extension alignment -> offset merge.

Mirrors the reference's nucleotide search pipeline
(lib/mmseqs/data/workflow/blastn.sh + workflow/Search.cpp:188-200):

  * `splitsequence`: contigs cut into 10 kb windows with ORF-codec
    headers (util/splitsequence.cpp; observed windows carry no overlap)
  * prefilter: exact spaced-free k-mer match (k=15, 2-bit packed,
    Search.cpp:194 sets kmerSize=15 with takeOnlyBestKmer) on forward
    AND reverse-complement query, candidates scored by an ungapped
    diagonal Kadane over the +2/-3 nucleotide matrix
  * alignment: BandedNucleotideAligner semantics (ksw2 extension, band
    64, zdrop 40, gap 5/2) via native/nucl_align.cpp; reverse hits are
    written with target start > end (Matcher.cpp:133-136)
  * E-values: ALP Gumbel parameters for nucleotide (5,2), pinned from a
    one-shot run of the reference's EvalueComputation::init simulation
    (EvalueComputation.h:95-112, seed 42) — reproduces the reference's
    E-values to the printed digit
  * offsetalignment: window hits mapped to contig coordinates with the
    window (orf) columns appended (util/offsetalignment.cpp)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..native import nucl_banded_align, tantan_mask
from ..stats.evalue import EvalueComputation, GumbelParams
from ..stats.fmt import fmt_seq_id, fmt_double_3e

NUCL_ORDER = "ACTG"                      # nucleotide.out symbol order
X_NUCL = 4
NUCL_K = 15
# spaced 15-mer pattern {1,1,1,0,1,0,1,1,1,1,0,1,1,0,0,0,1,0,1,1,0,1,1}
# (Sequence.h:41 spaced_seed_15; --spaced-kmer-mode 1 is the default for
# the nucleotide prefilter too)
NUCL_PATTERN = np.array([0, 1, 2, 4, 6, 7, 8, 9, 11, 12, 16, 18, 19, 21, 22],
                        dtype=np.int64)
NUCL_SPAN = 23

# +2 match / -3 mismatch, X always -3 (lib/mmseqs/data/nucleotide.out)
NUCL_MAT = np.full((5, 5), -3, dtype=np.int32)
np.fill_diagonal(NUCL_MAT, 2)
NUCL_MAT[4, 4] = -3

# ALP Gumbel parameters for nucleotide.out with gap open 5 / extend 2,
# pinned from the reference's deterministic simulation (randomSeed 42,
# EvalueComputation.h:49-52,102-112); verified against oracle E-values.
# tantan likelihood ratios for the nucleotide matrix: the reference's
# ProbabilityMatrix (BaseMatrix.h:83-96) over the file's joint probs,
# which reduce to exp(lambda * S) with the matrix file's precomputed
# lambda (data/nucleotide.out header)
NUCL_LAMBDA = 0.6337314
NUCL_TANTAN_RATIO = np.exp(NUCL_LAMBDA * NUCL_MAT.astype(np.float64))

NUCL_GUMBEL_5_2 = GumbelParams(
    lam=0.62092274139392822, K=0.3517759798820162,
    a_J=0.74528059208662512, b_J=-0.71027220445456996,
    a_I=0.74528059208662512, b_I=-0.71027220445456996,
    alpha_J=1.013524340767457, beta_J=-2.522648648678306,
    alpha_I=1.013524340767457, beta_I=-2.522648648678306,
    sigma=1.0031949332622874, tau=-2.378036943605931)

_ENC = np.full(256, X_NUCL, dtype=np.uint8)
for _i, _c in enumerate(NUCL_ORDER):
    _ENC[ord(_c)] = _i
    _ENC[ord(_c.lower())] = _i
_ENC[ord("U")] = _ENC[ord("u")] = _ENC[ord("T")]


def encode_nucl(s: str) -> np.ndarray:
    return _ENC[np.frombuffer(s.encode(), dtype=np.uint8)]


_RC = np.array([2, 3, 0, 1, 4], dtype=np.uint8)   # A<->T, C<->G in ACTG order


def revcomp_codes(a: np.ndarray) -> np.ndarray:
    return _RC[a[::-1]]


@dataclass
class Window:
    key: int
    contig_key: int
    start: int          # contig position of window base 0 (strand-local)
    codes: np.ndarray
    strand: int = 1     # -1: reverse-frame window (extractframes output)
    from_pos: int = 0   # contig coord of base 0 (minus strand: descending)


def split_windows(contigs: dict[int, str], max_len: int = 10000
                  ) -> list[Window]:
    out = []
    key = 0
    for ck in sorted(contigs):
        codes = encode_nucl(contigs[ck].strip())
        for s in range(0, len(codes), max_len):
            out.append(Window(key, ck, s, codes[s:s + max_len],
                              strand=1, from_pos=s))
            key += 1
    return out


def split_windows_both_strands(contigs: dict[int, str],
                               max_len: int = 10000) -> list[Window]:
    """extractframes + splitsequence framing (blastn.sh:36-52): forward
    windows of the contig, then windows of the REVERSE COMPLEMENT —
    whose boundaries align from the contig END (observed oracle headers
    `from-len` with from descending)."""
    out = []
    key = 0
    for ck in sorted(contigs):
        codes = encode_nucl(contigs[ck].strip())
        L = len(codes)
        for s in range(0, L, max_len):
            out.append(Window(key, ck, s, codes[s:s + max_len],
                              strand=1, from_pos=s))
            key += 1
        rc = revcomp_codes(codes)
        for s in range(0, L, max_len):
            out.append(Window(key, ck, s, rc[s:s + max_len],
                              strand=-1, from_pos=L - 1 - s))
            key += 1
    return out


def _pack_kmers(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(positions, packed 2-bit spaced 15-mers) for all X-free windows."""
    n = len(codes) - NUCL_SPAN + 1
    if n <= 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    idx = np.arange(n)[:, None] + NUCL_PATTERN[None, :]
    km = codes[idx].astype(np.int64)
    ok = (km != X_NUCL).all(axis=1)
    packed = np.zeros(n, dtype=np.int64)
    for i in range(NUCL_K):
        packed = (packed << 2) | km[:, i]
    return np.arange(n, dtype=np.int64)[ok], packed[ok]


@dataclass
class NuclRecord:
    tkey: int           # window key at search level; contig key after offset
    bit: int
    seq_id: float
    evalue: float
    qstart: int
    qend: int
    qlen: int
    tstart: int
    tend: int
    tlen: int

    def columns(self) -> list[str]:
        return [str(self.tkey), str(self.bit), fmt_seq_id(self.seq_id),
                fmt_double_3e(self.evalue), str(self.qstart),
                str(self.qend), str(self.qlen), str(self.tstart),
                str(self.tend), str(self.tlen)]


class NuclSearch:
    def __init__(self, target_windows: list[Window], mask: bool = True):
        self.windows = target_windows
        # tantan-masked window copies: masked k-mers are not indexed and
        # the candidate rescore runs over the masked tokens
        # (IndexBuilder masking; Masker.cpp:20-31, maxCycleLength 50)
        self.masked = {w.key: (tantan_mask(w.codes, NUCL_TANTAN_RATIO,
                                           X_NUCL, max_offset=50)
                               if mask else w.codes)
                       for w in target_windows}
        pos_l, km_l, wid_l = [], [], []
        for w in target_windows:
            pos, km = _pack_kmers(self.masked[w.key])
            # only the FIRST occurrence of a k-mer per window is indexed
            # (IndexTable::addSequence dedup, IndexTable.h:332-345)
            order = np.lexsort((pos, km))
            km = km[order]
            pos = pos[order]
            first = np.concatenate(([True], km[1:] != km[:-1]))
            pos_l.append(pos[first])
            km_l.append(km[first])
            wid_l.append(np.full(int(first.sum()), w.key, dtype=np.int64))
        kmers = np.concatenate(km_l) if km_l else np.empty(0, np.int64)
        order = np.argsort(kmers, kind="stable")
        self.t_kmers = kmers[order]
        self.t_pos = (np.concatenate(pos_l) if pos_l
                      else np.empty(0, np.int64))[order]
        self.t_wid = (np.concatenate(wid_l) if wid_l
                      else np.empty(0, np.int64))[order]
        self.by_key = {w.key: w for w in target_windows}
        self.db_res = int(sum(len(w.codes) for w in target_windows))
        self.evaluer = EvalueComputation(self.db_res, NUCL_GUMBEL_5_2)

    def _candidates(self, q: np.ndarray, max_seqs: int, min_diag: int = 15
                    ) -> list[tuple[int, int, int]]:
        """(target window, diagonal, ungapped score) candidates, best
        diagonal per target, score-capped at max_seqs."""
        qpos, qkm = _pack_kmers(q)
        if len(qkm) == 0:
            return []
        lo = np.searchsorted(self.t_kmers, qkm, side="left")
        hi = np.searchsorted(self.t_kmers, qkm, side="right")
        cnt = hi - lo
        tot = int(cnt.sum())
        if tot == 0:
            return []
        rep = np.repeat(np.arange(len(qkm)), cnt)
        off = np.concatenate([np.arange(c) for c in cnt if c]) if tot else 0
        take = lo[rep] + off
        wid = self.t_wid[take]
        diag = qpos[rep] - self.t_pos[take]
        # double-diagonal detection in exact arrival order (query k-mers
        # ascending, postings in index order): a hit is double when the
        # PREVIOUS hit of the same target window had the same u8-wrapped
        # diagonal — including the zero-init quirk where a first hit on
        # diagonal 0 counts (CacheFriendlyOperations.cpp:193-208)
        d8 = (diag & 0xFF).astype(np.int64)
        order = np.argsort(rep, kind="stable")   # arrival: kmer-major
        prev: dict[int, int] = {}
        detected: set[tuple[int, int]] = set()
        for i in order:
            w = int(wid[i])
            cur = int(d8[i])
            pv = prev.get(w)
            if (pv is None and cur == 0) or (pv is not None and pv == cur):
                detected.add((w, int(diag[i])))
            prev[w] = cur
        best: dict[int, tuple[int, int]] = {}
        for (w, d) in sorted(detected):
            score = _ungapped_score(q, self.masked[w], d)
            if score < min_diag:
                continue
            if w not in best or score > best[w][1]:
                best[w] = (d, score)
        cands = [(w, d, s) for w, (d, s) in best.items()]
        cands.sort(key=lambda x: -x[2])
        return cands[:max_seqs]

    def search_window(self, qw: Window, eval_thr: float = 1e-3,
                      max_seqs: int = 300, gap_open: int = 5,
                      gap_extend: int = 2, zdrop: int = 40
                      ) -> list[NuclRecord]:
        """One query window (strand already applied by extractframes
        framing) against the index."""
        out: list[NuclRecord] = []
        qlen = len(qw.codes)
        q = qw.codes
        for (w, d, _s) in self._candidates(q, max_seqs):
            tw = self.by_key[w]
            try:
                (score, qs, qe, ts, te, ids, ops) = nucl_banded_align(
                    q, tw.codes, d, NUCL_MAT, gap_open, gap_extend, zdrop)
            except RuntimeError:
                continue
            if score <= 0 or not ops:
                continue
            evalue = float(self.evaluer.compute_evalue(score, qlen))
            if evalue > eval_thr:
                continue
            bit = int(self.evaluer.compute_bit_score(score) + 0.5)
            seq_id = float(np.float32(ids) / np.float32(len(ops)))
            out.append(NuclRecord(w, bit, seq_id, evalue, qs, qe,
                                  qlen, ts, te, len(tw.codes)))
        out.sort(key=lambda r: (r.evalue, -r.bit, r.tlen, r.tkey))
        return out


def _ungapped_score(q: np.ndarray, t: np.ndarray, diag: int) -> int:
    if diag >= 0:
        n = min(len(t), len(q) - diag)
        if n <= 0:
            return 0
        a, b = q[diag:diag + n], t[:n]
    else:
        n = min(len(t) + diag, len(q))
        if n <= 0:
            return 0
        a, b = q[:n], t[-diag:-diag + n]
    s = NUCL_MAT[a.astype(np.int64), b.astype(np.int64)]
    # Kadane max
    best = run = 0
    for v in s:
        run = max(0, run + int(v))
        best = max(best, run)
    return best


def nucl_search(query_contigs: dict[int, str], target_contigs: dict[int, str],
                eval_thr: float = 1e-3, max_seqs: int = 300,
                max_win: int = 10000) -> dict[int, list[list[str]]]:
    """Full pipeline; returns contig key -> alignment lines in the
    reference's offsetalignment output format (window coords mapped to
    contig coords, window columns appended)."""
    t_windows = split_windows(target_contigs, max_win)
    q_windows = split_windows_both_strands(query_contigs, max_win)
    engine = NuclSearch(t_windows)
    t_by_key = {w.key: w for w in t_windows}
    contig_lens_q = {k: len(v.strip()) for k, v in query_contigs.items()}
    contig_lens_t = {k: len(v.strip()) for k, v in target_contigs.items()}

    out: dict[int, list[list[str]]] = {k: [] for k in query_contigs}
    for qw in q_windows:
        recs = engine.search_window(qw, eval_thr=eval_thr, max_seqs=max_seqs)
        for r in recs:
            tw = t_by_key[r.tkey]
            t_from = tw.start
            cols = r.columns()
            cols[0] = str(tw.contig_key)
            if qw.strand > 0:
                cols[4] = str(qw.from_pos + r.qstart)
                cols[5] = str(qw.from_pos + r.qend)
                q_orf = [str(qw.from_pos),
                         str(qw.from_pos + len(qw.codes) - 1)]
            else:
                # offsetalignment minus-strand map (offsetalignment.cpp:
                # 144-149): contig coord = from - pos, descending
                cols[4] = str(qw.from_pos - r.qstart)
                cols[5] = str(qw.from_pos - r.qend)
                q_orf = [str(qw.from_pos),
                         str(qw.from_pos - (len(qw.codes) - 1))]
            cols[6] = str(contig_lens_q[qw.contig_key])
            cols[7] = str(t_from + r.tstart)
            cols[8] = str(t_from + r.tend)
            cols[9] = str(contig_lens_t[tw.contig_key])
            cols += q_orf + [str(t_from), str(t_from + len(tw.codes) - 1)]
            out[qw.contig_key].append(cols)
    return out
