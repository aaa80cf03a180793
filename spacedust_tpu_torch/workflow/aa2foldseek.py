"""aa2foldseek: map SetDB genes to a reference Foldseek structure DB.

Native equivalent of src/workflow/aa2foldseek.cpp + data/aa2foldseek.sh:
a near-identity search (seqId >= 0.9, bidirectional cov >= 0.9,
aa2foldseek.cpp:9-15) maps each gene to its structure entry in the
reference DB; the matched entries' sequences and 3Di states are re-keyed
by the ORIGINAL gene ids (filterdb --extract-lines 1 / swapdb /
createsubdb / renamedbkeys, aa2foldseek.sh:22-95), and the leftover genes
form the unmapped set (aa2foldseek.sh:102-109).

The result feeds --search-mode 1 (data/clustersearch.sh:84-107): a 3Di
structure search over the mapped subset + a sequence search of the
unmapped genes against the full target, concatenated per query key.

Deviation: the reference speeds the mapping search up with
--exact-kmer-matching 1 (exact seed k-mers only); the standard
similar-k-mer prefilter used here is a superset, so the accepted
mappings are identical under the seqId/cov thresholds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..constants import encode_aa
from ..db.mmseqs_io import FlatDB
from ..db.setdb import SetDB
from ..search.alignment import (AlignmentEngine, AlignmentParams,
                                COV_MODE_BIDIRECTIONAL)
from ..search.prefilter import PrefilterEngine


@dataclass
class StructureRef:
    """A reference Foldseek structure DB (sequences + 3Di states)."""
    seqs: list[np.ndarray]
    ss: list[np.ndarray]
    names: dict[int, str] = field(default_factory=dict)

    @classmethod
    def open(cls, base: str | Path) -> "StructureRef":
        seq_db = FlatDB.open(base)
        ss_db = FlatDB.open(f"{base}_ss")
        seqs, ss, names = [], [], {}
        for key in seq_db.keys():
            seqs.append(encode_aa(seq_db.get(key).strip()))
            ss.append(encode_aa(ss_db.get(key).strip()))
        lookup_path = Path(f"{base}.lookup")
        if lookup_path.exists():
            for line in lookup_path.read_text().splitlines():
                k, name = line.split("\t")[:2]
                names[int(k)] = name
        return cls(seqs=seqs, ss=ss, names=names)

    def as_setdb(self) -> SetDB:
        offsets = np.concatenate(
            ([0], np.cumsum([len(s) for s in self.seqs]))).astype(np.int64)
        db = SetDB(dbtype="aminoacid",
                   seq_data=(np.concatenate(self.seqs) if self.seqs
                             else np.empty(0, np.uint8)),
                   offsets=offsets,
                   names=[self.names.get(i, f"ref{i}_0_1_{len(s)*3}")
                          for i, s in enumerate(self.seqs)],
                   set_ids=np.zeros(len(self.seqs), dtype=np.int32),
                   headers=[""] * len(self.seqs), sources=["ref"])
        return db


@dataclass
class FoldseekMapping:
    """gene key -> reference structure entry; mapped genes carry the
    reference's sequence + 3Di (re-keyed IN_foldseek semantics)."""
    mapping: dict[int, int]
    mapped_seq: dict[int, np.ndarray]
    mapped_ss: dict[int, np.ndarray]

    @property
    def mapped_keys(self) -> list[int]:
        return sorted(self.mapping.keys())

    def unmapped_keys(self, db: SetDB) -> list[int]:
        return [k for k in range(db.size) if k not in self.mapping]

    def attach(self, db: SetDB) -> SetDB:
        """SetDB whose mapped genes carry the reference structure's
        residues + 3Di states (unmapped genes keep their own sequence and
        an all-X 3Di placeholder; they are never structure-searched)."""
        parts, ss_parts = [], []
        offsets = [0]
        for k in range(db.size):
            if k in self.mapping:
                seq = self.mapped_seq[k]
                ss = self.mapped_ss[k]
            else:
                seq = db.sequence(k)
                ss = np.full(len(seq), 20, dtype=np.uint8)  # X
            parts.append(seq)
            ss_parts.append(ss)
            offsets.append(offsets[-1] + len(seq))
        out = SetDB(dbtype=db.dbtype,
                    seq_data=np.concatenate(parts),
                    offsets=np.asarray(offsets, dtype=np.int64),
                    names=list(db.names), set_ids=db.set_ids.copy(),
                    headers=list(db.headers), sources=list(db.sources))
        out.ss_data = np.concatenate(ss_parts)
        out.finalize_metadata()
        return out


def load_mapping(out_dir: str | Path) -> FoldseekMapping:
    """Rebuild a FoldseekMapping from an aa2foldseek output dir (the
    attached SetDB + unmapped.npy); reference keys are not preserved
    (-1), which downstream search-mode 1 never needs."""
    out_dir = Path(out_dir)
    attached = SetDB.load(out_dir)
    unmapped = set(int(k) for k in np.load(out_dir / "unmapped.npy"))
    mapping, mapped_seq, mapped_ss = {}, {}, {}
    for k in range(attached.size):
        if k in unmapped:
            continue
        mapping[k] = -1
        mapped_seq[k] = attached.sequence(k)
        mapped_ss[k] = attached.ss_sequence(k)
    return FoldseekMapping(mapping=mapping, mapped_seq=mapped_seq,
                           mapped_ss=mapped_ss)


@dataclass
class Aa2FoldseekParams:
    """Defaults from setAa2FoldseekWorkflowDefaults (aa2foldseek.cpp:9-15)."""
    seq_id_thr: float = 0.9
    cov_thr: float = 0.9
    cov_mode: int = COV_MODE_BIDIRECTIONAL
    sensitivity: float = 5.7
    max_seqs: int = 300
    mask: bool = True


def aa2foldseek(db: SetDB, ref: StructureRef,
                params: Aa2FoldseekParams | None = None, *,
                device: torch.device | str) -> FoldseekMapping:
    """Map db's genes to ref's entries; the mapping search's SW passes
    run on `device`."""
    par = params or Aa2FoldseekParams()
    ref_db = ref.as_setdb()
    pref = PrefilterEngine(db, ref_db, sensitivity=par.sensitivity,
                           max_seqs=par.max_seqs, same_qt_db=False,
                           mask=par.mask,
                           cov_thr=par.cov_thr, cov_mode=par.cov_mode)
    cands = {qk: [h.seq_id for h in hits]
             for qk, hits in pref.match_all().items()}
    aln_par = AlignmentParams(eval_thr=1e-3, cov_thr=par.cov_thr,
                              cov_mode=par.cov_mode,
                              seq_id_thr=par.seq_id_thr)
    eng = AlignmentEngine(db, ref_db, aln_par, same_qt_db=False,
                          device=device)
    records = eng.align_all(cands)

    mapping: dict[int, int] = {}
    mapped_seq: dict[int, np.ndarray] = {}
    mapped_ss: dict[int, np.ndarray] = {}
    for qk, recs in records.items():
        if not recs:
            continue
        best = recs[0]  # compareHits order; --extract-lines 1
        mapping[qk] = best.tkey
        mapped_seq[qk] = ref.seqs[best.tkey]
        mapped_ss[qk] = ref.ss[best.tkey]
    return FoldseekMapping(mapping=mapping, mapped_seq=mapped_seq,
                           mapped_ss=mapped_ss)


def aa2foldseek_cli(argv: list[str]) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="spacedust aa2foldseek")
    p.add_argument("in_db", help="SetDB directory")
    p.add_argument("target", help="reference Foldseek DB base path")
    p.add_argument("out", nargs="?",
                   help="output dir for the structure-attached SetDB "
                        "(default <in_db>_foldseek)")
    p.add_argument("--min-seq-id", type=float, default=0.9)
    p.add_argument("-c", "--cov-thr", type=float, default=0.9)
    p.add_argument("--device", default="cuda",
                   help="torch device of the SW passes (default cuda; "
                        "cpu runs their plain PyTorch version)")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {a.device}: CUDA is not available")
    db = SetDB.load(a.in_db)
    ref = StructureRef.open(a.target)
    m = aa2foldseek(db, ref, Aa2FoldseekParams(seq_id_thr=a.min_seq_id,
                                               cov_thr=a.cov_thr),
                    device=device)
    out = a.out or (a.in_db.rstrip("/") + "_foldseek")
    attached = m.attach(db)
    attached.save(out)
    unmapped = m.unmapped_keys(db)
    np.save(Path(out) / "unmapped.npy", np.asarray(unmapped, dtype=np.int64))
    print(f"aa2foldseek: {len(m.mapping)}/{db.size} genes mapped -> {out} "
          f"({len(unmapped)} unmapped)")
    return 0
