"""SetDB — the columnar genome-set database.

Replaces the reference's DBReader/DBWriter flat-file triples
(lib/mmseqs/src/commons/DBReader.h:56-282) with a single columnar artifact:
concatenated residue arrays + offsets + per-gene metadata. The *logical*
schema of the reference is preserved exactly so output TSVs can match
bit-for-bit:

  * key        : dense uint32 gene id (0..N-1), the DB key
  * entry name : "{accession}_{posIdx}_{start}_{end}" with start>end
                 encoding the minus strand (data/createsetdb.sh:119-141,
                 src/workflow/gff2db.cpp:151-155)
  * set id     : source-file index (lookup fileNumber)
  * .source    : set id -> file basename (gff2db.cpp:39-49)
  * _set_size  : genes per set (createsetdb.sh:176-180)

On-disk layout: a directory with meta.json + numpy .npy arrays.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

DBTYPE_AMINO_ACIDS = "aminoacid"
DBTYPE_NUCLEOTIDES = "nucleotide"


@dataclass
class SetDB:
    dbtype: str
    seq_data: np.ndarray            # uint8, concatenated encoded residues
    offsets: np.ndarray             # int64, shape (N+1,)
    names: list[str]                # per-gene entry names (lookup column 2)
    set_ids: np.ndarray             # int32, per-gene set id (lookup column 3)
    headers: list[str]              # per-gene original header lines (no '>')
    sources: list[str]              # set id -> source file basename
    # optional per-gene parsed metadata (genome order / strand), derivable
    # from names but kept as arrays for device-side clustering:
    pos_idx: np.ndarray = field(default=None)     # int32 gene index in genome
    starts: np.ndarray = field(default=None)      # int64 CDS start (as in name)
    ends: np.ndarray = field(default=None)        # int64 CDS end
    # optional structural (3Di) states per gene, same offsets as seq_data
    # (the reference's *_ss sidecar DB, e.g. examples/foldseek_testdb):
    ss_data: np.ndarray = field(default=None)     # uint8 encoded 3Di states
    # on-disk home when loaded from an artifact dir (hosts index caches)
    path: str = field(default=None)

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.names)

    @property
    def num_sets(self) -> int:
        return len(self.sources)

    @property
    def lengths(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)

    @property
    def set_sizes(self) -> np.ndarray:
        return np.bincount(self.set_ids, minlength=self.num_sets).astype(np.int64)

    @property
    def total_residues(self) -> int:
        """DBReader::getAminoAcidDBSize equivalent (DBReader.cpp:589-598)."""
        return int(self.offsets[-1])

    def sequence(self, key: int) -> np.ndarray:
        return self.seq_data[self.offsets[key]:self.offsets[key + 1]]

    @property
    def has_ss(self) -> bool:
        return self.ss_data is not None

    def ss_sequence(self, key: int) -> np.ndarray:
        return self.ss_data[self.offsets[key]:self.offsets[key + 1]]

    def subset(self, keys: list[int]) -> "SetDB":
        """New SetDB containing the given genes (renumbered 0..n-1; names,
        set ids, and sidecar 3Di states preserved) — the createsubdb
        module equivalent."""
        keys = list(keys)
        parts = [self.sequence(k) for k in keys]
        offsets = np.concatenate(
            ([0], np.cumsum([len(p) for p in parts]))).astype(np.int64)
        sub = SetDB(
            dbtype=self.dbtype,
            seq_data=(np.concatenate(parts) if parts
                      else np.empty(0, np.uint8)),
            offsets=offsets,
            names=[self.names[k] for k in keys],
            set_ids=self.set_ids[keys].copy(),
            headers=[self.headers[k] for k in keys],
            sources=list(self.sources))
        if self.has_ss:
            sub.ss_data = np.concatenate(
                [self.ss_sequence(k) for k in keys]) if keys else \
                np.empty(0, np.uint8)
        sub.finalize_metadata()
        return sub

    def subrange(self, s: int, e: int) -> "SetDB":
        """Zero-copy SetDB over the contiguous gene range [s, e): token
        arrays are VIEWS of this DB's (possibly mmapped) arrays, so an
        out-of-core target split holds no resident copy of the shard --
        the DBReader MMAP-mode analog (DBReader.cpp mmap path,
        Prefiltering.cpp:662-723)."""
        off0 = int(self.offsets[s])
        sub = SetDB(
            dbtype=self.dbtype,
            seq_data=self.seq_data[off0:int(self.offsets[e])],
            offsets=(self.offsets[s:e + 1] - off0),
            names=self.names[s:e],
            set_ids=self.set_ids[s:e],
            headers=self.headers[s:e],
            sources=list(self.sources))
        if self.has_ss:
            sub.ss_data = self.ss_data[off0:int(self.offsets[e])]
        sub.finalize_metadata()
        return sub

    def ss_view(self) -> "SetDB":
        """A SetDB view whose primary residues are the 3Di states (shares
        all metadata) — feeds the structure-mode prefilter/index."""
        if not self.has_ss:
            raise ValueError("SetDB has no 3Di (_ss) data")
        return SetDB(dbtype=self.dbtype, seq_data=self.ss_data,
                     offsets=self.offsets, names=self.names,
                     set_ids=self.set_ids, headers=self.headers,
                     sources=self.sources, pos_idx=self.pos_idx,
                     starts=self.starts, ends=self.ends)

    def strand(self, key: int) -> bool:
        """True = plus strand (start < end), as ClusterHits.cpp:349-350."""
        return bool(self.starts[key] < self.ends[key])

    def finalize_metadata(self) -> None:
        """Parse names into pos/start/end arrays (ClusterHits.cpp:338-350)."""
        n = self.size
        pos = np.empty(n, dtype=np.int32)
        st = np.empty(n, dtype=np.int64)
        en = np.empty(n, dtype=np.int64)
        for i, name in enumerate(self.names):
            parts = name.split("_")
            pos[i] = int(parts[-3])
            st[i] = int(parts[-2])
            en[i] = int(parts[-1])
        self.pos_idx, self.starts, self.ends = pos, st, en

    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "seq_data.npy", self.seq_data)
        np.save(path / "offsets.npy", self.offsets)
        np.save(path / "set_ids.npy", self.set_ids)
        if self.ss_data is not None:
            np.save(path / "ss_data.npy", self.ss_data)
        meta = {
            "dbtype": self.dbtype,
            "names": self.names,
            "headers": self.headers,
            "sources": self.sources,
        }
        (path / "meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str | Path, mmap: bool = True) -> "SetDB":
        """Open an artifact dir; by default the token arrays are mmapped
        (page-cache backed, DBReader MMAP-mode analog) so a DB larger
        than RAM streams from disk and `--split-memory-limit` bounds the
        actual resident set."""
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        mode = "r" if mmap else None
        db = cls(
            dbtype=meta["dbtype"],
            seq_data=np.load(path / "seq_data.npy", mmap_mode=mode),
            offsets=np.load(path / "offsets.npy"),
            names=meta["names"],
            set_ids=np.load(path / "set_ids.npy"),
            headers=meta["headers"],
            sources=meta["sources"],
        )
        if (path / "ss_data.npy").exists():
            db.ss_data = np.load(path / "ss_data.npy", mmap_mode=mode)
        db.finalize_metadata()
        db.path = str(path)      # artifact home (also hosts index caches)
        return db

    @classmethod
    def exists(cls, path: str | Path) -> bool:
        return (Path(path) / "meta.json").exists()
