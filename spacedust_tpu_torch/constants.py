"""Alphabet and residue-mapping constants.

The amino-acid alphabet order follows the reference matrix header
(lib/mmseqs/data/blosum62.out: A C D E F G H I K L M N P Q R S T V W Y X)
and the letter-mapping rules of SubstitutionMatrix::setupLetterMapping
(lib/mmseqs/src/commons/SubstitutionMatrix.cpp:257-298): J->L, U/O->X,
Z->E, B->D, any other byte -> X; case-insensitive.
"""

import numpy as np

AA_ORDER = "ACDEFGHIKLMNPQRSTVWYX"
ALPHABET_SIZE = len(AA_ORDER)  # 21
X_INDEX = AA_ORDER.index("X")  # 20

AA_TO_NUM = {aa: i for i, aa in enumerate(AA_ORDER)}

# Nucleotide alphabet used by the nucleotide path (NucleotideMatrix ordering).
NUCL_ORDER = "ACGT"

_SPECIAL = {"J": "L", "U": "X", "O": "X", "Z": "E", "B": "D"}


def _build_aa_lookup() -> np.ndarray:
    """256-entry byte -> residue-index table (uint8)."""
    table = np.full(256, X_INDEX, dtype=np.uint8)
    for aa, idx in AA_TO_NUM.items():
        table[ord(aa)] = idx
        table[ord(aa.lower())] = idx
    for src, dst in _SPECIAL.items():
        table[ord(src)] = AA_TO_NUM[dst]
        table[ord(src.lower())] = AA_TO_NUM[dst]
    return table


AA_LOOKUP = _build_aa_lookup()


def encode_aa(seq: str | bytes) -> np.ndarray:
    """Encode an amino-acid string into residue indices (uint8)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return AA_LOOKUP[np.frombuffer(seq, dtype=np.uint8)]


def decode_aa(arr: np.ndarray) -> str:
    return "".join(AA_ORDER[i] for i in arr)


# Reverse-complement table for nucleotide ingestion, matching
# Orf::iupacReverseComplementTable (lib/mmseqs/src/commons/Orf.cpp:48-52):
# IUPAC-aware, lower-case maps to lower-case, any other byte maps to '.'.
_COMPLEMENT_PAIRS = {
    "A": "T", "T": "A", "G": "C", "C": "G", "U": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "N": "N",
}


def _build_complement() -> np.ndarray:
    table = np.full(256, ord("."), dtype=np.uint8)
    for a, b in _COMPLEMENT_PAIRS.items():
        table[ord(a)] = ord(b)
        table[ord(a.lower())] = ord(b.lower())
    return table


COMPLEMENT_LOOKUP = _build_complement()


def reverse_complement(seq: bytes) -> bytes:
    arr = np.frombuffer(seq, dtype=np.uint8)
    return COMPLEMENT_LOOKUP[arr][::-1].tobytes()
