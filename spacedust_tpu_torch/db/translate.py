"""Codon translation (translatenucs equivalent).

Implements NCBI genetic-code tables as used by TranslateNucl
(lib/mmseqs/src/commons/TranslateNucl.h) and the translatenucs module
(lib/mmseqs/src/util/translatenucs.cpp): sequences are trimmed to a
multiple of three, codons with ambiguous bases translate via IUPAC
expansion when unambiguous in outcome, otherwise 'X'; stop codons emit '*'.
"""

from __future__ import annotations

import numpy as np

# All NCBI genetic-code tables supported by the reference's TranslateNucl
# (lib/mmseqs/src/commons/TranslateNucl.h:82-242; pinned NCBI data).
# Codon order TTT, TTC, TTA, TTG, CTT... indexed by base order T, C, A, G.
# Values: (ncbieaa AA string, sncbieaa start/stop string — 'M' marks an
# alternative start codon, '*' a start-table stop).
_NCBI_TABLES_FULL = {
    1:  ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**--*----M---------------M----------------------------"),
    2:  ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
         "----------**--------------------MMMM----------**---M------------"),
    3:  ("FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**----------------------MM----------------------------"),
    4:  ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--MM------**-------M------------MMMM---------------M------------"),
    5:  ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
         "---M------**--------------------MMMM---------------M------------"),
    6:  ("FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------*--------------------M----------------------------"),
    9:  ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "----------**-----------------------M---------------M------------"),
    10: ("FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**-----------------------M----------------------------"),
    11: ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**--*----M------------MMMM---------------M------------"),
    12: ("FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**--*----M---------------M----------------------------"),
    13: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
         "---M------**----------------------MM---------------M------------"),
    14: ("FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "-----------*-----------------------M----------------------------"),
    15: ("FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------*---*--------------------M----------------------------"),
    16: ("FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------*---*--------------------M----------------------------"),
    21: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "----------**-----------------------M---------------M------------"),
    22: ("FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "------*---*---*--------------------M----------------------------"),
    23: ("FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--*-------**--*-----------------M--M---------------M------------"),
    24: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
         "---M------**-------M---------------M---------------M------------"),
    25: ("FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**-----------------------M---------------M------------"),
    26: ("FFLLSSSSYY**CC*WLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**--*----M---------------M----------------------------"),
    27: ("FFLLSSSSYYQQCCWWLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------*--------------------M----------------------------"),
    28: ("FFLLSSSSYYQQCCWWLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**--*--------------------M----------------------------"),
    29: ("FFLLSSSSYYYYCC*WLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------*--------------------M----------------------------"),
    30: ("FFLLSSSSYYEECC*WLLLAPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "--------------*--------------------M----------------------------"),
    31: ("FFLLSSSSYYEECCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**-----------------------M----------------------------"),
}

_NCBI_TABLES = {k: v[0] for k, v in _NCBI_TABLES_FULL.items()}


def stop_codons(table_id: int) -> list[str]:
    """Stop codons of a table (TranslateNucl::getStopCodons)."""
    aas = _NCBI_TABLES[table_id]
    return [_codon_str(i) for i in range(64) if aas[i] == "*"]


def start_codons(table_id: int, use_all_table_starts: bool = False
                 ) -> list[str]:
    """Start codons (Orf::Orf: ATG only unless --use-all-table-starts)."""
    if not use_all_table_starts:
        return ["ATG"]
    starts = _NCBI_TABLES_FULL[table_id][1]
    return [_codon_str(i) for i in range(64) if starts[i] == "M"]


def _codon_str(idx: int) -> str:
    return (_BASE_ORDER[idx // 16] + _BASE_ORDER[(idx // 4) % 4]
            + _BASE_ORDER[idx % 4])

_BASE_ORDER = "TCAG"
_IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "AG", "Y": "CT", "S": "GC", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


def _build_codon_lookup(table_id: int) -> np.ndarray:
    """Map (b0*25 + b1*5 + b2) -> amino-acid byte, with 5-letter base
    alphabet {T,C,A,G,ambiguous}; ambiguity resolved via IUPAC expansion."""
    aas = _NCBI_TABLES[table_id]

    def translate_exact(c0: int, c1: int, c2: int) -> str:
        return aas[c0 * 16 + c1 * 4 + c2]

    table: dict[bytes, int] = {}
    letters = list(_IUPAC.keys())
    for a in letters:
        for b in letters:
            for c in letters:
                outs = set()
                for ea in _IUPAC[a]:
                    for eb in _IUPAC[b]:
                        for ec in _IUPAC[c]:
                            outs.add(translate_exact(
                                _BASE_ORDER.index(ea),
                                _BASE_ORDER.index(eb),
                                _BASE_ORDER.index(ec)))
                aa = outs.pop() if len(outs) == 1 else "X"
                table[(a + b + c).encode()] = ord(aa)
    return table  # type: ignore[return-value]


_CODON_CACHE: dict[int, dict[bytes, int]] = {}


def translate(seq: bytes, table_id: int = 1) -> str:
    """Translate a nucleotide sequence (bytes) to a protein string.

    Trims to a multiple of 3 (translatenucs.cpp:70-75). Unknown codons -> X.
    """
    if table_id not in _CODON_CACHE:
        _CODON_CACHE[table_id] = _build_codon_lookup(table_id)
    table = _CODON_CACHE[table_id]
    seq = seq.upper()
    n = len(seq) - (len(seq) % 3)
    out = bytearray(n // 3)
    for i in range(0, n, 3):
        out[i // 3] = table.get(seq[i:i + 3], ord("X"))
    return out.decode("ascii")
