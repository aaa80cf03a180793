"""ORF extraction and ORF->contig coordinate mapping.

Native equivalents of the reference's extractorfs module
(lib/mmseqs/src/util/extractorfs.cpp + commons/Orf.cpp) and
offsetalignment (lib/mmseqs/src/util/offsetalignment.cpp):

  * `find_orfs` replicates Orf::findForward's per-frame state machine
    (Orf.cpp:228-351): starts per --orf-start-mode, stop/edge handling
    including the first-codon-stop skip and the trailing-codon
    inclusion rule, gap/N counting, min/max length filters.
  * `extract_orfs` applies the contig start/end-mode filters and emits
    (sequence, header) pairs with Orf::writeOrfHeader's
    `key\\tfrom{+|-}len[\\tcomplete]` codec (Orf.cpp:440-457).
  * `offset_alignment` maps ORF-coordinate alignment records back to
    contig coordinates (offsetalignment.cpp:90-160 updateOffset),
    including the x3 amino-acid->nucleotide scaling and minus-strand
    end adjustment.
"""

from __future__ import annotations

from dataclasses import dataclass

from .translate import start_codons, stop_codons, translate

_COMPLEMENT = {
    "A": "T", "T": "A", "U": "A", "G": "C", "C": "G", "N": "N",
    "S": "S", "W": "W", "R": "Y", "Y": "R", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "X": "X",
}

# orf-start-mode values (Parameters.cpp:192)
START_TO_STOP = 0
ANY_TO_STOP = 1
LAST_START_TO_STOP = 2


@dataclass
class OrfLocation:
    from_: int               # strand-local start (inclusive)
    to: int                  # strand-local end (inclusive)
    incomplete_start: bool
    incomplete_end: bool
    strand: int              # +1 / -1


def reverse_complement(seq: str) -> str:
    return "".join(_COMPLEMENT.get(c.upper(), "X") for c in reversed(seq))


def _find_forward(seq: str, min_length: int, max_length: int, max_gaps: int,
                  frames: set[int], start_mode: int, starts: set[str],
                  stops: set[str], strand: int) -> list[OrfLocation]:
    n = len(seq)
    res: list[OrfLocation] = []
    if n < 3:
        return res
    su = seq.upper()

    def incomplete(pos: int) -> bool:
        return pos + 3 > n

    is_inside = [True, True, True]
    has_start = [False, False, False]
    count_gaps = [0, 0, 0]
    count_len = [0, 0, 0]
    from_ = [0, 1, 2]
    for position in range(0, n - 2):
        frame = position % 3
        if (frame + 1) not in frames:
            continue
        codon = su[position:position + 3]
        is_last = not incomplete(position) and incomplete(position + 3)

        if start_mode == START_TO_STOP:
            should_start = not is_inside[frame] and codon in starts
        elif start_mode == ANY_TO_STOP:
            should_start = not is_inside[frame]
        else:  # LAST_START_TO_STOP
            should_start = codon in starts
        if should_start:
            is_inside[frame] = True
            has_start[frame] = True
            from_[frame] = position
            count_gaps[frame] = 0
            count_len[frame] = 0

        stop = codon in stops
        if is_inside[frame]:
            if not stop:
                count_len[frame] += 1
            if any(c in "N.-" for c in codon):
                count_gaps[frame] += 1

        if is_inside[frame] and (stop or is_last):
            is_inside[frame] = False
            if count_len[frame] == 0 and stop:
                continue
            to = position + (2 if (is_last and not stop) else -1)
            if (count_gaps[frame] > max_gaps
                    or count_len[frame] > max_length
                    or count_len[frame] < min_length):
                continue
            res.append(OrfLocation(from_[frame], to, not has_start[frame],
                                   not stop, strand))
    return res


def find_orfs(seq: str, min_length: int = 30, max_length: int = 32734,
              max_gaps: int = 2147483647,
              forward_frames: set[int] = frozenset({1, 2, 3}),
              reverse_frames: set[int] = frozenset({1, 2, 3}),
              start_mode: int = ANY_TO_STOP,
              translation_table: int = 1,
              use_all_table_starts: bool = False) -> list[OrfLocation]:
    """Orf::findAll: forward ORFs on the sequence, then on the reverse
    complement (positions are strand-local)."""
    starts = set(start_codons(translation_table, use_all_table_starts))
    stops = set(stop_codons(translation_table))
    out = _find_forward(seq, min_length, max_length, max_gaps,
                        set(forward_frames), start_mode, starts, stops, +1)
    if reverse_frames:
        out += _find_forward(reverse_complement(seq), min_length, max_length,
                             max_gaps, set(reverse_frames), start_mode,
                             starts, stops, -1)
    return out


def write_orf_header(key: int, from_pos: int, to_pos: int,
                     incomplete_start: bool, incomplete_end: bool) -> str:
    """Orf::writeOrfHeader codec: `key\\tfrom{+|-}len[\\tcomplete]`."""
    sign = "+" if from_pos < to_pos else "-"
    length = abs(from_pos - to_pos)
    s = f"{key}\t{from_pos}{sign}{length}"
    complete = int(incomplete_start) | (int(incomplete_end) << 1)
    if complete:
        s += f"\t{complete}"
    return s


def parse_orf_header(header: str) -> tuple[int, int, int, bool, bool, int]:
    """Inverse codec (Orf::parseOrfHeader): returns
    (contig_key, from, to, incomplete_start, incomplete_end, strand)."""
    cols = header.split()
    key = int(cols[0])
    body = cols[1]
    sign_pos = max(body.find("+"), body.find("-"))
    from_pos = int(body[:sign_pos])
    length = int(body[sign_pos + 1:])
    to_pos = from_pos + length if body[sign_pos] == "+" else from_pos - length
    complete = int(cols[2]) if len(cols) > 2 else 0
    strand = +1 if from_pos <= to_pos else -1
    return (key, from_pos, to_pos, bool(complete & 1), bool(complete & 2),
            strand)


def extract_orfs(seqs: dict[int, str], translate_orfs: bool = False,
                 min_length: int = 30, max_length: int = 32734,
                 max_gaps: int = 2147483647,
                 forward_frames: set[int] = frozenset({1, 2, 3}),
                 reverse_frames: set[int] = frozenset({1, 2, 3}),
                 start_mode: int = ANY_TO_STOP,
                 contig_start_mode: int = 2, contig_end_mode: int = 2,
                 translation_table: int = 1,
                 use_all_table_starts: bool = False
                 ) -> tuple[dict[int, str], dict[int, str]]:
    """extractorfs: contig DB -> (orf sequence DB, orf header DB) with
    sequential keys (the reference renumbers on close). Headers carry
    contig-coordinate positions (minus strand: from > to)."""
    out_seq: dict[int, str] = {}
    out_hdr: dict[int, str] = {}
    next_key = 0
    for key in seqs:
        contig = seqs[key].strip()
        n = len(contig)
        rc = reverse_complement(contig)
        for loc in find_orfs(contig, min_length, max_length, max_gaps,
                             forward_frames, reverse_frames, start_mode,
                             translation_table, use_all_table_starts):
            if contig_start_mode < 2 and loc.incomplete_start == bool(
                    contig_start_mode):
                continue
            if contig_end_mode < 2 and loc.incomplete_end == bool(
                    contig_end_mode):
                continue
            src = contig if loc.strand > 0 else rc
            orf_nt = src[loc.from_:loc.to + 1]
            from_pos, to_pos = loc.from_, loc.to
            if loc.strand < 0:
                from_pos = (n - 1) - loc.from_
                to_pos = (n - 1) - loc.to
            if translate_orfs:
                usable = len(orf_nt) - len(orf_nt) % 3
                if usable < 3:
                    continue
                out_seq[next_key] = translate(
                    orf_nt[:usable].encode(), translation_table)
            else:
                out_seq[next_key] = orf_nt
            out_hdr[next_key] = write_orf_header(
                key, from_pos, to_pos, loc.incomplete_start,
                loc.incomplete_end)
            next_key += 1
    return out_seq, out_hdr


def offset_alignment(cols: list[str], orf_header: str,
                     is_nucleotide: bool, update_target: bool) -> list[str]:
    """Map one alignment record's target (update_target) or query
    coordinates from ORF space to contig space (updateOffset,
    offsetalignment.cpp:90-160). `cols` is an alignment line
    [tkey score seqid eval qs qe qlen ts te tlen ...]; returns the
    rewritten columns."""
    key, from_pos, to_pos, _is, _ie, strand = parse_orf_header(orf_header)
    cols = list(cols)
    if update_target:
        s_i, e_i, key_i = 7, 8, 0
    else:
        s_i, e_i, key_i = 4, 5, None
    start = int(cols[s_i])
    end = int(cols[e_i])
    if not is_nucleotide:
        start *= 3
        end *= 3
    if strand < 0:
        new_start = from_pos - start
        new_end = from_pos - end
        if not is_nucleotide:
            new_end -= 2
    else:
        new_start = from_pos + start
        new_end = from_pos + end
        if not is_nucleotide:
            new_end += 2
    cols[s_i] = str(new_start)
    cols[e_i] = str(new_end)
    if key_i is not None:
        cols[key_i] = str(key)
    return cols
