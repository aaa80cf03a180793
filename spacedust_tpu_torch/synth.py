"""Seeded synthetic genome sets: Prodigal-header protein FASTAs.

A stand-in for a pair of bacterial proteomes (the reference's regression
pair is E. coli K-12, 4,300 proteins, and H. pylori 26695, ~1,600) when
the real FASTAs are not at hand.  Everything is drawn from
`numpy.random.default_rng(seed)` through `random()` and `integers()` only,
with integer arithmetic for every length and position, so a seed gives
byte-identical files on any machine.

Per genome set:
  * gene lengths from a bacterial-proteome histogram (median ~280 aa,
    30-2,500 aa), plus giant genes of 5,000-6,000 aa (longer ones would
    wrap the identity fast path's int16 raw score -- scoreIdentical
    semantics -- to a negative score and an infinite E-value);
  * residues from the BLOSUM62 background frequencies;
  * cross-genome homolog pairs at 30-95 % identity with indels, about a
    third of them in conserved neighbourhood blocks of 3-10 consecutive
    genes, some blocks on the opposite strand in the second genome;
  * paralog families of 3-20 members within each genome.

Run as `python -m spacedust_tpu_torch.synth OUT_DIR [--size real|small|
...] [--seed N]`; it writes genome_a.faa and genome_b.faa.

The repeat sets (`--size repeats`, `repeats_tiny`) are a generator of
their own on its own stream of the seed (make_repeat_genomes), for the
alternative alignments of `--alt-ali`, which arise only where a target
holds a domain more than once: the first two thirds of genome B's genes
are homologs of genome A's at the same position (one conserved
neighbourhood), and every second of them carries a tandem copy of its
first or last 60-150 aa, every fourth two copies.  `repeats` (60 + 60 genes)
draws lengths from the histogram and mutates with indels; `repeats_tiny`
(36 + 36) keeps to the gene lengths 120 and 180, a 60 aa segment and
substitutions only, so that its pairs have few distinct shapes.

The family set (`--size families`, 90 + 90 genes, make_family_genomes,
its own stream of the seed) is for the iterative profile search (`search
--num-iterations`): 30 chains of divergence of 4-6 genes of 150-350 aa,
each gene mutated from the one before it at 40-50 % identity, so that
neighbours in a chain align but its ends are remote, among unrelated
genes, in a shuffled order.  A sequence search finds the neighbours; the
profiles built from those hits reach further.  Round 0 of the JAX
package's `search --num-iterations 2` gives 421 records there and the
profile round adds 95 (516 in all).

Structure mode (`--struct`) writes, from its own stream of the same
seed, a Foldseek-style flat DB of the same two genome sizes (`genomes`,
`genomes_h` with Prodigal headers, the `genomes_ss` 3Di sidecar,
`genomes.lookup`, `genomes.source` and the `.dbtype` files: the layout a
pre-built DB gives `createsetdb`) and a reference structure DB for
`aa2foldseek` (`ref`, `ref_ss`, `ref.lookup`):
  * gene lengths from the same histogram, capped at STRUCT_MAX_LEN =
    2,700 aa (AlphaFold DB's limit; the combined 3Di+AA self-score of
    ~10.4 per residue wraps the int16 identity score at ~3,100 aa);
  * residues from the BLOSUM62 background, 3Di states from mat3di's;
  * cross-genome homologs at remote amino-acid identity (25-60 %) with
    better-kept 3Di (60-85 %) and the same indels in both channels, in
    conserved blocks (some inverted) and scattered; paralog families;
  * the reference DB holds near-identical variants (>= 95 % identity,
    full length, 3Di nearly unchanged) of ~70 % of each genome's genes,
    in shuffled key order.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .constants import AA_ORDER

SEED = 20261016
SIZES = {"real": (4300, 1600), "half": (2150, 800), "small": (150, 150),
         "repeats": (60, 60), "repeats_tiny": (36, 36),
         "families": (90, 90)}
# the repeat sets: gene lengths and the repeated segment's length (None:
# the histogram, at least 120 aa, and 60-150 aa)
REPEAT_SIZES = {"repeats": (None, None), "repeats_tiny": ((120, 180), 60)}
REPEAT_STREAM = 5       # the repeat sets' RNG stream of a seed
# the family set: chains of FAMILY_MEMBERS [lo, hi) genes of FAMILY_LEN
# [lo, hi) aa, each mutated from the one before at FAMILY_IDENT [lo, hi) %
FAMILY_STREAM = 7
FAMILIES = 30
FAMILY_MEMBERS = (4, 7)
FAMILY_LEN = (150, 351)
FAMILY_IDENT = (40, 51)

# length histogram: (lo, hi, weight per mille), lo inclusive, hi exclusive
_LEN_BINS = ((30, 100, 80), (100, 150, 90), (150, 200, 110),
             (200, 250, 120), (250, 300, 120), (300, 350, 100),
             (350, 400, 90), (400, 500, 120), (500, 700, 100),
             (700, 1000, 50), (1000, 1500, 16), (1500, 2501, 4))


STRUCT_MAX_LEN = 2700
STRUCT_STREAM = 3       # the structure set's RNG stream of a seed


def _background(name: str = "blosum62.json") -> np.ndarray:
    raw = json.loads((Path(__file__).resolve().parent / "data"
                      / name).read_text())
    p = np.asarray(raw["background"][:20], dtype=np.float64)
    return np.cumsum(p / p.sum())


class _Gen:
    def __init__(self, seed: int, stream: int | None = None):
        self.rng = np.random.default_rng(
            seed if stream is None else [seed, stream])
        self.cdf = _background()
        self.ss_cdf = None

    def ints(self, lo: int, hi: int, n: int | None = None):
        """Uniform integers in [lo, hi)."""
        return self.rng.integers(lo, hi, size=n)

    def residues(self, n: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, self.rng.random(n), side="right")
        return np.minimum(idx, 19).astype(np.uint8)

    def states(self, n: int) -> np.ndarray:
        """3Di states from mat3di's background frequencies."""
        if self.ss_cdf is None:
            self.ss_cdf = _background("derived/mat3di.json")
        idx = np.searchsorted(self.ss_cdf, self.rng.random(n), side="right")
        return np.minimum(idx, 19).astype(np.uint8)

    def length(self) -> int:
        w = np.cumsum([b[2] for b in _LEN_BINS])
        k = int(np.searchsorted(w, self.ints(0, int(w[-1])), side="right"))
        lo, hi, _ = _LEN_BINS[k]
        return int(self.ints(lo, hi))

    def protein(self, n: int) -> np.ndarray:
        seq = self.residues(n)
        seq[0] = AA_ORDER.index("M")
        return seq

    def mutate(self, seq: np.ndarray, ident_pct: int) -> np.ndarray:
        """Substitutions at (100 - ident_pct) % of positions plus short
        indels at a tenth of that rate."""
        n = len(seq)
        out = seq.copy()
        sub = self.ints(0, 100, n) >= ident_pct
        out[sub] = self.residues(int(sub.sum()))
        n_indel = int((100 - ident_pct) * n // 1000)
        for _ in range(n_indel):
            pos = int(self.ints(1, max(len(out), 2)))
            k = int(self.ints(1, 6))
            if self.ints(0, 2) == 0:
                out = np.concatenate([out[:pos], self.residues(k),
                                      out[pos:]])
            elif len(out) > k + 30:
                out = np.concatenate([out[:pos], out[pos + k:]])
        return out


def make_genomes(sizes: tuple[int, int], seed: int = SEED):
    """Two genomes as lists of (protein, strand) in genome order."""
    g = _Gen(seed)
    na, nb = sizes
    genomes = [[[g.protein(g.length()), 1 if g.ints(0, 2) else -1]
                for _ in range(n)] for n in (na, nb)]
    scale = min(na, nb)
    used = [set(), set()]

    def free_run(gi: int, k: int) -> int:
        """Start of k consecutive genes not yet planted on."""
        n = len(genomes[gi])
        while True:
            s = int(g.ints(0, n - k + 1))
            if not used[gi] & set(range(s, s + k)):
                used[gi].update(range(s, s + k))
                return s

    # giant genes: two in genome A, one in B homologous to the first
    if scale >= 1000:
        a1, a2, b1 = free_run(0, 1), free_run(0, 1), free_run(1, 1)
        genomes[0][a1][0] = g.protein(int(g.ints(5500, 6001)))
        genomes[0][a2][0] = g.protein(int(g.ints(5000, 5501)))
        genomes[1][b1][0] = g.mutate(
            genomes[0][a1][0][:int(g.ints(5000, 5501))], 60)

    # conserved neighbourhood blocks, some inverted in genome B
    n_blocks = max(2, 20 * scale // 1600)
    for b in range(n_blocks):
        k = int(g.ints(3, 11))
        sa, sb = free_run(0, k), free_run(1, k)
        inverted = b % 3 == 2
        for i in range(k):
            prot, strand = genomes[0][sa + i]
            j = sb + (k - 1 - i if inverted else i)
            genomes[1][j] = [g.mutate(prot, int(g.ints(30, 96))),
                             -strand if inverted else strand]

    # scattered cross-genome homologs
    n_single = max(4, 280 * scale // 1600)
    for _ in range(n_single):
        sa, sb = free_run(0, 1), free_run(1, 1)
        genomes[1][sb][0] = g.mutate(genomes[0][sa][0],
                                     int(g.ints(30, 96)))

    # paralog families within each genome
    for gi, n in ((0, na), (1, nb)):
        for _ in range(max(1, n // 150)):
            members = int(g.ints(3, 21)) if n >= 1000 else int(g.ints(3, 6))
            founder = free_run(gi, 1)
            for _ in range(members - 1):
                j = free_run(gi, 1)
                genomes[gi][j][0] = g.mutate(genomes[gi][founder][0],
                                             int(g.ints(40, 91)))
    return genomes


def make_repeat_genomes(size: str, seed: int = SEED):
    """Two genomes as lists of (protein, strand) for a key of
    REPEAT_SIZES: homologs with tandem copies of a segment."""
    g = _Gen(seed, REPEAT_STREAM)
    lengths, seg_len = REPEAT_SIZES[size]
    na, nb = SIZES[size]

    def gene() -> list:
        n = (int(lengths[int(g.ints(0, len(lengths)))]) if lengths
             else max(g.length(), 120))
        return [g.protein(n), 1 if g.ints(0, 2) else -1]

    def variant(seq: np.ndarray, lo: int, hi: int) -> np.ndarray:
        ident = int(g.ints(lo, hi))
        if not lengths:
            return g.mutate(seq, ident)
        out = seq.copy()
        sub = g.ints(0, 100, len(seq)) >= ident
        out[sub] = g.residues(int(sub.sum()))
        return out

    genomes = [[gene() for _ in range(n)] for n in (na, nb)]
    for k in range(min(na, nb) * 2 // 3):
        prot, strand = genomes[0][k]
        hom = variant(prot, 50, 96)
        copies = 0 if k % 2 else (2 if k % 4 == 0 else 1)
        if copies:
            n_seg = seg_len or int(g.ints(60, 151))
            n_seg = min(n_seg, len(hom) // 2)
            # at an end of the gene: inside it, one alignment with a gap
            # would span both copies and leave nothing to find
            start = len(hom) - n_seg if k % 8 < 4 else 0
            seg = hom[start:start + n_seg]
            hom = np.concatenate(
                [hom[:start + n_seg]]
                + [variant(seg, 70, 96) for _ in range(copies)]
                + [hom[start + n_seg:]])
        genomes[1][k] = [hom, strand]
    return genomes


def make_family_genomes(seed: int = SEED):
    """Two genomes as lists of (protein, strand): FAMILIES chains of
    divergence (each member mutated from the one before it at
    FAMILY_IDENT % identity, so a chain's ends are remote) and unrelated
    genes to fill SIZES["families"], all in a shuffled order."""
    g = _Gen(seed, FAMILY_STREAM)
    lo, hi = FAMILY_LEN
    genes = []
    for _ in range(FAMILIES):
        prot = g.protein(int(g.ints(lo, hi)))
        genes.append(prot)
        for _ in range(int(g.ints(*FAMILY_MEMBERS)) - 1):
            prot = g.mutate(prot, int(g.ints(*FAMILY_IDENT)))
            genes.append(prot)
    na, nb = SIZES["families"]
    while len(genes) < na + nb:
        genes.append(g.protein(int(g.ints(lo, hi))))
    order = g.rng.permutation(len(genes))
    genes = [[genes[int(k)], 1 if g.ints(0, 2) else -1] for k in order]
    return genes[:na], genes[na:]


def _headers(contig: str, genes) -> list[str]:
    """Prodigal-style headers `contig_i # start # end # strand # ...` of
    genes (protein, strand, ...) laid out along one contig."""
    out = []
    pos = 1
    for i, (prot, strand, *_rest) in enumerate(genes, start=1):
        start = pos
        end = start + 3 * (len(prot) + 1) - 1
        pos = end + 1 + (int(prot[1]) * 7 + i * 13) % 190 + 10
        out.append(f"{contig}_{i} # {start} # {end} # {strand} # "
                   f"ID={contig}_{i};partial=00;start_type=ATG")
    return out


def write_fasta(path: Path, contig: str, genes) -> None:
    """Prodigal-style headers: `>contig_i # start # end # strand # ...`."""
    lines = []
    for head, (prot, _strand) in zip(_headers(contig, genes), genes):
        lines.append(f">{head}")
        seq = "".join(AA_ORDER[int(c)] for c in prot)
        lines += [seq[k:k + 60] for k in range(0, len(seq), 60)]
    path.write_text("\n".join(lines) + "\n")


def write_genome_set(out_dir: str | Path, size: str = "real",
                     seed: int = SEED) -> list[Path]:
    """Write genome_a.faa / genome_b.faa for `size` (a key of SIZES);
    returns their paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    genomes = (make_repeat_genomes(size, seed) if size in REPEAT_SIZES
               else make_family_genomes(seed) if size == "families"
               else make_genomes(SIZES[size], seed))
    for tag, genes in zip("ab", genomes):
        p = out / f"genome_{tag}.faa"
        # the repeat and family sets name their contigs apart, so that one
        # setDB can hold them beside another set
        prefix = ("REP" if size in REPEAT_SIZES
                  else "FAM" if size == "families" else "SYN")
        write_fasta(p, f"{prefix}{tag.upper()}_000001.1", genes)
        paths.append(p)
    return paths


# ------------------------------------------------------------ structure set
def _struct_mutate(g: _Gen, aa: np.ndarray, ss: np.ndarray, aa_ident: int,
                   ss_ident: int) -> tuple[np.ndarray, np.ndarray]:
    """Independent substitutions per channel ((100 - ident) % of
    positions), then short indels at a tenth of the 3Di change rate,
    applied to both channels at the same place so they stay aligned."""
    n = len(aa)
    aa, ss = aa.copy(), ss.copy()
    sub = g.ints(0, 100, n) >= aa_ident
    aa[sub] = g.residues(int(sub.sum()))
    sub = g.ints(0, 100, n) >= ss_ident
    ss[sub] = g.states(int(sub.sum()))
    for _ in range((100 - ss_ident) * n // 1000):
        pos = int(g.ints(1, max(len(aa), 2)))
        k = int(g.ints(1, 6))
        if g.ints(0, 2) == 0:
            aa = np.concatenate([aa[:pos], g.residues(k), aa[pos:]])
            ss = np.concatenate([ss[:pos], g.states(k), ss[pos:]])
        elif len(aa) > k + 30:
            aa = np.concatenate([aa[:pos], aa[pos + k:]])
            ss = np.concatenate([ss[:pos], ss[pos + k:]])
    if len(aa) > STRUCT_MAX_LEN:
        aa, ss = aa[:STRUCT_MAX_LEN], ss[:STRUCT_MAX_LEN]
    return aa, ss


def make_struct_genomes(sizes: tuple[int, int], seed: int = SEED):
    """Two genomes as lists of [protein, strand, 3Di states] in genome
    order, and the reference structure entries [(genome, gene, protein,
    3Di states)] in key order."""
    g = _Gen(seed, STRUCT_STREAM)

    def gene(n: int) -> list:
        return [g.protein(min(n, STRUCT_MAX_LEN)),
                1 if g.ints(0, 2) else -1, g.states(min(n, STRUCT_MAX_LEN))]

    na, nb = sizes
    genomes = [[gene(g.length()) for _ in range(n)] for n in (na, nb)]
    scale = min(na, nb)
    used = [set(), set()]

    def free_run(gi: int, k: int) -> int:
        n = len(genomes[gi])
        while True:
            s = int(g.ints(0, n - k + 1))
            if not used[gi] & set(range(s, s + k)):
                used[gi].update(range(s, s + k))
                return s

    def homolog(src: list, strand: int) -> list:
        aa, ss = _struct_mutate(g, src[0], src[2], int(g.ints(25, 61)),
                                int(g.ints(60, 86)))
        return [aa, strand, ss]

    # long genes at the cap: two in genome A, one homolog of the first in B
    if scale >= 1000:
        a1, a2, b1 = free_run(0, 1), free_run(0, 1), free_run(1, 1)
        genomes[0][a1] = gene(int(g.ints(2500, STRUCT_MAX_LEN + 1)))
        genomes[0][a2] = gene(int(g.ints(2500, STRUCT_MAX_LEN + 1)))
        genomes[1][b1] = homolog(genomes[0][a1], genomes[1][b1][1])

    # conserved neighbourhood blocks, some inverted in genome B
    for b in range(max(4, 20 * scale // 1600)):
        k = int(g.ints(3, 11))
        sa, sb = free_run(0, k), free_run(1, k)
        inverted = b % 3 == 2
        for i in range(k):
            src = genomes[0][sa + i]
            genomes[1][sb + (k - 1 - i if inverted else i)] = homolog(
                src, -src[1] if inverted else src[1])

    # scattered cross-genome homologs
    for _ in range(max(4, 280 * scale // 1600)):
        sa, sb = free_run(0, 1), free_run(1, 1)
        genomes[1][sb] = homolog(genomes[0][sa], genomes[1][sb][1])

    # paralog families within each genome
    for gi, n in ((0, na), (1, nb)):
        for _ in range(max(1, n // 150)):
            members = int(g.ints(3, 21)) if n >= 1000 else int(g.ints(3, 6))
            founder = free_run(gi, 1)
            for _ in range(members - 1):
                j = free_run(gi, 1)
                genomes[gi][j] = homolog(genomes[gi][founder],
                                         genomes[gi][j][1])

    # reference structures: near-identical variants of ~70 % of the genes
    ref = []
    for gi, genes in enumerate(genomes):
        for i, (aa, _strand, ss) in enumerate(genes):
            if g.ints(0, 100) >= 70:
                continue
            aa2, ss2 = aa.copy(), ss.copy()
            sub = g.ints(0, 100, len(aa)) < int(g.ints(0, 5))
            aa2[sub] = g.residues(int(sub.sum()))
            sub = g.ints(0, 100, len(ss)) < 2
            ss2[sub] = g.states(int(sub.sum()))
            ref.append((gi, i, aa2, ss2))
    order = g.rng.permutation(len(ref))
    return genomes, [ref[int(k)] for k in order]


def _decode(tokens: np.ndarray) -> str:
    return "".join(AA_ORDER[int(c)] for c in tokens)


def write_struct_set(out_dir: str | Path, size: str = "real",
                     seed: int = SEED) -> tuple[Path, Path]:
    """Write the structure-mode genome set as a Foldseek-style flat DB
    (`genomes*`) and its reference structure DB (`ref*`) under out_dir;
    returns the two DB base paths."""
    from .db.mmseqs_io import write_flatdb
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    genomes, ref = make_struct_genomes(SIZES[size], seed)
    base, ref_base = out / "genomes", out / "ref"
    seqs, heads, sss, lookup = [], [], [], []
    for gi, (tag, genes) in enumerate(zip("AB", genomes)):
        contig = f"SYN{tag}_000001.1"
        for head, (aa, _strand, ss) in zip(_headers(contig, genes), genes):
            key = len(seqs)
            seqs.append((key, _decode(aa)))
            sss.append((key, _decode(ss)))
            heads.append((key, head))
            lookup.append(f"{key}\t{head.split(' ')[0]}\t{gi}\n")
    write_flatdb(base, seqs, dbtype=0)
    write_flatdb(f"{base}_ss", sss, dbtype=0)
    write_flatdb(f"{base}_h", heads, dbtype=12)
    Path(f"{base}.lookup").write_text("".join(lookup))
    Path(f"{base}.source").write_text("0\tgenome_a.faa\n1\tgenome_b.faa\n")
    write_flatdb(ref_base, [(k, _decode(e[2])) for k, e in enumerate(ref)],
                 dbtype=0)
    write_flatdb(f"{ref_base}_ss",
                 [(k, _decode(e[3])) for k, e in enumerate(ref)], dbtype=0)
    Path(f"{ref_base}.lookup").write_text("".join(
        f"{k}\tAF-SYN{'AB'[gi]}{i:05d}-F1_0_1_{3 * len(aa)}\t0\n"
        for k, (gi, i, aa, _ss) in enumerate(ref)))
    return base, ref_base


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spacedust_tpu_torch.synth")
    ap.add_argument("out_dir")
    ap.add_argument("--size", choices=sorted(SIZES), default="real")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--struct", action="store_true",
                    help="write the structure-mode flat DB and reference "
                         "structure DB instead of the FASTA pair")
    a = ap.parse_args(argv)
    paths = (write_struct_set(a.out_dir, a.size, a.seed) if a.struct
             else write_genome_set(a.out_dir, a.size, a.seed))
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
