"""Seeded synthetic genome sets: the benchmark's frozen traffic generator.

A frozen copy of the program's generator (`spacedust_tpu_torch/synth.py`
at commit f83c02cf73ead55d8be9a80aac33f588da81e612: `_Gen`,
`make_genomes`, `make_struct_genomes`, `_headers`, `write_fasta`,
`write_struct_set`), kept here so that a change to the program cannot move
the benchmark's inputs.  Three things differ from the original:

  * every constant of the shape (length histogram, giants, blocks,
    scattered homologs, paralog families, identities, the structure cap)
    is read from a traffic file's parameters, whose defaults are the
    original's, so that a traffic file that states them gives the
    original's bytes;
  * the generators also return what they planted (`Truth`): each
    cross-genome homolog pair with its identities, and each conserved
    block, which the comparison of `portbench/reference/judge.py` reads.
    Recording them draws nothing from the random stream;
  * with `shape_seed` set, every draw that shapes the set (gene lengths,
    strands, where homologs and paralogs go, block and family sizes,
    identities) comes from a stream of that seed, and only the residues,
    3Di states and the mutations' places from the run's seed: every seed
    then gives the same sizes and the same amount of work.  Unset (the
    default), one stream draws all, in the original's order.

One addition has no counterpart in the original and draws nothing unless
asked for, so that the traffic files above keep their bytes: a collection
(`make_genomes(..., n_genomes=N)`, N > 2), N genomes derived from the pair
as `tools/make_scale_db.py` derives its collection from two proteomes.

Everything is drawn from `numpy.random.default_rng` through `random()`
and `integers()` only, with integer arithmetic for every length and
position, so a seed gives byte-identical files on any machine.
"""

from __future__ import annotations

import json
import string
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

AA_ORDER = "ACDEFGHIKLMNPQRSTVWYX"
_DATA = Path(__file__).resolve().parent.parent / "reference" / "data"

# the original's constants; a traffic file overrides any of them
DEFAULTS = {
    "length_bins": [[30, 100, 80], [100, 150, 90], [150, 200, 110],
                    [200, 250, 120], [250, 300, 120], [300, 350, 100],
                    [350, 400, 90], [400, 500, 120], [500, 700, 100],
                    [700, 1000, 50], [1000, 1500, 16], [1500, 2501, 4]],
    "stream": None,
    "shape_seed": None,
    "giants_from_scale": 1000,
    "giant_a1": [5500, 6001],
    "giant_a2": [5000, 5501],
    "giant_b1_prefix": [5000, 5501],
    "giant_b1_ident": 60,
    "blocks_per_1600": 20,
    "blocks_min": 2,
    "block_genes": [3, 11],
    "inverted_every": 3,
    "singles_per_1600": 280,
    "singles_min": 4,
    "homolog_ident": [30, 96],
    "paralog_every": 150,
    "paralog_members_large": [3, 21],
    "paralog_members_small": [3, 6],
    "paralog_ident": [40, 91],
    # structure sets only
    "max_len": 2700,
    "long_len": [2500, 2701],
    "aa_ident": [25, 61],
    "ss_ident": [60, 86],
}

# a collection's derived genomes, as tools/make_scale_db.py makes them: each
# gene kept with probability KEEP_P, operon-scale blocks of BLOCK_GENES
# genes, a share MOVE_FRAC of them moved, each moved one inverted with
# probability INVERT_P, every gene mutated to IDENT % (1 - SUB_RATE)
KEEP_P = 0.9
BLOCK_GENES = (5, 21)
MOVE_FRAC = 0.25
INVERT_P = 0.4
IDENT = 88


@dataclass
class Truth:
    """What a generator planted: cross-genome homolog pairs as (genome,
    gene, genome, gene, identity %, 3Di identity % or -1), and conserved
    blocks as lists of indices into `pairs`."""
    pairs: list = field(default_factory=list)
    blocks: list = field(default_factory=list)


def params(traffic: dict | None) -> dict:
    p = dict(DEFAULTS)
    for k, v in (traffic or {}).items():
        if k not in DEFAULTS:
            raise ValueError(f"unknown traffic parameter {k!r}")
        p[k] = v
    return p


def _background(path: Path) -> np.ndarray:
    raw = json.loads(path.read_text())
    p = np.asarray(raw["background"][:20], dtype=np.float64)
    return np.cumsum(p / p.sum())


class _Gen:
    def __init__(self, seed: int, stream: int | None, bins,
                 shape_seed: int | None = None):
        self.rng = np.random.default_rng(
            seed if stream is None else [seed, stream])
        self.shape = (self.rng if shape_seed is None else
                      np.random.default_rng([shape_seed, stream or 0, 1]))
        self.cdf = _background(_DATA / "blosum62.json")
        self.ss_cdf = None
        self.bins = bins

    def ints(self, lo: int, hi: int, n: int | None = None):
        """Uniform integers in [lo, hi)."""
        return self.rng.integers(lo, hi, size=n)

    def sints(self, lo: int, hi: int):
        """A uniform integer in [lo, hi) from the shape's stream."""
        return self.shape.integers(lo, hi)

    def residues(self, n: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, self.rng.random(n), side="right")
        return np.minimum(idx, 19).astype(np.uint8)

    def states(self, n: int) -> np.ndarray:
        """3Di states from mat3di's background frequencies."""
        if self.ss_cdf is None:
            self.ss_cdf = _background(_DATA / "mat3di.json")
        idx = np.searchsorted(self.ss_cdf, self.rng.random(n), side="right")
        return np.minimum(idx, 19).astype(np.uint8)

    def length(self) -> int:
        w = np.cumsum([b[2] for b in self.bins])
        k = int(np.searchsorted(w, self.sints(0, int(w[-1])), side="right"))
        lo, hi, _ = self.bins[k]
        return int(self.sints(lo, hi))

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


class _Runs:
    """free_run of the original: starts of k consecutive genes not yet
    planted on."""

    def __init__(self, g: _Gen, genomes):
        self.g, self.genomes = g, genomes
        self.used = [set(), set()]

    def __call__(self, gi: int, k: int) -> int:
        n = len(self.genomes[gi])
        while True:
            s = int(self.g.sints(0, n - k + 1))
            if not self.used[gi] & set(range(s, s + k)):
                self.used[gi].update(range(s, s + k))
                return s


def make_genomes(sizes, seed: int, traffic: dict | None = None,
                 n_genomes: int = 2):
    """Two genomes (of `sizes` genes) as lists of [protein, strand] in
    genome order, and the Truth of what was planted; with n_genomes > 2,
    that many genomes derived from the two (`_collection`)."""
    if n_genomes < 2:
        raise ValueError(f"a set holds two genomes or more, not {n_genomes}")
    p = params(traffic)
    g = _Gen(seed, p["stream"], p["length_bins"], p["shape_seed"])
    truth = Truth()
    na, nb = sizes
    genomes = [[[g.protein(g.length()), 1 if g.sints(0, 2) else -1]
                for _ in range(n)] for n in (na, nb)]
    scale = min(na, nb)
    free_run = _Runs(g, genomes)

    # giant genes: two in genome A, one in B homologous to the first
    if scale >= p["giants_from_scale"]:
        a1, a2, b1 = free_run(0, 1), free_run(0, 1), free_run(1, 1)
        genomes[0][a1][0] = g.protein(int(g.sints(*p["giant_a1"])))
        genomes[0][a2][0] = g.protein(int(g.sints(*p["giant_a2"])))
        genomes[1][b1][0] = g.mutate(
            genomes[0][a1][0][:int(g.sints(*p["giant_b1_prefix"]))],
            p["giant_b1_ident"])
        truth.pairs.append((0, a1, 1, b1, p["giant_b1_ident"], -1))

    # conserved neighbourhood blocks, some inverted in genome B
    n_blocks = max(p["blocks_min"], p["blocks_per_1600"] * scale // 1600)
    for b in range(n_blocks):
        k = int(g.sints(*p["block_genes"]))
        sa, sb = free_run(0, k), free_run(1, k)
        inverted = b % p["inverted_every"] == p["inverted_every"] - 1
        block = []
        for i in range(k):
            prot, strand = genomes[0][sa + i]
            j = sb + (k - 1 - i if inverted else i)
            ident = int(g.sints(*p["homolog_ident"]))
            genomes[1][j] = [g.mutate(prot, ident),
                             -strand if inverted else strand]
            block.append(len(truth.pairs))
            truth.pairs.append((0, sa + i, 1, j, ident, -1))
        truth.blocks.append(block)

    # scattered cross-genome homologs
    n_single = max(p["singles_min"], p["singles_per_1600"] * scale // 1600)
    for _ in range(n_single):
        sa, sb = free_run(0, 1), free_run(1, 1)
        ident = int(g.sints(*p["homolog_ident"]))
        genomes[1][sb][0] = g.mutate(genomes[0][sa][0], ident)
        truth.pairs.append((0, sa, 1, sb, ident, -1))

    # paralog families within each genome
    for gi, n in ((0, na), (1, nb)):
        for _ in range(max(1, n // p["paralog_every"])):
            members = (int(g.sints(*p["paralog_members_large"]))
                       if n >= p["giants_from_scale"]
                       else int(g.sints(*p["paralog_members_small"])))
            founder = free_run(gi, 1)
            for _ in range(members - 1):
                j = free_run(gi, 1)
                genomes[gi][j][0] = g.mutate(
                    genomes[gi][founder][0],
                    int(g.sints(*p["paralog_ident"])))

    if n_genomes > 2:
        return _collection(g, genomes, truth, n_genomes)
    return genomes, truth


def _collection(g: _Gen, pair, truth: Truth, n: int):
    """n genomes derived from the pair, alternately from A and from B (A
    first), the pair itself not among them, as tools/make_scale_db.py
    derives its collection: each keeps a gene with probability KEEP_P,
    is cut into operon-scale blocks of BLOCK_GENES genes, has a share
    MOVE_FRAC of its blocks moved elsewhere, each of them inverted (order
    and strands) with probability INVERT_P, and every gene mutated
    (`_Gen.mutate`: substitutions and short indels, where the tool draws
    BLOSUM62-conditional substitutions and no indels) at IDENT %.  The
    shape's draws come from the shape stream, the mutations from the
    run's.

    The Truth holds every pair of genes in two derived genomes that
    descend from one gene of the pair (identity IDENT^2 / 100) or from
    the two genes of one planted pair (its identity times
    (IDENT / 100)^2), and each planted block once in every pair of
    genomes, one from A's line and one from B's, in which two or more of
    its pairs survive."""
    genomes, origin = [], []
    for d in range(n):
        src = pair[d % 2]
        kept = np.nonzero(g.shape.random(len(src)) < KEEP_P)[0]
        blocks, i = [], 0
        while i < len(kept):
            w = int(g.sints(*BLOCK_GENES))
            blocks.append(kept[i:i + w].tolist())
            i += w
        order = list(range(len(blocks)))
        n_move = int(len(blocks) * MOVE_FRAC)
        inverted = set()
        for b in np.argsort(g.shape.random(len(blocks)),
                            kind="stable")[:n_move].tolist():
            order.remove(b)
            order.insert(int(g.sints(0, len(order) + 1)), b)
            if g.shape.random() < INVERT_P:
                inverted.add(b)
        genes, where = [], {}
        for b in order:
            flip = b in inverted
            for i in (blocks[b][::-1] if flip else blocks[b]):
                prot, strand = src[i]
                where[i] = len(genes)
                genes.append([g.mutate(prot, IDENT),
                              -strand if flip else strand])
        genomes.append(genes)
        origin.append(where)

    out = Truth()
    for d1 in range(n):
        for d2 in range(d1 + 1, n):
            w1, w2 = origin[d1], origin[d2]
            if d1 % 2 == d2 % 2:
                for i in sorted(w1.keys() & w2.keys()):
                    out.pairs.append((d1, w1[i], d2, w2[i],
                                      IDENT * IDENT // 100, -1))
                continue
            wa, wb = (w1, w2) if d1 % 2 == 0 else (w2, w1)
            da, db = (d1, d2) if d1 % 2 == 0 else (d2, d1)
            index = {}
            for k, (_ga, a, _gb, b, ident, ss) in enumerate(truth.pairs):
                if a in wa and b in wb:
                    index[k] = len(out.pairs)
                    out.pairs.append((da, wa[a], db, wb[b],
                                      ident * IDENT * IDENT // 10000, ss))
            for block in truth.blocks:
                kept = [index[k] for k in block if k in index]
                if len(kept) >= 2:
                    out.blocks.append(kept)
    return genomes, out


def _struct_mutate(g: _Gen, aa: np.ndarray, ss: np.ndarray, aa_ident: int,
                   ss_ident: int, max_len: int):
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
    if len(aa) > max_len:
        aa, ss = aa[:max_len], ss[:max_len]
    return aa, ss


def make_struct_genomes(sizes, seed: int, traffic: dict | None = None):
    """Two genomes as lists of [protein, strand, 3Di states] in genome
    order, and the Truth of what was planted.  (The original's reference
    structure DB, drawn after the genomes, is not made: the benchmark's
    search mode does not read it.)"""
    p = params(traffic)
    g = _Gen(seed, p["stream"], p["length_bins"], p["shape_seed"])
    truth = Truth()
    cap = p["max_len"]

    def gene(n: int) -> list:
        return [g.protein(min(n, cap)),
                1 if g.sints(0, 2) else -1, g.states(min(n, cap))]

    na, nb = sizes
    genomes = [[gene(g.length()) for _ in range(n)] for n in (na, nb)]
    scale = min(na, nb)
    free_run = _Runs(g, genomes)

    def homolog(src: list, strand: int, pair=None) -> list:
        ai, si = int(g.sints(*p["aa_ident"])), int(g.sints(*p["ss_ident"]))
        aa, ss = _struct_mutate(g, src[0], src[2], ai, si, cap)
        if pair is not None:
            truth.pairs.append((0, pair[0], 1, pair[1], ai, si))
        return [aa, strand, ss]

    # long genes at the cap: two in genome A, one homolog of the first in B
    if scale >= p["giants_from_scale"]:
        a1, a2, b1 = free_run(0, 1), free_run(0, 1), free_run(1, 1)
        genomes[0][a1] = gene(int(g.sints(*p["long_len"])))
        genomes[0][a2] = gene(int(g.sints(*p["long_len"])))
        genomes[1][b1] = homolog(genomes[0][a1], genomes[1][b1][1],
                                 (a1, b1))
    # conserved neighbourhood blocks, some inverted in genome B
    for b in range(max(p["blocks_min"], p["blocks_per_1600"] * scale // 1600)):
        k = int(g.sints(*p["block_genes"]))
        sa, sb = free_run(0, k), free_run(1, k)
        inverted = b % p["inverted_every"] == p["inverted_every"] - 1
        block = []
        for i in range(k):
            src = genomes[0][sa + i]
            j = sb + (k - 1 - i if inverted else i)
            block.append(len(truth.pairs))
            genomes[1][j] = homolog(src, -src[1] if inverted else src[1],
                                    (sa + i, j))
        truth.blocks.append(block)
    # scattered cross-genome homologs
    for _ in range(max(p["singles_min"],
                       p["singles_per_1600"] * scale // 1600)):
        sa, sb = free_run(0, 1), free_run(1, 1)
        genomes[1][sb] = homolog(genomes[0][sa], genomes[1][sb][1], (sa, sb))
    # paralog families within each genome
    for gi, n in ((0, na), (1, nb)):
        for _ in range(max(1, n // p["paralog_every"])):
            members = (int(g.sints(*p["paralog_members_large"]))
                       if n >= p["giants_from_scale"]
                       else int(g.sints(*p["paralog_members_small"])))
            founder = free_run(gi, 1)
            for _ in range(members - 1):
                j = free_run(gi, 1)
                genomes[gi][j] = homolog(genomes[gi][founder],
                                         genomes[gi][j][1])
    return genomes, truth


def headers(contig: str, genes) -> list[str]:
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


def decode(tokens: np.ndarray) -> str:
    return "".join(AA_ORDER[int(c)] for c in tokens)


def contig(gi: int) -> str:
    """SYNA_000001.1, SYNB_000001.1, SYNC_000001.1, ... of genome gi."""
    return f"SYN{string.ascii_uppercase[gi]}_000001.1"


def fasta_name(gi: int) -> str:
    """genome_a.faa, genome_b.faa, genome_c.faa, ... of genome gi."""
    return f"genome_{string.ascii_lowercase[gi]}.faa"


def write_fasta(path: Path, contig_name: str, genes) -> None:
    """Prodigal-style headers: `>contig_i # start # end # strand # ...`."""
    lines = []
    for head, (prot, _strand, *_rest) in zip(headers(contig_name, genes),
                                             genes):
        lines.append(f">{head}")
        seq = decode(prot)
        lines += [seq[k:k + 60] for k in range(0, len(seq), 60)]
    path.write_text("\n".join(lines) + "\n")


def write_genome_set(out_dir: Path, genomes) -> list[Path]:
    """genome_a.faa, genome_b.faa, ... of a make_genomes set."""
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for gi, genes in enumerate(genomes):
        p = out_dir / fasta_name(gi)
        write_fasta(p, contig(gi), genes)
        paths.append(p)
    return paths


def write_flatdb(base: Path, entries, dbtype: int | None = None) -> None:
    """An MMseqs2 flat DB: NUL-terminated entries ending in a newline,
    an .index of `key offset length` lines, a 4-byte .dbtype."""
    with open(base, "wb") as data_fh, open(f"{base}.index", "w") as idx_fh:
        offset = 0
        for key, text in entries:
            if text and not text.endswith("\n"):
                text += "\n"
            blob = text.encode() + b"\x00"
            data_fh.write(blob)
            idx_fh.write(f"{key}\t{offset}\t{len(blob)}\n")
            offset += len(blob)
    if dbtype is not None:
        Path(f"{base}.dbtype").write_bytes(struct.pack("<i", dbtype))


def write_struct_set(out_dir: Path, genomes) -> Path:
    """The structure set as a Foldseek-style flat DB (`genomes`,
    `genomes_h` with Prodigal headers, the `genomes_ss` 3Di sidecar,
    `genomes.lookup`, `genomes.source`, the `.dbtype` files); returns the
    DB's base path."""
    out_dir.mkdir(parents=True, exist_ok=True)
    base = out_dir / "genomes"
    seqs, heads, sss, lookup = [], [], [], []
    for gi, genes in enumerate(genomes):
        for head, (aa, _strand, ss) in zip(headers(contig(gi), genes),
                                           genes):
            key = len(seqs)
            seqs.append((key, decode(aa)))
            sss.append((key, decode(ss)))
            heads.append((key, head))
            lookup.append(f"{key}\t{head.split(' ')[0]}\t{gi}\n")
    write_flatdb(base, seqs, dbtype=0)
    write_flatdb(Path(f"{base}_ss"), sss, dbtype=0)
    write_flatdb(Path(f"{base}_h"), heads, dbtype=12)
    Path(f"{base}.lookup").write_text("".join(lookup))
    Path(f"{base}.source").write_text("".join(
        f"{gi}\t{fasta_name(gi)}\n" for gi in range(len(genomes))))
    return base
