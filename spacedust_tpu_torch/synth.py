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

Run as `python -m spacedust_tpu_torch.synth OUT_DIR [--size real|small]
[--seed N]`; it writes genome_a.faa and genome_b.faa.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from .constants import AA_ORDER

SEED = 20261016
SIZES = {"real": (4300, 1600), "small": (150, 150)}

# length histogram: (lo, hi, weight per mille), lo inclusive, hi exclusive
_LEN_BINS = ((30, 100, 80), (100, 150, 90), (150, 200, 110),
             (200, 250, 120), (250, 300, 120), (300, 350, 100),
             (350, 400, 90), (400, 500, 120), (500, 700, 100),
             (700, 1000, 50), (1000, 1500, 16), (1500, 2501, 4))


def _background() -> np.ndarray:
    raw = json.loads((Path(__file__).resolve().parent / "data"
                      / "blosum62.json").read_text())
    p = np.asarray(raw["background"][:20], dtype=np.float64)
    return np.cumsum(p / p.sum())


class _Gen:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.cdf = _background()

    def ints(self, lo: int, hi: int, n: int | None = None):
        """Uniform integers in [lo, hi)."""
        return self.rng.integers(lo, hi, size=n)

    def residues(self, n: int) -> np.ndarray:
        idx = np.searchsorted(self.cdf, self.rng.random(n), side="right")
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


def write_fasta(path: Path, contig: str, genes) -> None:
    """Prodigal-style headers: `>contig_i # start # end # strand # ...`."""
    lines = []
    pos = 1
    for i, (prot, strand) in enumerate(genes, start=1):
        start = pos
        end = start + 3 * (len(prot) + 1) - 1
        pos = end + 1 + (int(prot[1]) * 7 + i * 13) % 190 + 10
        lines.append(f">{contig}_{i} # {start} # {end} # {strand} # "
                     f"ID={contig}_{i};partial=00;start_type=ATG")
        seq = "".join(AA_ORDER[int(c)] for c in prot)
        lines += [seq[k:k + 60] for k in range(0, len(seq), 60)]
    path.write_text("\n".join(lines) + "\n")


def write_genome_set(out_dir: str | Path, size: str = "real",
                     seed: int = SEED) -> list[Path]:
    """Write genome_a.faa / genome_b.faa for `size` ("real" or "small");
    returns their paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for tag, genes in zip("ab", make_genomes(SIZES[size], seed)):
        p = out / f"genome_{tag}.faa"
        write_fasta(p, f"SYN{tag.upper()}_000001.1", genes)
        paths.append(p)
    return paths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spacedust_tpu_torch.synth")
    ap.add_argument("out_dir")
    ap.add_argument("--size", choices=sorted(SIZES), default="real")
    ap.add_argument("--seed", type=int, default=SEED)
    a = ap.parse_args(argv)
    for p in write_genome_set(a.out_dir, a.size, a.seed):
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
