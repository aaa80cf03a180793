"""The nucleotide contig search of the port (ROADMAP A11b: `search
--search-type 3`, search/nucl.py, native/nucl_align.cpp) against the JAX
package on the same inputs: the banded nucleotide aligner on seeded pairs
with indels, the encoding and window helpers, the whole search on
synthetic contigs with a planted reverse-strand segment, and the CLI
against the recorded fixture.  Equal, not close; inputs made from seeds
(`synth.py --nucl`)."""

from pathlib import Path

import numpy as np
import pytest

from spacedust_tpu import native as jax_native
from spacedust_tpu.search import nucl as jax_nucl
from spacedust_tpu_torch import cli, synth
from spacedust_tpu_torch.native import nucl_banded_align
from spacedust_tpu_torch.search import nucl

FIXTURES = Path(__file__).parent / "fixtures"


def mutate(rng, a: np.ndarray, pct: int) -> np.ndarray:
    """Substitutions at pct % of positions and a few indels."""
    b = a.copy()
    hit = rng.integers(0, 100, len(b)) < pct
    b[hit] = rng.integers(0, 4, int(hit.sum()))
    for _ in range(int(rng.integers(0, 6))):
        p, k = int(rng.integers(1, len(b) - 4)), int(rng.integers(1, 4))
        b = (np.concatenate([b[:p], rng.integers(0, 4, k), b[p:]])
             if rng.integers(0, 2) else np.concatenate([b[:p], b[p + k:]]))
    return b.astype(np.uint8)


@pytest.mark.parametrize("seed", range(6))
def test_banded_align_matches_jax(seed):
    """Homologous pairs with indels at several diagonals, X bases, band
    and zdrop settings, and an unrelated pair."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        a = rng.integers(0, 4, int(rng.integers(30, 900))).astype(np.uint8)
        b = mutate(rng, a, int(rng.integers(0, 25)))
        shift = int(rng.integers(0, 40))
        b = np.concatenate([rng.integers(0, 5, shift).astype(np.uint8), b])
        for q, t, diag in ((a, b, shift), (b, a, -shift),
                           (a, rng.integers(0, 4, 300).astype(np.uint8), 0)):
            for kw in ({}, {"band": 8, "zdrop": 10}):
                got = nucl_banded_align(q, t, diag, nucl.NUCL_MAT, **kw)
                want = jax_native.nucl_banded_align(q, t, diag,
                                                    jax_nucl.NUCL_MAT, **kw)
                assert got == want


def test_helpers_match_jax():
    rng = np.random.default_rng(1)
    s = "".join("ACGTNacgtU"[i] for i in rng.integers(0, 10, 25_000))
    assert np.array_equal(nucl.encode_nucl(s), jax_nucl.encode_nucl(s))
    codes = nucl.encode_nucl(s)
    assert np.array_equal(nucl.revcomp_codes(codes),
                          jax_nucl.revcomp_codes(codes))
    contigs = {0: s, 1: s[:7000]}
    for ours, theirs in ((nucl.split_windows, jax_nucl.split_windows),
                         (nucl.split_windows_both_strands,
                          jax_nucl.split_windows_both_strands)):
        got, want = ours(contigs), theirs(contigs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.key, g.contig_key, g.start, g.strand, g.from_pos) == (
                w.key, w.contig_key, w.start, w.strand, w.from_pos)
            assert np.array_equal(g.codes, w.codes)


@pytest.mark.parametrize("size", sorted(synth.NUCL_SIZES))
def test_nucl_search_matches_jax(size):
    """The synthetic contigs: every alignment line equal, the planted
    reverse-complemented segment found with descending query
    coordinates."""
    q, t = synth.make_nucl_contigs(size)
    qd = {k: s for k, (_n, s) in enumerate(q)}
    td = {k: s for k, (_n, s) in enumerate(t)}
    got = nucl.nucl_search(qd, td)
    assert got == jax_nucl.nucl_search(qd, td)
    rows = [c for lines in got.values() for c in lines]
    assert any(int(c[4]) > int(c[5]) for c in rows)
    assert any(int(c[4]) < int(c[5]) for c in rows)
    # a query against itself: every 10 kb window of a contig finds itself
    self_hits = nucl.nucl_search(qd, qd, max_seqs=5)
    assert self_hits == jax_nucl.nucl_search(qd, qd, max_seqs=5)
    for k, s in qd.items():
        found = [[c[0], c[4], c[5]] for c in self_hits[k]]
        for w in range(0, len(s), 10_000):
            assert [str(k), str(w), str(min(w + 9_999, len(s) - 1))] in found


def test_cli_search_type_3_equals_fixture(tmp_path):
    qpath, tpath = synth.write_nucl_set(tmp_path, "small")
    out = tmp_path / "nucl.tsv"
    assert cli.main(["search", str(qpath), str(tpath), str(out),
                     "--search-type", "3"]) == 0
    assert out.read_bytes() == (FIXTURES / "torch_port_small_nucl.tsv"
                                ).read_bytes()
