"""Command-line interface: the reference's `createsetdb`, `clustersearch`
and `aa2foldseek` commands (src/spacedust.cpp:26-120) with its flag
names, plus `--device` for where the SW passes run.

Run as `python -m spacedust_tpu_torch <command> ...`.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .db.setdb import SetDB


def _add_clustersearch_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("query_db")
    p.add_argument("target_db")
    p.add_argument("output")
    p.add_argument("tmp_dir", nargs="?")
    p.add_argument("--device", default="cuda",
                   help="torch device of the SW passes (default cuda; "
                        "cpu runs their plain PyTorch version)")
    p.add_argument("-s", "--sensitivity", type=float, default=5.7)
    p.add_argument("-e", "--eval-thr", type=float, default=10.0)
    p.add_argument("-c", "--cov-thr", type=float, default=0.8)
    p.add_argument("--cov-mode", type=int, default=2)
    p.add_argument("--max-seqs", type=int, default=300)
    p.add_argument("--aln-len", type=int, default=30, dest="aln_len_thr")
    p.add_argument("--gap-open", type=int, default=11)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--filter-self-match", action="store_true")
    # ALIGNMENT_PAR forwarding (data/clustersearch.sh); non-default
    # values are not ported yet and raise
    p.add_argument("--max-accept", type=int, default=2147483647)
    p.add_argument("--max-rejected", type=int, default=2147483647)
    p.add_argument("--alt-ali", type=int, default=0)
    p.add_argument("--suboptimal-hits", type=int, default=0)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--aggregation-mode", type=int, default=0)
    p.add_argument("--multihit-pval", type=float, default=0.01)
    p.add_argument("--cluster-pval", type=float, default=0.01)
    p.add_argument("--max-gene-gap", type=int, default=3)
    p.add_argument("--cluster-size", type=int, default=2)
    p.add_argument("--mask", type=int, default=1)
    p.add_argument("--comp-bias-corr", type=int, default=1)
    p.add_argument("--split-memory-limit", type=int, default=0,
                   help="not ported yet; 0 = off")
    p.add_argument("--threads", type=int, default=0,
                   help="cap OpenMP threads in the native engines "
                        "(0 = all cores, the reference default)")
    p.add_argument("-k", "--kmer-size", type=int, default=0,
                   help="seed k-mer size (0 = auto: 6, or 7 above "
                        "3.35 G residues — IndexTable.h:439-441)")
    p.add_argument("--spaced-kmer-mode", type=int, default=1,
                   help="1: spaced seed pattern (default), 0: "
                        "consecutive k-mer")
    p.add_argument("--max-seq-len", type=int, default=65535,
                   help="reject sequences longer than this "
                        "(Parameters.cpp maxSeqLen default 65535)")
    p.add_argument("--search-mode", type=int, default=0,
                   help="0: sequence, 1: foldseek-mapped structure + "
                        "sequence for the unmapped genes, 2: structure")
    p.add_argument("--foldseek-db",
                   help="aa2foldseek output dir of the query/target "
                        "(search-mode 1; default <db>_foldseek)")
    p.add_argument("--profile-cluster-search", action="store_true",
                   help="not ported yet")


def _apply_threads(n: int) -> None:
    """--threads: cap the native engines' OpenMP team (Parameters
    PARAM_THREADS; 0 keeps the all-cores default)."""
    if n and n > 0:
        from .native import set_num_threads
        set_num_threads(n)


def _check_max_seq_len(db, max_seq_len: int) -> None:
    """--max-seq-len (Parameters maxSeqLen, default 65535): hard input
    bound; longer sequences are rejected up front with their names."""
    import numpy as np
    too_long = np.nonzero(db.lengths > max_seq_len)[0]
    if len(too_long):
        names = ", ".join(db.names[int(k)] for k in too_long[:5])
        raise SystemExit(
            f"error: {len(too_long)} sequence(s) exceed --max-seq-len "
            f"{max_seq_len} (first: {names}); raise --max-seq-len")


def cmd_createsetdb(argv: list[str]) -> int:
    from .workflow.createsetdb import create_setdb
    p = argparse.ArgumentParser(prog="spacedust createsetdb")
    p.add_argument("inputs", nargs="+")
    p.add_argument("out_db")
    p.add_argument("tmp_dir", nargs="?")
    p.add_argument("--gff-dir", help="not ported yet")
    p.add_argument("--file-include", default=".*")
    p.add_argument("--file-exclude", default="^$")
    a = p.parse_args(argv)
    db = create_setdb(a.inputs, a.out_db, gff_dir=a.gff_dir,
                      file_include=a.file_include,
                      file_exclude=a.file_exclude)
    print(f"createsetdb: {db.size} genes in {db.num_sets} sets -> {a.out_db}")
    return 0


def cmd_clustersearch(argv: list[str]) -> int:
    from .workflow.clustersearch import (ClusterSearchParams,
                                         cluster_search_to_file)
    p = argparse.ArgumentParser(prog="spacedust clustersearch")
    _add_clustersearch_args(p)
    a = p.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {a.device}: CUDA is not available")
    qdb = SetDB.load(a.query_db)
    tdb = qdb if a.target_db == a.query_db else SetDB.load(a.target_db)
    params = ClusterSearchParams(
        sensitivity=a.sensitivity, max_seqs=a.max_seqs, cov_thr=a.cov_thr,
        cov_mode=a.cov_mode, eval_thr=a.eval_thr, aln_len_thr=a.aln_len_thr,
        gap_open=a.gap_open, gap_extend=a.gap_extend,
        max_accept=a.max_accept, max_rejected=a.max_rejected,
        alt_alignments=a.alt_ali,
        subopt_hits_factor=a.suboptimal_hits, alpha=a.alpha,
        aggregation_mode=a.aggregation_mode,
        filter_self_match=a.filter_self_match,
        max_gene_gaps=a.max_gene_gap, cluster_size=a.cluster_size,
        p_clu_thr=a.cluster_pval, p_mh_thr=a.multihit_pval,
        mask=bool(a.mask), comp_bias_correction=bool(a.comp_bias_corr),
        split_memory_limit=a.split_memory_limit,
        profile_cluster_search=a.profile_cluster_search,
        search_mode=a.search_mode,
        kmer_size=a.kmer_size, spaced_kmer_mode=a.spaced_kmer_mode)
    _apply_threads(a.threads)
    _check_max_seq_len(qdb, a.max_seq_len)
    if tdb is not qdb:
        _check_max_seq_len(tdb, a.max_seq_len)
    qmap = tmap = None
    if a.search_mode == 1:
        from .workflow.aa2foldseek import load_mapping
        qmap = load_mapping(a.foldseek_db
                            or (a.query_db.rstrip("/") + "_foldseek"))
        tmap = (qmap if a.target_db == a.query_db
                else load_mapping(a.target_db.rstrip("/") + "_foldseek"))
    t0 = time.time()
    res = cluster_search_to_file(qdb, tdb, a.output, a.tmp_dir, params=params,
                                 query_mapping=qmap, target_mapping=tmap,
                                 device=device)
    if res.seq_to_clu:
        # ${OUTPUT}_seq_to_clu sidecar (data/clustersearch.sh:157-164:
        # filterdb --trim-to-one-column + swapdb of the cluster DB)
        from .db.mmseqs_io import write_flatdb
        write_flatdb(a.output + "_seq_to_clu",
                     [(k, "".join(f"{c}\n" for c in clus))
                      for k, clus in sorted(res.seq_to_clu.items())],
                     dbtype=5)
    n_hits = sum(1 for ln in res.tsv.splitlines() if ln.startswith(">"))
    n_clusters = sum(1 for ln in res.tsv.splitlines() if ln.startswith("#"))
    print(f"clustersearch: {n_clusters} clusters / {n_hits} hits "
          f"in {time.time()-t0:.1f}s -> {a.output}")
    for k, v in res.timings.items():
        if isinstance(v, float):
            print(f"  {k}: {v:.2f}s")
    return 0


def cmd_aa2foldseek(argv: list[str]) -> int:
    from .workflow.aa2foldseek import aa2foldseek_cli
    return aa2foldseek_cli(argv)


COMMANDS = {
    "createsetdb": cmd_createsetdb,
    "clustersearch": cmd_clustersearch,
    "aa2foldseek": cmd_aa2foldseek,
}


def main(argv: list[str] | None = None) -> int:
    from .utils import log
    argv = sys.argv[1:] if argv is None else argv
    # global -v/--verbosity (Parameters PARAM_V; Debug levels 0..3)
    if "-v" in argv:
        i = argv.index("-v")
        log.set_verbosity(int(argv[i + 1]))
        argv = argv[:i] + argv[i + 2:]
    if not argv or argv[0] in ("-h", "--help"):
        print("spacedust_tpu_torch — gene-cluster discovery on PyTorch/CUDA\n"
              "commands: " + ", ".join(COMMANDS))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 1
    timer = log.Timer()
    rc = COMMANDS[cmd](argv[1:])
    log.info(f"Time for processing: {timer.format()}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
