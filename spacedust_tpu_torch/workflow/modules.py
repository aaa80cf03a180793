"""The module toolkit as a script: the commands that run a search and the
clustersearch workflow one module at a time, as data/clustersearch.sh
does (search -> besthitbyset -> mergeresultsbyset -> combinehits ->
clusterhits -> summarizeresults), for a setDB searched against itself.

`toolkit_commands` only lists argument vectors; a caller hands each to a
CLI's `main` (`search` additionally takes `--device` in this package).
"""

from __future__ import annotations

from pathlib import Path

# what clustersearch passes to its search stage (its workflow defaults,
# src/workflow/clustersearch.cpp:9-37)
CLUSTERSEARCH_SEARCH_FLAGS = ("-e", "10", "-c", "0.8", "--cov-mode", "2",
                              "--aln-len", "30")
CONTROL_FLAGS = ("--alt-ali", "2", "--max-accept", "3", "--max-rejected",
                 "2")

# the files the commands write, in order
OUTPUTS = ("search_controls.tsv", "search_alt.tsv", "search_alt.m8",
           "chain_search.tsv", "chain_besthit.tsv", "chain_merged.tsv",
           "chain_matches.tsv", "chain_clusters.tsv", "chain_result.tsv")


def toolkit_commands(db: str, out_dir: str | Path
                     ) -> list[tuple[str, list[str]]]:
    """[(output file name, argv)]: `search` with the alignment controls,
    `search --alt-ali 2` and `convertalignments` of its result, then the
    workflow chain; chain_result.tsv is what `clustersearch
    --filter-self-match` writes for the same setDB."""
    out = Path(out_dir)
    f = {name: str(out / name) for name in OUTPUTS}
    argvs = [
        ["search", db, db, f["search_controls.tsv"], *CONTROL_FLAGS],
        ["search", db, db, f["search_alt.tsv"], "--alt-ali", "2"],
        ["convertalignments", db, db, f["search_alt.tsv"],
         f["search_alt.m8"]],
        ["search", db, db, f["chain_search.tsv"],
         *CLUSTERSEARCH_SEARCH_FLAGS],
        ["besthitbyset", db, db, f["chain_search.tsv"],
         f["chain_besthit.tsv"]],
        ["mergeresultsbyset", db, f["chain_besthit.tsv"],
         f["chain_merged.tsv"]],
        ["combinehits", db, db, f["chain_merged.tsv"],
         f["chain_matches.tsv"], "--filter-self-match"],
        ["clusterhits", db, db, f["chain_matches.tsv"],
         f["chain_clusters.tsv"]],
        ["summarizeresults", db, db, f["chain_clusters.tsv"],
         f["chain_result.tsv"]],
    ]
    return list(zip(OUTPUTS, argvs))
