"""Multi-process clustersearch: the port of the JAX package's
`parallel/multihost.py`, the analog of the reference's MPI mode.

The reference distributes the search stage by giving every MPI rank one
split and exchanging data through the shared filesystem; only rank
scheduling, a barrier and the master's merge go through MPI
(lib/mmseqs/src/prefiltering/Prefiltering.cpp:575-660,
lib/mmseqs/src/commons/MMseqsMPI.h:26-34).  Here:

  * across processes: query-slice data parallelism.  Each process owns a
    residue-balanced slice of the queries (parallel/split.py) and runs the
    whole search stage for it; a query's results are complete in its
    process, so the merge is a concatenation (the reference's query-split
    mode, Prefiltering.cpp:273-377);
  * within a process: the target-sharded engine over `local_devices`
    shards (parallel/pipeline.py) when that is more than 1, else the
    single engine, on `--device` (default cuda; the processes of a
    one-card host share the card);
  * rendezvous: each process writes its records as a reference-format
    flat DB into the shared tmp dir (db/mmseqs_io.py), with its search
    seconds, kernel launches and SW engine metrics beside them
    (`metrics.RANK.json`); rank 0 merges the records
    and runs the aggregation tail (besthit -> combinehits -> clusterhits
    -> summarize), as MMseqsMPI's master does;
  * process identity and the barrier: SPACEDUST_COORDINATOR (host:port),
    SPACEDUST_NUM_PROCS and SPACEDUST_PROC_ID.  With a coordinator set, a
    `torch.distributed` gloo group is formed there (no device tensor
    crosses processes, so gloo serves the cards too) and the barrier is
    `dist.barrier()`; a group that does not form raises.  Without one,
    the barrier is a sentinel file a rank in the shared tmp dir.

`run_multihost` is the launcher on one host (the mpirun stand-in): it
builds the native engines and the kernels once, then spawns N worker
processes over one artifact dir and waits.  On several hosts, a cluster
runner starts `python -m spacedust_tpu_torch.parallel.multihost DB TMP OUT
PARAMS_JSON [--device D] [--local-devices N]` once a process with the
SPACEDUST_* variables set.
"""

from __future__ import annotations

import argparse
import ast
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict
from pathlib import Path

# a gloo group that does not form fails in this many seconds, not minutes
INIT_TIMEOUT_S = 60


def _init_distributed() -> tuple[int, int, bool]:
    """(proc_id, n_procs, grouped): a gloo process group at
    SPACEDUST_COORDINATOR when one is set and there is more than one
    process (a failure to form it raises); otherwise the identity from the
    environment alone."""
    coord = os.environ.get("SPACEDUST_COORDINATOR")
    n_procs = int(os.environ.get("SPACEDUST_NUM_PROCS", "1"))
    proc_id = int(os.environ.get("SPACEDUST_PROC_ID", "0"))
    if not coord or n_procs <= 1:
        return proc_id, n_procs, False
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=n_procs,
        rank=proc_id, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    # marker for tests: the group formed and holds every rank
    sentinel = os.environ.get("SPACEDUST_DISTRIBUTED_SENTINEL")
    if sentinel:
        Path(sentinel).with_suffix(f".rank{proc_id}").write_text(
            f"{dist.get_rank()}/{dist.get_world_size()}")
    return proc_id, n_procs, True


def _barrier(tmp: Path, proc_id: int, n_procs: int, stage: str,
             timeout_s: float = 3600.0) -> None:
    """Filesystem sentinel barrier (the data already flows through the
    shared filesystem)."""
    (tmp / f"{stage}.rank{proc_id}.done").write_text("")
    t0 = time.time()
    while True:
        if all((tmp / f"{stage}.rank{r}.done").exists()
               for r in range(n_procs)):
            return
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"barrier {stage}: peers missing")
        time.sleep(0.05)


def worker(db_path: str, tmp_dir: str, out_path: str, params_json: str,
           n_shards: int | None = None, device: str = "cuda") -> None:
    """One rank of the multi-process clustersearch: the search stage of
    its query slice on `device` (n_shards > 1: target-sharded over that
    many shards), then, on rank 0, the merge and the tail."""
    proc_id, n_procs, grouped = _init_distributed()
    try:
        _work(db_path, Path(tmp_dir), out_path, params_json, n_shards,
              device, proc_id, n_procs, grouped)
    finally:
        if grouped:
            import torch.distributed as dist
            dist.destroy_process_group()


def _work(db_path: str, tmp: Path, out_path: str, params_json: str,
          n_shards: int | None, device: str, proc_id: int, n_procs: int,
          grouped: bool) -> None:
    import torch
    from ..db.mmseqs_io import write_flatdb
    from ..db.setdb import SetDB
    from ..workflow.clustersearch import (ClusterSearchParams,
                                          _sequence_aln_params)
    from .split import residue_balanced_splits

    t0 = time.time()
    tmp.mkdir(parents=True, exist_ok=True)
    par = ClusterSearchParams(**json.loads(params_json))
    db = SetDB.load(db_path)
    s, e = residue_balanced_splits(db.lengths, n_procs)[proc_id]
    qslice = list(range(s, e))
    apar = _sequence_aln_params(par)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    n_local = n_shards or 1
    if n_local > 1:
        # target shards within this process; a rank's shards start on
        # its own card where there are several
        from .pipeline import ShardedAlignmentEngine, sharded_prefilter
        from .sw_sharded import make_mesh
        devices = make_mesh(n_local, dev, first=proc_id * n_local)
        shards = residue_balanced_splits(db.lengths, n_local)
        hits = sharded_prefilter(
            db, db, shards, sensitivity=par.sensitivity,
            max_seqs=par.max_seqs,
            comp_bias_correction=par.comp_bias_correction, mask=par.mask,
            cov_thr=par.cov_thr, cov_mode=par.cov_mode, same_qt_db=True,
            qrange=(s, e))
        cands = {qk: [h.seq_id for h in hits[qk]] for qk in qslice}
        eng = ShardedAlignmentEngine(db, db, apar,
                                     devices[:len(shards)], shards,
                                     same_qt_db=True)
    else:
        from ..search.alignment import AlignmentEngine
        from ..search.prefilter import PrefilterEngine
        from .sw_sharded import make_mesh
        pref = PrefilterEngine(db, db, sensitivity=par.sensitivity,
                               max_seqs=par.max_seqs, same_qt_db=True,
                               comp_bias_correction=par.comp_bias_correction,
                               mask=par.mask, cov_thr=par.cov_thr,
                               cov_mode=par.cov_mode)
        cands = {qk: [h.seq_id for h in hs]
                 for qk, hs in pref.match_all(qslice).items()}
        eng = AlignmentEngine(db, db, apar, same_qt_db=True,
                              device=make_mesh(1, dev, first=proc_id)[0])
    records = eng.align_all(cands)
    # what this rank ran: its kernels' launches and the SW engine's metrics
    from ..ops import sw_cuda
    (tmp / f"metrics.{proc_id}.json").write_text(json.dumps({
        "search_s": time.time() - t0,
        "launches": {c: getattr(sw_cuda, c)
                     for _name, c in sw_cuda.ENTRY.values()},
        "align_detail": eng._device_db().metrics}))

    # shared-filesystem rendezvous: a reference-format result DB a rank
    write_flatdb(tmp / f"result.{proc_id}",
                 [(qk, "".join(r.line() + "\n"
                               for r in records.get(qk, [])))
                  for qk in qslice])
    if grouped:
        import torch.distributed as dist
        dist.barrier()
    else:
        _barrier(tmp, proc_id, n_procs, "search")
    if proc_id != 0:
        return

    # rank 0: the merge and the aggregation tail (MMseqsMPI's master)
    from ..cluster.summarize import seq_to_clu
    from ..db.mmseqs_io import FlatDB
    from ..search.records import AlnRecord, expand_cigar
    from ..workflow.clustersearch import aggregate_results

    def _cols(qk: int, ln: str) -> list[str]:
        rec = AlnRecord.parse(ln)
        rec.backtrace = expand_cigar(rec.backtrace)
        return [str(qk)] + rec.columns()

    results: dict[int, list[list[str]]] = {}
    for r in range(n_procs):
        fdb = FlatDB.open(tmp / f"result.{r}")
        for qk in fdb.keys():
            results[qk] = [_cols(qk, ln) for ln in fdb.lines(qk)]
    _matches, clusters, tsv = aggregate_results(results, db, db, par)
    Path(out_path).write_text(tsv)
    Path(seq_to_clu_path(out_path)).write_text(
        "".join(f"{k}\t{v}\n" for k, v in seq_to_clu(clusters).items()))


def seq_to_clu_path(out_path: str) -> str:
    """Rank 0's sidecar: `key \\t [cluster ids]` a line."""
    return str(out_path) + ".seq_to_clu.tsv"


def read_seq_to_clu(out_path: str) -> dict[int, list[int]]:
    out = {}
    for ln in Path(seq_to_clu_path(out_path)).read_text().splitlines():
        k, v = ln.split("\t", 1)
        out[int(k)] = ast.literal_eval(v)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multihost(db_path: str, out_path: str, n_procs: int, params,
                  tmp_dir: str | None = None, local_devices: int = 1,
                  coordinator_port: int = 0, device: str = "cuda") -> str:
    """Spawn n_procs worker processes on this host (the mpirun stand-in)
    over one artifact dir and wait for rank 0's merged TSV; each worker
    runs `local_devices` target shards on `device`.  The native engines
    and (for a CUDA device) the kernels are built here first, so that no
    two workers build them at once.  Returns the output path."""
    from .. import native
    import torch
    native.build()
    if torch.device(device).type == "cuda":
        from ..ops import sw_cuda
        sw_cuda.build()
    tmp_dir = tmp_dir or tempfile.mkdtemp(prefix="spacedust_mh")
    Path(tmp_dir).mkdir(parents=True, exist_ok=True)
    # chosen by binding port 0 and releasing it; a race to it makes the
    # group fail within INIT_TIMEOUT_S
    port = coordinator_port or _free_port()
    pj = json.dumps(asdict(params))
    root = str(Path(__file__).resolve().parents[2])
    procs = []
    for r in range(n_procs):
        env = dict(os.environ)
        env.update(SPACEDUST_NUM_PROCS=str(n_procs),
                   SPACEDUST_PROC_ID=str(r),
                   SPACEDUST_COORDINATOR=f"127.0.0.1:{port}")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "spacedust_tpu_torch.parallel.multihost",
             db_path, tmp_dir, out_path, pj, "--device", str(device),
             "--local-devices", str(local_devices)], env=env))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"multihost workers failed: rcs={rcs}")
    return out_path


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m spacedust_tpu_torch.parallel.multihost")
    ap.add_argument("db_path")
    ap.add_argument("tmp_dir")
    ap.add_argument("out_path")
    ap.add_argument("params_json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--local-devices", type=int, default=1)
    a = ap.parse_args(argv)
    worker(a.db_path, a.tmp_dir, a.out_path, a.params_json,
           n_shards=a.local_devices, device=a.device)


if __name__ == "__main__":
    main()
