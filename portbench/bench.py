"""The port's benchmark: one cell, one run.

A step is one user job, FASTA (or a flat DB) to cluster TSV, through the
port's CLI entry in this process (`spacedust_tpu_torch.cli.main`, what
`python -m spacedust_tpu_torch` runs):

  1. `createsetdb` of the cell's inputs into a fresh DB directory;
  2. `clustersearch DB DB out.tsv TMP --filter-self-match <flags>` with a
     fresh tmp dir;
  3. the job's directory is deleted before the next job starts.

So every job builds its own k-mer index and resumes from no checkpoint.
The window runs whole jobs back to back and starts none once `seconds`
have passed; `job_s` is the window's time over its jobs.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name
`BENCHMARK.json` gives it: `configs/<config>.json`, `traffic/<traffic>.json`,
`workloads/<cell>.json`, `metrics/<metric>.py`.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as trace_mod
from .gen import synth
from .reference.judge import Inputs, JobOutputs, judge, verdict

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"          # the program's seed tables
FORBIDDEN = ("jax", "jaxlib", "flax", "spacedust_tpu")


@dataclass
class Cell:
    """A cell of BENCHMARK.json with the files its names point to."""
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict
    end_to_end: list
    per_layer: list

    @property
    def kind(self) -> str:
        return self.config["search"]


def load_cell(root: Path, name: str, here: Path = HERE) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, chips=entry["chips"],
        config=json.loads((here / "configs"
                           / f"{entry['config']}.json").read_text()),
        traffic=json.loads((here / "traffic"
                            / f"{entry['traffic']}.json").read_text()),
        spec=json.loads((here / "workloads" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def load_metric(name: str, here: Path = HERE):
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole top-level name: spacedust_tpu_torch is not spacedust_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------ inputs
def make_inputs(cell: Cell, genes, seed: int, out_dir: Path):
    """(input paths for createsetdb, judge Inputs) of a set of `genes`
    (gene counts of genome A and B) drawn from the cell's traffic; where
    the configuration states `genomes` N above 2, the N genomes that the
    generator derives from that pair."""
    cfg = cell.config
    n = cfg.get("genomes", 2)
    if cell.kind == "seq":
        genomes, truth = synth.make_genomes(genes, seed, cell.traffic, n)
        paths = synth.write_genome_set(out_dir, genomes)
    elif n != 2:
        raise ValueError(f"{cfg['name']}: a structure set holds two "
                         f"genomes, not {n}")
    else:
        genomes, truth = synth.make_struct_genomes(genes, seed, cell.traffic)
        paths = [synth.write_struct_set(out_dir, genomes)]
    return paths, Inputs(genomes, truth, cell.kind, cfg["gap_open"],
                         cfg["gap_extend"])


# -------------------------------------------------------------------- jobs
def _span(name: str, on: bool):
    return (torch.profiler.record_function(f"portbench.{name}") if on
            else contextlib.nullcontext())


def _call(main, argv: list[str]) -> str:
    """cli.main(argv) with its output captured; raises on a non-zero
    return code."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv[0]} returned {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue()


def parse_detail(stdout: str) -> dict:
    for line in stdout.splitlines():
        if line.strip().startswith("detail: "):
            return json.loads(line.split("detail: ", 1)[1])
    return {}


def run_job(main, job_dir: Path, paths: list, cell: Cell, device: str,
            traced: bool = False) -> dict:
    """One user job in the fresh directory job_dir; returns its spans and
    the CLI's `detail` timings."""
    job_dir.mkdir(parents=True)         # fails if it is not fresh
    if cell.kind == "struct":
        with _span("copy_input", traced):
            src = Path(paths[0])
            (job_dir / "in").mkdir()
            for f in src.parent.iterdir():
                shutil.copyfile(f, job_dir / "in" / f.name)
            paths = [str(job_dir / "in" / src.name)]
    db, tmp, out = job_dir / "db", job_dir / "tmp", job_dir / "out.tsv"
    t0 = time.perf_counter()
    with _span("createsetdb", traced):
        _call(main, ["createsetdb", *map(str, paths), str(db)])
    t1 = time.perf_counter()
    with _span("clustersearch", traced):
        stdout = _call(main, ["clustersearch", str(db), str(db), str(out),
                              str(tmp), *cell.config["flags"],
                              *cell.spec["job"], "--device", device])
    t2 = time.perf_counter()
    return {"dir": job_dir, "ingest_s": t1 - t0, "search_s": t2 - t1,
            "detail": parse_detail(stdout)}


def digest_files(job_dir: Path) -> str:
    """sha256 of a job's TSV and search result DB, as bytes on disk."""
    h = hashlib.sha256()
    for p in [job_dir / "out.tsv", *sorted((job_dir / "tmp").glob("*/result")),
              *sorted((job_dir / "tmp").glob("*/result.index"))]:
        h.update(p.read_bytes() if p.exists() else b"-")
    return h.hexdigest()


# ------------------------------------------------------------- host memory
class HostPeak:
    """Peak resident memory of this process over a window: the largest
    VmRSS that a sampler thread reads every 20 ms, and at the window's
    start and end.  A peak that lasts less than 20 ms can be missed."""

    def __init__(self):
        self._stop = threading.Event()
        self._peak = 0
        self._thread = None

    @staticmethod
    def _rss() -> int:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
        raise KeyError("VmRSS")

    def start(self) -> None:
        self._peak = self._rss()

        def sample():
            while not self._stop.wait(0.02):
                self._peak = max(self._peak, self._rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=5)
        return max(self._peak, self._rss())


def process_age_s() -> float | None:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


# ------------------------------------------------------------------- a run
@dataclass
class Run:
    jobs: list = field(default_factory=list)
    digests: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    host_peak: int = 0
    device_peak: int = 0
    trace: dict | None = None
    error: str = ""
    judge_s: float = 0.0
    sw_checked: int = 0
    tb_checked: int = 0


def _device_info(device: str, chips: int) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_import: float | None = None) -> dict:
    """Set-up, the window, the comparison; returns the result line's
    object."""
    started = time.perf_counter() if t_import is None else t_import
    CACHE.mkdir(exist_ok=True)
    os.environ["SPACEDUST_CACHE_DIR"] = str(CACHE)
    from spacedust_tpu_torch import cli, native
    native.get_lib()
    if device == "cuda":
        from spacedust_tpu_torch.ops import sw_cuda
        sw_cuda.load(torch.device("cuda", 0))
    scratch = Path(tempfile.mkdtemp(prefix=f"portbench-{cell.name}-"))
    try:
        return _run(cell, seed, seconds, traced, device, cli.main, scratch,
                    started)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, main, scratch: Path,
         started: float) -> dict:
    run = Run()
    paths, inputs = make_inputs(cell, cell.config["genes"], seed,
                                scratch / "inputs")
    warm_paths, _ = make_inputs(cell, cell.spec["warmup_genes"], seed,
                                scratch / "warmup_inputs")
    run_job(main, scratch / "warmup", warm_paths, cell, device)
    shutil.rmtree(scratch / "warmup")
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    age = process_age_s()
    run.setup_s = age if age is not None else time.perf_counter() - started

    peak = HostPeak()
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    peak.start()
    prev = None
    t0 = time.perf_counter()
    with _span("window", traced):
        while time.perf_counter() - t0 < seconds:
            with _span("between_jobs", traced):
                if prev is not None:
                    shutil.rmtree(prev)
            job_dir = scratch / f"job{run.attempted}"
            run.attempted += 1
            try:
                with _span("job", traced):
                    job = run_job(main, job_dir, paths, cell, device, traced)
            except Exception:            # a failed job ends the window
                run.failed += 1
                run.error = traceback.format_exc()[-4000:]
                break
            run.jobs.append(job)
            run.digests.append(digest_files(job_dir))
            prev = job_dir
        if device == "cuda":
            torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    run.host_peak = peak.stop()
    if prof is not None:
        prof.__exit__(None, None, None)
        path = scratch / "trace.json"
        prof.export_chrome_trace(str(path))
        run.trace = trace_mod.summarize(path)
        path.unlink()
        del prof
    if device == "cuda":
        run.device_peak = max(torch.cuda.max_memory_allocated(i)
                              for i in range(cell.chips))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"error: loaded after the window: {found}")

    # the comparison, on the last job's outputs
    if run.jobs:
        last = run.jobs[-1]["dir"]
        outputs = JobOutputs.read(last / "out.tsv", last / "tmp")
    else:
        outputs = JobOutputs(None, None)
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    nums = judge(outputs, run.digests, inputs, cell.spec["judge"], seed,
                 device)
    run.judge_s = time.perf_counter() - t_judge
    run.sw_checked = nums["sw_checked"]
    run.tb_checked = nums["tb_checked"]
    correct, checks = verdict(nums, cell.spec["limits"])
    correct = correct and run.failed == 0 and bool(run.jobs)
    return result(cell, run, correct, checks, traced, device)


def result(cell: Cell, run: Run, correct: bool, checks: dict, traced: bool,
           device: str) -> dict:
    n = max(len(run.jobs), 1)
    # the end-to-end metrics this file takes itself; any other, as every
    # per-layer metric, is read by metrics/<name>.py
    taken = {"job_s": run.window_s / n,
             "host_peak_gib": run.host_peak / 2**30,
             "setup_s": run.setup_s}
    ctx = MetricContext(cell, run, device)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = (taken[m["name"]] if m["name"] in taken
             else load_metric(m["name"]).read(ctx))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = _device_info(device, cell.chips)
    dev["memory_peak_bytes"] = run.device_peak
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["jobs"] = len(run.jobs)
    out["window_s"] = run.window_s
    out["job_times"] = [[round(j["ingest_s"], 4), round(j["search_s"], 4)]
                        + [round(j["detail"].get(k, 0.0), 4) for k in
                           ("index", "prefilter", "align", "aggregate",
                            "structure_search")]
                        for j in run.jobs]
    out["judge_s"] = run.judge_s
    out["sw_checked"] = run.sw_checked
    out["tb_checked"] = run.tb_checked
    if run.error:
        out["error"] = run.error
    out["checks"] = checks
    return out


class MetricContext:
    """What a per-layer metric's reader reads: the window's jobs (their
    spans and the CLI's `detail`), the trace summary, the device."""

    def __init__(self, cell: Cell, run: Run, device: str):
        self.cell, self.run, self.device = cell, run, device
        self.jobs = run.jobs
        self.trace = run.trace
        self.kind = cell.kind

    def mean(self, get) -> float | None:
        """Mean of get(job) over the window's jobs; None where any job
        lacks it (get raises KeyError or returns None)."""
        vals = []
        for job in self.jobs:
            try:
                v = get(job)
            except KeyError:
                return None
            if v is None:
                return None
            vals.append(float(v))
        return sum(vals) / len(vals) if vals else None

    def sm_count(self) -> int | None:
        if self.device != "cuda":
            return None
        return torch.cuda.get_device_properties(0).multi_processor_count


def stderr_lines(out: dict) -> list[str]:
    return [f"{k}: {v['value']} (limit {v['limit']})"
            for k, v in out["checks"].items()]
