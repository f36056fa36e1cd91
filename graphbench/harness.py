"""One run of one cell: set-up, the measured window, the drain, the
comparison with the reference, and the result's numbers.

The window drives the program's public session
(`repro_torch.core.GraphSession`) as a closed loop of clients with no
think time: each client submits a job, waits until a poll finds it
converged, detaches it (which reads its result back) and at once submits
its next job of the same family.  A poll is one `sess.run(policy,
max_supersteps=poll_supersteps)` followed by one `unconverged_counts()`.

No profiler runs in the measured window.  A traced run (`--trace 1`)
reads its host-clock numbers from that window like any other, then keeps
the loop going for a further stretch under torch.profiler, which gives
the device's numbers, and only then drains.

`run_cell` is the internal entry: it runs on any device the program
takes (a CPU test drives it on a tiny graph), and `run.py` calls it on
the card.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from graphbench import reference as ref
from graphbench.families import FAMILIES, algorithm
from graphbench.graph import Csr, graph500, search_keys
from graphbench.trace import Spans, less, profiler_events, summarize

HERE = Path(__file__).resolve().parent

#: top-level module names that may not be loaded once the window closes
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: how long past the window's close the drain waits for jobs in flight
DRAIN_S = 60.0
#: answers compared a run of each family with a source, drawn from the
#: seed (the family's longest job among them); every PageRank answer is
#: compared
SAMPLE = 16
#: the traced stretch after the window: whole polls for TRACE_S seconds
TRACE_S = 2.0


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, with its
    configuration's file and its traffic mix's file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    if mix.get("loop") != "closed" or mix.get("think_s", 0) != 0:
        raise ValueError(f"{w['traffic']}: the harness drives a closed "
                         "loop with no think time only")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(workload, int(w["chips"]), config, mix,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


class Seeds:
    """Everything a run draws from `--seed`: the scheduler's stream, one
    source stream a client, the warm-up's sources and the sample of
    answers compared.  The graph is the configuration's (its
    `graph_seed`), the same in every run, as a deployment holds one."""

    def __init__(self, seed: int, clients: int):
        ss = np.random.SeedSequence(int(seed) % 2 ** 64)
        s, c, w, k = ss.spawn(4)
        self.scheduler = int(s.generate_state(1)[0])
        self.clients = [np.random.default_rng(x) for x in c.spawn(clients)]
        self.warm = np.random.default_rng(w)
        self.sample = np.random.default_rng(k)


def client_families(mix: dict) -> List[str]:
    return [c["family"] for c in mix["clients"] for _ in range(c["count"])]


def draw_source(family: str, rng, keys: np.ndarray) -> Optional[int]:
    """A job's source vertex, uniform over `keys` (the vertices with an
    edge, as Graph500 draws its search keys); None for a family without
    one."""
    return int(keys[rng.integers(len(keys))]) if FAMILIES[family][1] \
        else None


def make_graph(cfg: dict) -> Csr:
    """The configuration's graph, drawn from its `graph_seed`."""
    if cfg.get("generator") != "graph500":
        raise ValueError(f"unknown generator {cfg.get('generator')!r}")
    return graph500(cfg, np.random.default_rng(cfg["graph_seed"]))


@dataclasses.dataclass
class Job:
    family: str
    source: Optional[int]
    handle: object
    index: int
    t_submit: float
    in_window: bool
    supersteps: int = 0
    t_done: Optional[float] = None
    result: Optional[np.ndarray] = None


def spanned_policy(name: str, spans: Spans):
    """The mix's policy (`repro_torch.core.POLICIES[name]()`), with its
    host `select` inside a "select" span."""
    from repro_torch.core import POLICIES
    base = POLICIES[name]

    def select(self, *args, **kwargs):
        with spans("select"):
            return base.select(self, *args, **kwargs)

    return type(base.__name__, (base,), {"select": select})()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def load_reader(name: str):
    """`graphbench/metrics/<name>.py`'s `read(record)`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "graphbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


class Loop:
    """The closed loop over one session."""

    def __init__(self, sess, policy, cfg, families, seeds, spans, keys):
        self.sess, self.policy, self.cfg = sess, policy, cfg
        self.families, self.seeds, self.spans, self.keys = (
            families, seeds, spans, keys)
        self.poll_n = 0
        self.active: Dict[int, Job] = {}
        self.done: List[Job] = []
        self.submitted = 0
        self.window_open = False

    def submit(self, client: int, rng, in_window: bool) -> Job:
        fam = self.families[client]
        source = draw_source(fam, rng, self.keys)
        alg = algorithm(fam, self.cfg, source)
        t = time.perf_counter()
        with self.spans("submit"):
            h = self.sess.submit(alg)
        job = Job(fam, source, h, self.sess.job_index(h), t, in_window)
        self.active[client] = job
        self.submitted += in_window
        return job

    def poll(self, submitting: bool) -> dict:
        """One run of `poll_n` supersteps, one read of the counts, and
        the converged jobs detached (and replaced, while `submitting`).
        Returns the run's counters."""
        with self.spans("run"):
            m = self.sess.run(self.policy, max_supersteps=self.poll_n)
        ips = m.iterations_per_job
        for job in self.active.values():
            job.supersteps += int(ips[job.index])
        with self.spans("poll"):
            counts = self.sess.unconverged_counts()
        t = time.perf_counter()
        for c, job in list(self.active.items()):
            if counts[job.index] == 0:
                job.t_done = t
                with self.spans("detach"):
                    job.result = self.sess.detach(job.handle)
                self.done.append(job)
                del self.active[c]
                if submitting:
                    self.submit(c, self.seeds.clients[c], self.window_open)
        return {"supersteps": int(m.supersteps),
                "tile_loads": int(m.tile_loads),
                "tile_pair_loads": int(m.tile_pair_loads)}


def _sum(polls, key):
    return sum(p[key] for p in polls)


def pick(done: List[Job], rng) -> List[Job]:
    """The answers compared: every PageRank answer, and of each family
    with a source a sample of SAMPLE drawn from `rng`, with the family's
    longest job in it."""
    out = []
    for fam in sorted({j.family for j in done}):
        jobs = [j for j in done if j.family == fam]
        if not FAMILIES[fam][1] or len(jobs) <= SAMPLE:
            out += jobs
            continue
        longest = max(range(len(jobs)), key=lambda i: jobs[i].supersteps)
        rest = [i for i in range(len(jobs)) if i != longest]
        chosen = rng.choice(len(rest), size=SAMPLE - 1, replace=False)
        out += [jobs[longest]] + [jobs[rest[i]] for i in sorted(chosen)]
    return out


#: the number compared for each view, and its limit's key in the
#: configuration
GAPS = {ref.PLUS: ("pt_gap", "pt_gap_limit"),
        ref.MIN: ("mp_gap", "mp_gap_limit"),
        ref.MIN_UNIT: ("mp_gap", "mp_gap_limit")}


def by_view(jobs: List[Job]):
    """(view, its jobs, their distinct sources) for each view of `jobs`."""
    for view in sorted({FAMILIES[j.family][0] for j in jobs}):
        mine = [j for j in jobs if FAMILIES[j.family][0] == view]
        keys = sorted({j.source for j in mine},
                      key=lambda s: -1 if s is None else s)
        yield view, mine, keys


def check(cfg: dict, csr: Csr, jobs: List[Job], unanswered: int) -> dict:
    """The numbers compared, each with its limit, and the failed count:
    each job's answer against the reference's (`reference.gap`), the
    largest gap of each number beside its limit."""
    checks, bad = {}, 0
    for view, mine, keys in by_view(jobs):
        want = dict(zip(keys, ref.solve(view, csr, cfg["damping"], keys)))
        name, limit_key = GAPS[view]
        limit = cfg[limit_key]
        gaps = [ref.gap(j.result, want[j.source]) for j in mine]
        bad += sum(not g <= limit for g in gaps)
        prev = checks.get(name, {"value": 0.0, "answers": 0})
        checks[name] = {"value": max([prev["value"]] + gaps),
                        "limit": limit,
                        "answers": prev["answers"] + len(mine)}
    checks["unanswered"] = {"value": unanswered, "limit": 0}
    return {"checks": checks, "failed": bad + unanswered}


def control_answers(cfg: dict, csr: Csr, jobs: List[Job]) -> None:
    """Puts the control's answers (the reference in bfloat16) in place of
    the program's, job by job."""
    for view, mine, keys in by_view(jobs):
        got = dict(zip(keys, ref.solve(view, csr, cfg["damping"], keys,
                                       bf16=True)))
        for j in mine:
            j.result = got[j.source]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device=None, drain_s: float = DRAIN_S, control: bool = False,
             t_start: Optional[float] = None, log=None) -> dict:
    """Run `cell` once; returns {"result": the output line's object,
    "record": what the per-layer readers read, "lines": the numbers
    compared, one a line}, and with `control` also "control": the
    verdict on the same answers with the control's put in their place.
    Exits with SystemExit if a forbidden module is loaded once the
    window has closed."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    import torch
    from repro_torch.core import GraphSession
    from repro_torch.graph.structure import CSRGraph

    cfg, mix = cell.config, cell.mix
    dev = torch.device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    families = client_families(mix)
    seeds = Seeds(seed, len(families))
    spans = Spans()

    vb = int(cfg["block_size"])
    cap = int(cfg["capacity"])
    views = [FAMILIES[f][0] for f in families]
    for view in set(views):
        if views.count(view) > cap:
            raise ValueError(f"more {view} clients than the view's "
                             f"capacity {cap}: the view would grow")
    csr = make_graph(cfg)
    sess = GraphSession(CSRGraph.from_edges(csr.n, *csr.edges()), vb,
                        capacity=cap, seed=seeds.scheduler, device=dev)
    policy = spanned_policy(mix["policy"], spans)
    loop = Loop(sess, policy, cfg, families, seeds, spans, search_keys(csr))
    loop.poll_n = int(mix["poll_supersteps"])

    def synced():
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def allocated():
        return torch.cuda.memory_allocated(dev) if cuda else 0

    # set-up: build the views (the first job of each view builds it),
    # then warm every call the window makes with one poll of a full set
    # of jobs, which are then detached
    mem0 = allocated()
    build_s = 0.0
    first = {}
    for c, view in enumerate(views):
        first.setdefault(view, c)
    for c in first.values():
        t = synced()
        loop.submit(c, seeds.warm, False)
        build_s += synced() - t
    for c in range(len(families)):
        if c not in loop.active:
            loop.submit(c, seeds.warm, False)
    loop.poll(submitting=False)
    for job in list(loop.active.values()):
        sess.detach(job.handle)
    loop.active.clear()
    loop.done.clear()
    graph_bytes = allocated() - mem0
    semirings = [g.semiring for g in sess.view_groups()]
    t0 = synced()
    setup_s = t0 - t_start
    log(f"set-up {setup_s:.3f} s (views {build_s:.3f} s, "
        f"{graph_bytes / 1e9:.3f} GB, {csr.n} vertices, {csr.nnz} edges); "
        f"window {seconds} s")

    # the window, with no profiler; the collector's passes over the jobs
    # kept so far would land in it, so it runs before and after instead
    gc.collect()
    gc.disable()
    spans.total.clear()
    spans.count.clear()
    loop.window_open = True
    for c in range(len(families)):
        loop.submit(c, seeds.clients[c], True)
    # the window ends with the last poll that starts before `seconds`
    # have passed: its length is the polls' own, and the jobs it finished
    # are the jobs those polls found converged
    t_end = t0 + seconds
    polls = []
    while time.perf_counter() < t_end:
        polls.append(loop.poll(submitting=True))
    loop.window_open = False
    t_close = time.perf_counter()
    window_spans = spans.snapshot()
    in_window = list(loop.done)

    # the traced stretch: the same loop under the profiler, past the
    # window (its jobs are not the window's)
    trace_sum, traced = None, []
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        t_pr = time.perf_counter()
        prof.start()
        at_start = spans.snapshot()
        spans.marking = True
        t_tr = time.perf_counter()
        while time.perf_counter() < t_tr + TRACE_S:
            traced.append(loop.poll(submitting=True))
        spans.marking = False
        t_stop = time.perf_counter()
        prof.stop()
        t_read = time.perf_counter()
        trace_sum = summarize(*profiler_events(prof))
        log(f"profiler: start {t_tr - t_pr:.3f} s, stretch "
            f"{t_stop - t_tr:.3f} s, stop {t_read - t_stop:.3f} s, read "
            f"{time.perf_counter() - t_read:.3f} s")
        trace_sum.update(spans=less(spans.snapshot(), at_start),
                         supersteps=_sum(traced, "supersteps"),
                         tile_loads=_sum(traced, "tile_loads"),
                         tile_pair_loads=_sum(traced, "tile_pair_loads"),
                         polls=len(traced))
        del prof

    gc.enable()
    # the drain: no new jobs; wait for those in flight
    t_drain0 = time.perf_counter()
    deadline = t_drain0 + drain_s
    while loop.active and time.perf_counter() < deadline:
        loop.poll(submitting=False)
    unanswered = sum(j.in_window for j in loop.active.values())
    t_drain = time.perf_counter()
    log(f"window: {len(in_window)} jobs done of {loop.submitted} "
        f"submitted; drain {t_drain - t_drain0:.3f} s, "
        f"{unanswered} unanswered")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit("modules loaded that the benchmark may not load: "
                         + ", ".join(bad))
    n_submitted = loop.submitted
    latencies = [(j.t_done or t_drain) - j.t_submit
                 for j in loop.done + list(loop.active.values())
                 if j.in_window]
    done = [j for j in loop.done if j.in_window]
    # the program's state is freed before the reference runs
    del sess, loop.sess, policy
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    compared = pick(done, seeds.sample)
    verdict = check(cfg, csr, compared, unanswered)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    checks = verdict["checks"]
    correct = (verdict["failed"] == 0 and len(in_window) > 0)

    supersteps = _sum(polls, "supersteps")
    record = {
        "cell": cell.name, "vb": vb, "capacity": cap,
        "num_blocks": -(-csr.n // vb), "semirings": semirings,
        "window_s": t_close - t0,
        "jobs_done": window_spans.get("detach", [0.0, 0])[1],
        "job_supersteps": [j.supersteps for j in in_window],
        "supersteps": supersteps,
        "tile_loads": _sum(polls, "tile_loads"),
        "tile_pair_loads": _sum(polls, "tile_pair_loads"),
        "spans": window_spans, "view_build_s": build_s,
        "graph_bytes": graph_bytes, "trace": trace_sum,
    }
    values = {
        "jobs_per_s": len(in_window) / (t_close - t0),
        "job_p95_s": float(np.percentile(latencies, 95)) if latencies
        else float("nan"),
        "peak_mem_gb": peak / 1e9,
        "setup_s": setup_s,
    }
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(n_submitted),
              "failed": int(verdict["failed"]), "metrics": metrics,
              "device": device_info}
    if trace_sum:
        device_info["busy_s"] = trace_sum["busy_s"]
        device_info["window_s"] = trace_sum["window_s"]
        result["breakdown"] = {"device_ops": trace_sum["device_ops"],
                               "idle_gaps": trace_sum["idle_by_span"]}
        if cuda:
            record["power_limit"] = power_limit()
            log(f"card: {record['power_limit']}")
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    lines = [f"{k}: {v['value']} (limit {v['limit']}"
             + (f", {v['answers']} answers" if "answers" in v else "") + ")"
             for k, v in checks.items()]
    sp = window_spans.get("run", [0.0, 0])[0]
    log(f"superstep {1e3 * sp / max(supersteps, 1):.4f} ms in sess.run, "
        f"{supersteps} supersteps in the window")
    log("end to end: " + ", ".join(f"{k} {v}" for k, v in values.items()))
    out = {"result": result, "record": record, "lines": lines}
    if control:
        control_answers(cfg, csr, compared)
        cv = check(cfg, csr, compared, unanswered)
        out["control"] = dict(cv, correct=cv["failed"] == 0
                              and len(in_window) > 0)
    return out
