"""The benchmark of ``xmtpu_torch``: certified solves on one H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration (a fixed
set of K problem instances and the solver's arguments) and a traffic mix
(how the solutions are served).  Set-up makes the scenes, builds the
kernels and one operator per scene, and warms up with one solution; the
seed draws the order of service, the probe of the operator and the
certificate's start vectors.  The
window then serves solutions back to back, one user in a closed loop, the
scenes in turn in an order drawn from the seed, and closes at the end of
the cycle in flight once ``--seconds`` have passed, so that every run
serves whole cycles.  With ``--trace 1`` the window's first whole cycles
past ``pb_trace.TRACE_SECONDS`` run under the profiler.  Every solution is judged against the plain
reference (``pb_reference``, ``pb_judge``) after the window.  The last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, each read by ``metrics/<name>.py``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
beside its limit.  Without a card the run exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
# the benchmark's modules, then the checkout's root, which holds the program
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pb_spec  # noqa: E402

# top-level module names a run may not load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "xmtpu")


class RunRecord:
    """What the metric readers read: the window's solutions and length,
    set-up, the memory peak, and in a traced run the trace and the launch
    counts."""

    def __init__(self, **kw):
        self.trace = None
        self.launches = None
        self.traced = []          # the solutions inside the trace
        self.__dict__.update(kw)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def make_scenes(config: dict) -> list:
    """The configuration's K scenes: a fixed set of problems, one for each
    generator seed in ``scene_seeds``.  (Drawn from the run's seed, the
    problems' work changed from run to run by up to tenfold.)"""
    import pb_scenes

    gen = pb_scenes.GENERATORS[config["generator"]]
    return [gen(**config["scene"], seed=s) for s in config["scene_seeds"]]


class Memory:
    """One problem's device memory, though set-up keeps every scene's
    operator resident: the peak while one operator is built or one
    solution runs, less what the other scenes' operators hold.  ``peak()``
    is the process's own peak, every scene's operator in it."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.device, self.torch = device, torch
        self.own = {}              # id(operator) -> the bytes it holds
        self.problem_peak = 0
        self._raw = 0

    def _start(self) -> int:
        if not self.cuda:
            return 0
        self.torch.cuda.synchronize(self.device)
        self._raw = max(self._raw,
                        self.torch.cuda.max_memory_allocated(self.device))
        self.torch.cuda.reset_peak_memory_stats(self.device)
        return self.torch.cuda.memory_allocated(self.device)

    def _end(self) -> int:
        self.torch.cuda.synchronize(self.device)
        peak = self.torch.cuda.max_memory_allocated(self.device)
        self._raw = max(self._raw, peak)
        return peak

    def build(self, fn, *args):
        base = self._start()
        op = fn(*args)
        if self.cuda:
            peak = self._end()
            self.own[id(op)] = self.torch.cuda.memory_allocated(
                self.device) - base
            self.problem_peak = max(self.problem_peak, peak - base)
        return op

    def solve(self, k, op, config, device):
        import pb_program

        base = self._start()
        sol = pb_program.solve_one(k, op, config, device)
        if self.cuda:
            others = base - self.own[id(op)]
            self.problem_peak = max(self.problem_peak, self._end() - others)
        return sol

    def peak(self) -> int:
        if self.cuda:
            self._end()
        return self._raw


def judge(scenes, ops, sols, config, seed, device, control_dtype=None,
          log=print) -> "tuple[dict, int, dict]":
    """``(worst, failed, control)``: each number's worst reading over the
    solutions ``sols`` of ``scenes`` (built into ``ops``) against the
    float64 reference, the solutions that raised or did not certify, and,
    with ``control_dtype``, the worst readings of the control: the
    reference computed in that precision put in the program's place at the
    program's factors.  Frees the operators before the reference runs."""
    import torch

    import pb_judge
    import pb_program
    import pb_reference

    cuda = device.type == "cuda"
    failed = 0
    outputs = {k: [] for k in range(len(scenes))}
    for s in sols:
        if s.error:
            log(f"[portbench] scene {s.scene} raised:\n{s.error}")
        if s.result is None or not s.result.certified:
            failed += 1
            continue
        r = s.result
        outputs[s.scene].append(pb_judge.Output(
            s.scene, r.R, r.s_ex, float(r.primal), bool(r.certified),
            *s.recovered))
    probes = [pb_judge.probe_block(3 * sc.N, seed, k, device)
              for k, sc in enumerate(scenes)]
    applied = [pb_program.probe_applies(op, X) for op, X in zip(ops, probes)]
    ops.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    worst, ctrl = {}, {}
    t = time.perf_counter()
    for k, sc in enumerate(scenes):
        el = pb_reference.eliminate(sc.edges, sc.weights, sc.landmarks, sc.N,
                                    sc.M, torch.float64, device)
        sides = [(worst, applied[k], outputs[k])]
        if control_dtype is not None:
            sides.append((ctrl, *pb_judge.control_outputs(
                sc, outputs[k], probes[k], control_dtype, device)))
        for into, got, outs in sides:
            for name, v in pb_judge.judge_scene(
                    el, probes[k], got, outs, config["limits"], seed, k,
                    device).items():
                into[name] = max(into.get(name, 0.0), v)
        del el
        if cuda:
            torch.cuda.empty_cache()
    log(f"[portbench] reference {time.perf_counter() - t} s")
    return worst, failed, ctrl


def run_cell(cell: pb_spec.Cell, seed: int, seconds: float, trace: bool,
             device, log=print) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, judgement, the
    metrics.  Returns the result line's dict."""
    import numpy as np
    import torch

    import pb_judge
    import pb_program
    import pb_trace

    config, parts = cell.config, {}
    t = time.perf_counter()
    parts["import"] = t - T_START
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    parts["cuda_init"], t = time.perf_counter() - t, time.perf_counter()
    if cuda:
        built = pb_program.build_kernels()
        if built:
            log(f"[portbench] nvcc built {sorted(built)}")
    parts["kernels"], t = time.perf_counter() - t, time.perf_counter()
    scenes = make_scenes(config)
    parts["scenes"], t = time.perf_counter() - t, time.perf_counter()
    mem = Memory(device)
    ops = [mem.build(pb_program.build_operator, sc, config, device)
           for sc in scenes]
    parts["operators"], t = time.perf_counter() - t, time.perf_counter()
    order = np.random.default_rng(seed).permutation(len(scenes))
    warm = mem.solve(int(order[0]), ops[order[0]], config, device)
    if warm.error:
        raise RuntimeError(f"warm-up solution raised:\n{warm.error}")
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START
    log("[portbench] setup_s " + json.dumps(setup_s) + " by part "
        + json.dumps(parts))

    K = len(scenes)
    traffic = cell.traffic
    if (traffic["loop"], traffic["clients"], traffic["order"]) != (
            "closed", 1, "cycle"):
        raise ValueError(f"unsupported traffic mix {traffic}")
    sols, t0 = [], time.perf_counter()

    def serve(until: float):
        """Whole cycles of the scenes in the seed's order until ``until``
        seconds of the window have passed."""
        while not (sols and len(sols) % K == 0
                   and time.perf_counter() - t0 >= until):
            k = int(order[len(sols) % K])
            sols.append(mem.solve(k, ops[k], config, device))
            log(f"[portbench] solution {len(sols)} scene {k} "
                f"{sols[-1].wall_s:.3f} s")

    rec = RunRecord(setup_s=setup_s)
    if trace:
        # the trace covers the window's first whole cycles past
        # TRACE_SECONDS of the window, the profiler's start included:
        # reading a longer trace outgrows the run's time
        rec.launches = pb_program.Launches()
        try:
            _, rec.trace = pb_trace.traced(
                lambda: serve(min(seconds, pb_trace.TRACE_SECONDS)))
        finally:
            rec.launches.close()
        rec.traced = list(sols)
    serve(seconds)
    window_s = time.perf_counter() - t0
    rec.solutions, rec.window_s = sols, window_s
    log(f"[portbench] window closed at {time.perf_counter() - T_START:.1f} s")
    rec.problem_peak_bytes, rec.peak_bytes = mem.problem_peak, mem.peak()
    log(f"[portbench] window {window_s} s, {len(sols)} solutions; scene, "
        "wall s, rank, outer, inner: " + json.dumps(
            [[s.scene, round(s.wall_s, 6)] + ([
                s.result.rank, s.result.outer_iters, s.result.total_inner]
                if s.result is not None else []) for s in sols]))

    # ---- judgement, after the window, with the program's state freed
    del warm
    worst, failed, _ = judge(scenes, ops, sols, config, seed, device, log=log)
    correct, checks = pb_judge.verdict(worst, failed, config["limits"])

    t = time.perf_counter()
    metrics_list = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in metrics_list:
        v = pb_spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(sols), "failed": failed,
              "metrics": metrics}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": rec.peak_bytes}
    result["device"] = dev
    if trace:
        dev.update(busy_s=pb_trace.busy_ns(rec.trace) / 1e9,
                   window_s=rec.trace.window_s)
        result["breakdown"] = {
            "device_ops": pb_trace.top_device_ops(rec.trace),
            "idle_gaps": pb_trace.idle_by_host(rec.trace)}
    result["checks"] = checks
    log(f"[portbench] metrics {time.perf_counter() - t:.1f} s, run "
        f"{time.perf_counter() - T_START:.1f} s")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = pb_spec.find_cell(args.workload, pb_spec.load_benchmark())

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2
    print(f"[portbench] {cell.name} seed {args.seed} seconds {args.seconds} "
          f"trace {args.trace}; card {power_line()}; peaks f32 67e12, f64 "
          f"34e12 FLOP/s, HBM 3.35e12 B/s", flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0),
                      log=lambda *a: print(*a, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
