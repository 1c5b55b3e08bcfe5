"""The benchmark of ``xmtpu_torch``: certified solves on one H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration (a fixed
set of K problem instances, the solver's arguments and the route that
serves them, ``routes/<name>.py``) and a traffic mix (how the requests are
served).  Set-up builds the kernels, makes the route's scenes, builds what
it holds for each (``routes/certify.py``: one operator per scene), and
warms up with one request; the seed draws the order of service, the probe
of the operator and the certificate's start vectors.  The window then
serves the route's requests back to back, one user in a closed loop, the
scenes in turn in an order drawn from the seed, and closes at the end of
the cycle in flight once ``--seconds`` have passed, so that every run
serves whole cycles.  With ``--trace 1`` the window's first whole cycles
past ``pb_trace.TRACE_SECONDS`` run under the profiler.  Every request is
judged by the route against the plain reference (``pb_reference``,
``pb_judge``) after the window.  The last line
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


class Memory:
    """One problem's device memory, though set-up keeps what every scene
    holds resident (a route's ``setup``: its operator, say): the peak while
    one scene's set-up is built or one request runs, less what the other
    scenes hold.  ``peak()`` is the process's own peak, every scene's
    holding in it."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.device, self.torch = device, torch
        self.own = {}              # id(held) -> the bytes it holds
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

    def solve(self, request, k, held, config, device):
        base = self._start()
        sol = request(k, held, config, device)
        if self.cuda:
            others = base - self.own[id(held)]
            self.problem_peak = max(self.problem_peak, self._end() - others)
        return sol

    def peak(self) -> int:
        if self.cuda:
            self._end()
        return self._raw


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
    route = pb_spec.load_route(cell)
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
    scenes = route.scenes(config)
    parts["scenes"], t = time.perf_counter() - t, time.perf_counter()
    mem = Memory(device)
    held = [mem.build(route.setup, sc, config, device) for sc in scenes]
    parts["operators"], t = time.perf_counter() - t, time.perf_counter()
    order = np.random.default_rng(seed).permutation(len(scenes))
    warm = mem.solve(route.request, int(order[0]), held[order[0]], config,
                     device)
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
            sols.append(mem.solve(route.request, k, held[k], config,
                                  device))
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
    worst, failed, _ = route.judge(scenes, held, sols, config, seed, device,
                                   log=log)
    correct, checks = pb_judge.verdict(worst, failed, config["limits"],
                                       route.CHECKS)

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
