"""The default route: one certified solve of an operator built in set-up.

A configuration names its route by ``"route": "<name>"``; without the key it
is this one.  A route is a module ``routes/<name>.py`` that
``pb_spec.find_cell`` finds by that name, and a new one is a new file: the
harness (``run.py``) keeps the kernels' build, the traffic loop, the trace
window, the metric readers and the result line, and asks the route for the
rest.  It provides:

``scenes(config) -> list``
    The configuration's fixed scenes, made from its own keys, the same in
    every run: from ``pb_scenes.GENERATORS`` or a frozen generator in the
    route's own file.

``setup(scene, config, device) -> held``
    What set-up holds for one scene, built under ``run.Memory.build``, so
    that one problem's memory is counted: here the scene's operator
    (``pb_program.build_operator``); a route that builds inside its
    requests holds only the observations.

``request(k, held, config, device) -> pb_program.Solution``
    One served request of scene ``k``, run under ``run.Memory.solve``: its
    wall and recovery seconds on the host's clock, ``results``, every
    ``SolveResult`` it ran in order (``result`` is the last), and
    ``outputs``, each a ``pb_judge.Judged``: the output, the observation set
    it is judged on (None: the scene's own; or a set the request derived),
    and the ``lam`` it was solved at.  Here: ``pb_program.solve_one``, one
    solve and its recovery, timed from before ``solve_arrays`` to a
    synchronise after the recovery.

``judge(scenes, held, sols, config, seed, device, control_dtype=None,
log=print) -> (worst, failed, control)``
    After the window: each number's worst reading over the requests
    ``sols``, the requests that raised or did not certify, and with
    ``control_dtype`` the control's worst readings (the reference computed
    in that precision put in the program's place, for ``control.py``).  It
    reads what it needs of ``held`` (here the probe block's products), then
    frees it (``pb_judge.release``) before the reference runs.

``CHECKS``
    The route's own checks, judged beside ``pb_judge.CHECKS`` and printed
    after them, each listed in the configuration's ``limits`` (here none).
"""

from __future__ import annotations

import time

import pb_judge
import pb_program
import pb_scenes

CHECKS = ()


def scenes(config: dict) -> list:
    """The configuration's K scenes: a fixed set of problems, one for each
    generator seed in ``scene_seeds``.  (Drawn from the run's seed, the
    problems' work changed from run to run by up to tenfold.)"""
    gen = pb_scenes.GENERATORS[config["generator"]]
    return [gen(**config["scene"], seed=s) for s in config["scene_seeds"]]


def setup(scene, config: dict, device) -> pb_program.Operator:
    return pb_program.build_operator(scene, config, device)


def request(k: int, held: pb_program.Operator, config: dict,
            device) -> pb_program.Solution:
    return pb_program.solve_one(k, held, config, device)


def judge(scenes, ops, sols, config, seed, device, control_dtype=None,
          log=print) -> "tuple[dict, int, dict]":
    """``(worst, failed, control)`` against the float64 reference, C
    eliminated once a scene; the operators' products with the probe blocks
    are read before the operators are freed."""
    failed, judged = pb_judge.gather(sols, log)
    outputs = {k: [] for k in range(len(scenes))}
    for j in judged:
        outputs[j.output.scene].append(j)
    probes = [pb_judge.probe_block(3 * sc.N, seed, k, device)
              for k, sc in enumerate(scenes)]
    applied = [pb_program.probe_applies(op, X) for op, X in zip(ops, probes)]
    pb_judge.release(ops, device)
    worst, ctrl = {}, {}
    t = time.perf_counter()
    for k, sc in enumerate(scenes):
        prog, con = pb_judge.judge_set(sc, probes[k], applied[k], outputs[k],
                                       config["limits"], seed, k, device,
                                       control_dtype)
        pb_judge.merge(worst, prog)
        if con is not None:
            pb_judge.merge(ctrl, con)
    log(f"[portbench] reference {time.perf_counter() - t} s")
    return worst, failed, ctrl
