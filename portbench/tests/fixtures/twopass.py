"""A two-solve route for the harness's tests, shaped like XM^2's two passes.
It lives outside ``routes/``, so no configuration can name it; a test
hands it to a cell by path.

Set-up holds the scene and its operator.  A request solves on the operator,
weighs each observation's squared residual at the recovered poses
(``xm2_residuals``, the program's), cuts the worst decile and the landmarks
left with fewer than two observations, builds the operator of the kept set
and solves again.  Both outputs are judged by the plain reference, each on
its own observation set, and ``cut_err`` counts the observations on which
the request's cut differs from the judge's own, made from the request's
first output with residuals of the judge's own.  ``"plant": "wrong_cut"``
in the configuration makes the request cut at the 85th percentile instead.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

import pb_judge
import pb_program
import pb_scenes
from xmtpu_torch.pipeline.xm2 import xm2_residuals

CHECKS = ("cut_err",)
PERCENTILE = 90.0


class Held(NamedTuple):
    scene: object
    operator: pb_program.Operator


class Kept(NamedTuple):
    """The observation set a request derived: the scene's rows ``rows``,
    its landmarks renumbered ``1..M``."""

    edges: np.ndarray
    weights: np.ndarray
    landmarks: np.ndarray
    N: int
    M: int
    rows: np.ndarray


def scenes(config: dict) -> list:
    gen = pb_scenes.GENERATORS[config["generator"]]
    return [gen(**config["scene"], seed=s) for s in config["scene_seeds"]]


def setup(scene, config: dict, device) -> Held:
    return Held(scene, pb_program.build_operator(scene, config, device))


def cut(scene, err: np.ndarray, percentile: float = PERCENTILE) -> Kept:
    """The rows at or under the ``percentile``-th percentile of ``err``,
    less those of the landmarks that keep fewer than two."""
    keep = err <= np.percentile(err, percentile)
    lm = scene.edges[:, 1] - 1
    keep &= np.bincount(lm[keep], minlength=scene.M)[lm] >= 2
    rows = np.flatnonzero(keep)
    kept_lm, renum = np.unique(lm[rows], return_inverse=True)
    edges = np.stack([scene.edges[rows, 0], renum + 1], axis=1)
    return Kept(edges, scene.weights[rows], scene.landmarks[rows], scene.N,
                len(kept_lm), rows)


def request(k: int, held: Held, config: dict,
            device) -> pb_program.Solution:
    t0 = time.perf_counter()
    first = pb_program.solve_one(k, held.operator, config, device)
    if first.error:
        return first
    out, sc = first.outputs[0].output, held.scene
    err = xm2_residuals(sc.edges, sc.weights, sc.landmarks, out.R_real,
                        out.s_real, out.t_est, out.p_est)
    kept = cut(sc, err, 85.0 if config.get("plant") == "wrong_cut"
               else PERCENTILE)
    second = pb_program.solve_one(
        k, pb_program.build_operator(kept, config, device), config, device)
    return pb_program.Solution(
        k, time.perf_counter() - t0, first.recover_s + second.recover_s,
        first.results + second.results,
        first.outputs + tuple(j._replace(obs=kept) for j in second.outputs),
        second.error)


def residuals(obs, out: pb_judge.Output) -> np.ndarray:
    """The judge's own weighted squared residual of each observation at the
    output's recovered poses."""
    f, lm = obs.edges[:, 0] - 1, obs.edges[:, 1] - 1
    Rc = out.R_real.reshape(3, obs.N, 3).transpose(1, 0, 2)
    seen = out.p_est.T[lm] - out.t_est.T[f]
    pred = out.s_real[f, None] * (Rc[f] @ obs.landmarks[:, :, None])[..., 0]
    return obs.weights * ((seen - pred) ** 2).sum(axis=1)


def judge(scenes, held, sols, config, seed, device, control_dtype=None,
          log=print) -> "tuple[dict, int, dict]":
    failed, judged = pb_judge.gather(sols, log)
    worst, ctrl, sets = {}, {}, {}
    for first, second in zip(judged[::2], judged[1::2]):
        k = first.output.scene
        own = cut(scenes[k], residuals(scenes[k], first.output))
        worst["cut_err"] = max(worst.get("cut_err", 0), len(
            np.setxor1d(own.rows, second.obs.rows)))
        sets.setdefault((k,), (k, scenes[k], []))[2].append(first)
        sets.setdefault((k, second.obs.rows.tobytes()),
                        (k, second.obs, []))[2].append(second)
    sets = list(sets.values())
    probes, applied = [], []
    for i, (k, obs, _) in enumerate(sets):
        probes.append(pb_judge.probe_block(3 * obs.N, seed, i, device))
        op = (held[k].operator if obs is scenes[k]
              else pb_program.build_operator(obs, config, device))
        applied.append(pb_program.probe_applies(op, probes[-1]))
        del op
    pb_judge.release(held, device)
    for i, (k, obs, js) in enumerate(sets):
        prog, con = pb_judge.judge_set(obs, probes[i], applied[i], js,
                                       config["limits"], seed, i, device,
                                       control_dtype)
        pb_judge.merge(worst, prog)
        if con is not None:
            pb_judge.merge(ctrl, con)
    return worst, failed, ctrl
