"""XM^2's two-pass solve, whole: a request is ``xm2_solve`` at its defaults.

The contract is ``routes/certify.py``'s.  Here:

``scenes``
    The frozen window generator (``pb_scenes``), then outliers planted as
    ``examples/05_refine.py`` plants them: ``len // 30`` rows drawn from a
    seed of the scene's own, each moved by N(0, 1) * 5 (:func:`plant`).
    ``Outlied.planted`` records the rows.

``setup``
    Holds the observations only: the request builds its operators.

``request``
    ``xm2_solve`` on copies of the held arrays, its solve arguments the
    configuration's ``solve`` (``xm2_solve``'s defaults, written out), its
    ``rgbs`` carrying each observation's row so that the kept set can be
    read back.  The wall runs from the call to a synchronise after it
    returns.  Two outputs: pass 1 (judged on the judge's own clean of the
    scene, at its ``lam = |E| / N``: ``Judged.lam`` None) and pass 2
    (judged on the program's kept set, at the ``lam`` the program chose).
    The rank-3 probe is not a certified output: its scales go to the
    scale test, and it is judged by its gradient (below).

``judge``
    ``cut_err``: the observations on which the program's kept set differs
    from the judge's own, made from the program's pass-1 recovered poses by
    residuals, a percentile cut and a clean of the judge's own
    (:func:`residuals`, :func:`cut`, :func:`clean`, written from XM^2's
    and the view-graph cleanup's definitions, nothing of the program):
    kept by one alone, or numbered differently, the frame's number read
    through ``indices_all`` too.  ``lam_err``: the requests whose pass-2
    ``lam`` differs from the judge's scale test on the probe's scales
    (:func:`scale_test`).  ``probe_grad``: the probe, on the kept set at
    ``lam = 0``, by its Riemannian gradient norm over ``tol``
    (``pb_penalty.gradnorm``: the probe stops on it), its primal in
    ``primal_err``.  Every number of ``pb_judge.CHECKS`` for both passes,
    each by ``pb_penalty`` at its own ``lam`` (at ``lam = 0`` its readings
    are ``pb_judge``'s; ``cert`` where the program reports a certificate:
    XM^2 asks none of its first pass).  ``failed`` counts the requests that
    raised or whose final pass did not certify.  ``op_err``: the program's
    operator of each set (``SchurQ.build``) on the probe block, built after
    the window.
"""

from __future__ import annotations

import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

import pb_judge
import pb_penalty
import pb_program
import pb_scenes
from pb_judge import Judged, Output
from xmtpu_torch.pipeline.xm2 import XM2Result, xm2_solve

if "results" not in XM2Result._fields:
    raise ImportError("this xmtpu_torch's xm2_solve hands back no SolveResult"
                      ": the route cannot judge its passes")

CHECKS = ("cut_err", "lam_err", "probe_grad")
# the planted outliers (examples/05_refine.py): a 1/EVERY share of the rows
# moved by N(0, 1) * SIGMA, drawn from the scene's seed and PLANT_KEY
EVERY, SIGMA, PLANT_KEY = 30, 5.0, 30
# the view-graph cleanup's thresholds: a frame keeps more than FRAME_MIN
# observations, a landmark more than LANDMARK_MIN
FRAME_MIN, LANDMARK_MIN = 10, 1


class Outlied(NamedTuple):
    """A scene with planted outliers (``scene.landmarks`` moved) and the
    mask of the moved rows."""

    scene: pb_scenes.Scene
    planted: np.ndarray


class Obs(NamedTuple):
    """An observation set: the scene's rows ``rows``, numbered ``edges``
    (1-based frame, landmark), and ``frames``, each scene frame's number in
    it (0-based, -1 where dropped: ``XM2Result.indices_all``)."""

    edges: np.ndarray
    weights: np.ndarray
    landmarks: np.ndarray
    N: int
    M: int
    rows: np.ndarray
    frames: np.ndarray


def plant(scene: pb_scenes.Scene, seed: int) -> Outlied:
    rng = np.random.default_rng([seed, PLANT_KEY])
    E = len(scene.landmarks)
    bad = rng.choice(E, size=E // EVERY, replace=False)
    moved = scene.landmarks.copy()
    moved[bad] += rng.normal(size=(len(bad), 3)) * SIGMA
    planted = np.zeros(E, dtype=bool)
    planted[bad] = True
    return Outlied(scene._replace(landmarks=moved), planted)


def scenes(config: dict) -> list:
    gen = pb_scenes.GENERATORS[config["generator"]]
    return [plant(gen(**config["scene"], seed=s), s)
            for s in config["scene_seeds"]]


def setup(held: Outlied, config: dict, device) -> Outlied:
    return held


def request(k: int, held: Outlied, config: dict,
            device) -> pb_program.Solution:
    sc = held.scene
    rows = np.zeros((len(sc.edges), 3))
    rows[:, 0] = np.arange(len(sc.edges))
    t0 = time.perf_counter()
    try:
        r = xm2_solve(sc.edges.copy(), sc.weights.copy(),
                      sc.landmarks.copy(), rows, sc.N, sc.M, verbose=False,
                      device=device, **config["solve"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        first, _probe, last = r.results
        out1 = Output(k, first.R, first.s_ex, float(first.primal),
                      bool(first.certified), *r.first_pass)
        out2 = Output(k, last.R, last.s_ex, float(last.primal),
                      bool(last.certified), r.R_real, r.s_real, r.p_est,
                      r.t_est)
        kept = Obs(r.edges, r.weights, r.landmarks, int(r.edges[:, 0].max()),
                   int(r.edges[:, 1].max()), r.rgbs[:, 0].astype(np.int64),
                   r.indices_all)
        return pb_program.Solution(k, wall, float(sum(r.recover_s)),
                                   r.results, (Judged(out1, None, None),
                                               Judged(out2, kept,
                                                      float(r.lam))), "")
    except Exception:  # a request that raises is counted as failed
        return pb_program.Solution(k, time.perf_counter() - t0, 0.0, (), (),
                                   traceback.format_exc())


# ---- the judge's own cut, written from the definitions

def _renumber(ids: np.ndarray, count: int, more_than: int):
    """0-based ids with more than ``more_than`` rows, numbered in order:
    the map (-1 for the others) and the densest id."""
    c = np.bincount(ids, minlength=count)
    keep = c > more_than
    out = np.full(count, -1, dtype=np.int64)
    out[keep] = np.arange(int(keep.sum()))
    return out, int(np.argmax(c))


def clean(edges: np.ndarray, N: int, M: int) -> "tuple[np.ndarray, ...]":
    """The view-graph cleanup of 1-based ``edges`` over N frames, M
    landmarks: frames with more than :data:`FRAME_MIN` observations, the
    densest numbered 0 (it swaps numbers with the frame that had 0),
    landmarks with more than :data:`LANDMARK_MIN`, then the largest
    connected component of the frame-landmark graph (by its frames and
    landmarks), numbers made dense in order after each step.  Returns
    ``(rows, edges, frames)``: the rows kept, their new numbers, and each
    frame's number (-1 where dropped)."""
    f, l = edges[:, 0] - 1, edges[:, 1] - 1
    rows = np.arange(len(edges))
    frames, dense = _renumber(f, N, FRAME_MIN)
    if frames[dense] != 0:
        frames[frames == 0], frames[dense] = frames[dense], 0
    ok = frames[f] >= 0
    rows, f, l = rows[ok], frames[f[ok]], l[ok]
    lmap, _ = _renumber(l, M, LANDMARK_MIN)
    ok = lmap[l] >= 0
    rows, f, l = rows[ok], f[ok], lmap[l[ok]]

    def compact(f, l, frames):
        fm, _ = _renumber(f, int(frames.max()) + 1, 0)
        lm, _ = _renumber(l, int(l.max()) + 1, 0)
        return fm[f], lm[l], np.where(frames >= 0,
                                      fm[np.maximum(frames, 0)], -1)

    f, l, frames = compact(f, l, frames)
    n, m = int(f.max()) + 1, int(l.max()) + 1
    graph = coo_matrix((np.ones(len(f)), (f, n + l)), shape=(n + m, n + m))
    n_comp, label = connected_components(graph, directed=False)
    if n_comp > 1:
        ok = label[f] == np.argmax(np.bincount(label, minlength=n_comp))
        rows, f, l = rows[ok], f[ok], l[ok]
        f, l, frames = compact(f, l, frames)
    return rows, np.stack([f + 1, l + 1], axis=1), frames


def subset(scene, rows: np.ndarray, edges: np.ndarray,
           frames: np.ndarray) -> Obs:
    return Obs(edges, scene.weights[rows], scene.landmarks[rows],
               int(edges[:, 0].max()), int(edges[:, 1].max()), rows, frames)


def residuals(obs: Obs, out: Output) -> np.ndarray:
    """Each observation's weighted squared residual at the output's
    recovered poses: ``w |p_l - t_f - s_f R_f x|^2``, ``R_f`` camera to
    world."""
    f, lm = obs.edges[:, 0] - 1, obs.edges[:, 1] - 1
    Rc = out.R_real.reshape(3, obs.N, 3).transpose(1, 0, 2)
    seen = out.p_est.T[lm] - out.t_est.T[f]
    pred = out.s_real[f, None] * (Rc[f] @ obs.landmarks[:, :, None])[..., 0]
    return obs.weights * ((seen - pred) ** 2).sum(axis=1)


def cut(scene, first: Obs, out: Output, percentile: float) -> Obs:
    """XM^2's cut of the pass-1 set ``first`` at the pass-1 output ``out``:
    the rows at or under the ``percentile``-th percentile of the
    residuals, cleaned again."""
    err = residuals(first, out)
    keep = np.flatnonzero(err <= np.percentile(err, percentile))
    rows, edges, frames = clean(first.edges[keep], first.N, first.M)
    composed = np.where(first.frames >= 0,
                        frames[np.maximum(first.frames, 0)], -1)
    return subset(scene, first.rows[keep[rows]], edges, composed)


def scale_test(s: np.ndarray, kept: Obs) -> float:
    """XM^2's choice of the pass-2 ``lam`` from the probe's scales ``s``:
    ``|E| / N`` of the kept set where the scales look degenerate (their
    mean off 1 by more than two deviations, or more than ten under 0.1),
    else 0."""
    s = np.asarray(s).ravel()
    avg, std = np.mean(s[1:]), np.std(s[1:])
    if np.abs(avg - 1) > 2 * std or np.sum(s < 0.1) > 10:
        return len(kept.edges) / kept.N
    return 0.0


def differ(scene, own: Obs, got: Obs) -> int:
    """The scene's observations on which two kept sets differ: kept by one
    alone, or kept by both under other numbers, under a frame number that
    ``got.frames`` (the program's ``indices_all``) does not give, or with
    another weight or point than the scene's."""
    both, i, j = np.intersect1d(own.rows, got.rows, return_indices=True)
    frame = scene.edges[both, 0] - 1
    bad = (np.any(own.edges[i] != got.edges[j], axis=1)
           | (got.frames[frame] + 1 != own.edges[i, 0])
           | (got.weights[j] != scene.weights[both])
           | np.any(got.landmarks[j] != scene.landmarks[both], axis=1))
    return len(own.rows) + len(got.rows) - 2 * len(both) + int(bad.sum())


# ---- the judgement

def gather(sols, log=print) -> "tuple[int, list]":
    """``(failed, served)``: the requests that raised or whose final pass
    did not certify, and the others."""
    failed, served = 0, []
    for s in sols:
        if s.error:
            log(f"[portbench] scene {s.scene} raised:\n{s.error}")
        if s.error or len(s.outputs) != 2 or not s.outputs[1].output.certified:
            failed += 1
            continue
        served.append(s)
    return failed, served


def judge(scenes, held, sols, config, seed, device, control_dtype=None,
          log=print) -> "tuple[dict, int, dict]":
    """``(worst, failed, control)``: the judge's own cut and scale test
    against the program's, then each pass on its observation set against
    the float64 reference, after the program's state is freed."""
    failed, served = gather(sols, log)
    pct, tol = config["solve"]["percentile"], config["solve"]["tol"]
    firsts = [subset(sc.scene, *clean(sc.scene.edges, sc.scene.N,
                                      sc.scene.M)) for sc in scenes]
    worst = {"cut_err": 0, "lam_err": 0, "probe_grad": 0.0}
    # an observation set: (obs, [Judged at their lam], [the probes on it])
    sets = {}
    for s in served:
        k, (first, last) = s.scene, s.outputs
        scene = scenes[k].scene
        own = cut(scene, firsts[k], first.output, pct)
        worst["cut_err"] = max(worst["cut_err"], differ(scene, own,
                                                        last.obs))
        worst["lam_err"] += int(scale_test(s.results[1].s_ex, own)
                                != last.lam)
        lam1 = len(firsts[k].edges) / firsts[k].N
        sets.setdefault(("first", k), (firsts[k], [], []))[1].append(
            first._replace(obs=firsts[k], lam=lam1))
        kept = sets.setdefault(("last", k, last.obs.rows.tobytes(),
                                last.obs.edges.tobytes()), (last.obs, [], []))
        kept[1].append(last)
        kept[2].append(pb_penalty.Stationary(s.results[1], 0.0, tol))
    sets = list(sets.values())
    blocks, applied = [], []
    for i, (obs, _, _) in enumerate(sets):
        blocks.append(pb_judge.probe_block(3 * obs.N, seed, i, device))
        op = pb_program.build_operator(obs, config, device)
        applied.append(pb_program.probe_applies(op, blocks[-1]))
        del op
    pb_judge.release(held, device)
    ctrl = {}
    t = time.perf_counter()
    for i, (obs, js, stationary) in enumerate(sets):
        prog, con = pb_penalty.judge_set(obs, blocks[i], applied[i], js,
                                         config["limits"], seed, i, device,
                                         control_dtype, stationary)
        pb_judge.merge(worst, prog)
        if con is not None:
            pb_judge.merge(ctrl, con)
    log(f"[portbench] reference {time.perf_counter() - t} s, "
        f"{len(sets)} observation sets")
    return worst, failed, ctrl
