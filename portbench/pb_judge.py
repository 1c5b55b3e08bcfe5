"""The comparison that decides ``correct``.

Each solution's outputs are judged against the plain reference
(``pb_reference``) at the timed sizes: the operator's product with a probe
block drawn from the seed, the reported primal at the returned factor, the
dual certificate at that factor, the rounded rotations and scales, and the
recovered translations and landmarks.  Every number is the worst over the
run's solutions and is held to the configuration's limit; a solution that
raised or did not certify counts in ``failed``, whose limit is 0.  A route
(``routes/<name>.py``) may hold checks of its own beside :data:`CHECKS`.
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import numpy as np
import torch

import pb_reference as ref

CHECKS = ("failed", "op_err", "primal_err", "cert", "rot_err", "scale_err",
          "pos_err")


class Output(NamedTuple):
    """What one solution hands back: the factor ``R`` (3N, o) and scales
    ``s_ex`` (N,), the reported ``primal`` and ``certified``, and the
    recovery ``R_real`` (3, 3N), ``s_real`` (N,), ``p_est`` (3, M),
    ``t_est`` (3, N)."""

    scene: int
    R: np.ndarray
    s_ex: np.ndarray
    primal: float
    certified: bool
    R_real: np.ndarray
    s_real: np.ndarray
    p_est: np.ndarray
    t_est: np.ndarray

    def key(self) -> tuple:
        return (self.scene, self.primal, self.certified) + tuple(
            np.ascontiguousarray(a).tobytes() for a in
            (self.R, self.s_ex, self.R_real, self.s_real, self.p_est,
             self.t_est))


class Judged(NamedTuple):
    """One output of a served request and what it is judged on: ``obs``,
    the observation set it was solved on (None: the scene's own; else a set
    the request derived, with the scene's ``edges``, ``weights``,
    ``landmarks``, ``N`` and ``M`` fields), and ``lam``, the scale penalty it
    was solved at."""

    output: Output
    obs: object
    lam: float


def gather(sols, log=print) -> "tuple[int, list]":
    """``(failed, judged)``: the requests that raised, returned no output or
    returned one that did not certify, and the :class:`Judged` outputs of
    the others, in request order."""
    failed, judged = 0, []
    for s in sols:
        if s.error:
            log(f"[portbench] scene {s.scene} raised:\n{s.error}")
        if (s.error or not s.outputs
                or not all(j.output.certified for j in s.outputs)):
            failed += 1
            continue
        judged.extend(s.outputs)
    return failed, judged


def release(held: list, device) -> None:
    """Frees what set-up held (``held`` is emptied) before the reference
    runs: the program's state is not the judge's."""
    held.clear()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def merge(into: dict, readings: dict) -> None:
    """Keeps each number's worst reading in ``into``."""
    for name, v in readings.items():
        into[name] = max(into.get(name, 0.0), v)


def seed_int(*parts) -> int:
    """A 63-bit integer drawn from the run's seed and ``parts``."""
    ss = np.random.SeedSequence([int(p) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def probe_block(n3: int, seed: int, k: int, device) -> torch.Tensor:
    """The probe block of scene ``k``: (3N, 8) standard normals."""
    g = torch.Generator().manual_seed(seed_int(seed, k, 1))
    return torch.randn((n3, 8), generator=g, dtype=torch.float64).to(device)


def judge_scene(el: ref.Elimination, X: torch.Tensor, applied: np.ndarray,
                outputs: list, limits: dict, seed: int, k: int,
                device) -> dict:
    """The worst reading of each number over the ``outputs`` of one scene
    (certified ones; identical outputs are judged once)."""
    CX = el.C @ X
    got = torch.as_tensor(applied, dtype=torch.float64, device=device)
    worst = {"op_err": float(torch.linalg.norm(got - CX)
                             / torch.linalg.norm(CX))}
    gen = torch.Generator(device=device).manual_seed(seed_int(seed, k, 2))
    seen = set()
    for out in outputs:
        if not out.certified or out.key() in seen:
            continue
        seen.add(out.key())
        for name, v in judge_output(el, out, limits, gen, device).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def judge_set(obs, X: torch.Tensor, applied: np.ndarray, judged: list,
              limits: dict, seed: int, k: int, device,
              control_dtype=None) -> "tuple[dict, dict | None]":
    """The worst readings of the :class:`Judged` outputs ``judged``, all
    solved on the observation set ``obs``, against the float64 reference
    eliminated once from it (``k`` draws the certificate's start vectors),
    and with ``control_dtype`` the control's readings at the same factors.
    The reference holds no scale penalty: an output solved at ``lam != 0``
    needs a reference of its route's own."""
    if any(j.lam != 0.0 for j in judged):
        raise ValueError("the plain reference judges outputs solved at "
                         "lam = 0 only")
    outputs = [j.output for j in judged]
    el = ref.eliminate(obs.edges, obs.weights, obs.landmarks, obs.N, obs.M,
                       torch.float64, device)
    ctrl = None
    if control_dtype is not None:
        ctrl = control_outputs(obs, outputs, X, control_dtype, device)
    prog = judge_scene(el, X, applied, outputs, limits, seed, k, device)
    if ctrl is not None:
        ctrl = judge_scene(el, X, *ctrl, limits, seed, k, device)
    del el
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return prog, ctrl


def judge_output(el: ref.Elimination, out: Output, limits: dict, gen,
                 device) -> dict:
    f64 = torch.float64
    S = ref.scaled_factor(out.R, out.s_ex, f64, device)
    bound, gap_tol = limits["cert_bound"], limits["cert_gap"]
    cert = ref.certificate(el.C, S, bound, gen)
    by_eig = max(0.0, -cert.lam_min) / bound
    by_gap = (cert.gap / cert.primal) / gap_tol
    Rb, s, Y = ref.rounding(out.R, out.s_ex, f64, device)
    t, p = ref.positions(el, Y)
    n = s.shape[0]
    Rp = torch.as_tensor(out.R_real, dtype=f64, device=device).reshape(
        3, n, 3).transpose(0, 1)
    sp = torch.as_tensor(out.s_real, dtype=f64, device=device)
    yp = torch.cat([torch.as_tensor(out.t_est, dtype=f64, device=device).T[1:],
                    torch.as_tensor(out.p_est, dtype=f64, device=device).T])
    yr = torch.cat([t, p])
    return {
        "primal_err": abs(out.primal - cert.primal) / abs(cert.primal),
        "cert": min(by_eig, by_gap),
        "rot_err": float(torch.linalg.norm(Rp - Rb, dim=(1, 2)).max()),
        "scale_err": float((torch.abs(sp - s) / s).max()),
        "pos_err": float(torch.linalg.norm(yp - yr) / torch.linalg.norm(yr)),
    }


def verdict(worst: dict, failed: int, limits: dict,
            extra: tuple = ()) -> "tuple[bool, dict]":
    """``(correct, checks)``: each number beside its limit, in
    :data:`CHECKS` order, then a route's own checks ``extra``."""
    worst = dict(worst, failed=failed)
    checks, ok = {}, True
    for name in CHECKS + tuple(extra):
        v, lim = worst.get(name), limits[name]
        if v is None:
            v = float("inf")      # a number that could not be read fails
        checks[name] = {"value": v, "limit": lim}
        ok = ok and bool(np.isfinite(v)) and v <= lim
    return ok, checks


def control_outputs(scene, outputs: list, X: torch.Tensor, dtype,
                    device) -> "tuple[np.ndarray, list]":
    """The control: the reference computed in ``dtype`` put in the
    program's place at the program's factors: its operator product, its
    primal, its rounding and its recovered positions (the certificate's
    verdict is the program's)."""
    el = ref.eliminate(scene.edges, scene.weights, scene.landmarks, scene.N,
                       scene.M, dtype, device)
    applied = (el.C @ X.to(dtype)).double().cpu().numpy()
    made = []
    for out in outputs:
        S = ref.scaled_factor(out.R, out.s_ex, dtype, device)
        Rb, s, Y = ref.rounding(out.R, out.s_ex, dtype, device)
        t, p = ref.positions(el, Y)
        n = scene.N
        R_real = Rb.transpose(0, 1).reshape(3, 3 * n).double().cpu().numpy()
        t_est = torch.cat([torch.zeros((1, 3), dtype=dtype, device=device),
                           t]).T.double().cpu().numpy()
        made.append(out._replace(
            primal=ref.objective(el.C, S), R_real=R_real,
            s_real=s.double().cpu().numpy(), t_est=t_est,
            p_est=p.T.double().cpu().numpy()))
    return applied, made
