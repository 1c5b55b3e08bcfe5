"""A run drives the program with its timed path broken underneath and
reports ``correct`` false: once for each fault the cells can have.  (One
card each: no exchange between cards to leave out.)"""

import numpy as np
import pytest
import torch

import pb_tiny  # noqa: I001  (puts the benchmark on the path first)
import pb_program
import run
from xmtpu_torch.ops import manifold


def _half_batch(build):
    """Every other observation left out, the rest weighted twice: the
    mean taken over the half that is left."""
    def broken(weights, edges, landmarks, *a, **kw):
        keep = np.arange(len(edges)) % 2 == 0
        keep[np.unique(edges[:, 0], return_index=True)[1]] = True
        keep[np.unique(edges[:, 1], return_index=True)[1]] = True
        return build(2.0 * np.asarray(weights)[keep], edges[keep],
                     landmarks[keep], *a, **kw)
    return broken


def _altered(recover):
    """Camera 1's recovered rotation turned by 1e-4 rad about z."""
    def broken(*a, **kw):
        R_real, s_real, p_est, t_est = recover(*a, **kw)
        R_real = R_real.copy()
        c, s = np.cos(1e-4), np.sin(1e-4)
        R_real[:, 3:6] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) \
            @ R_real[:, 3:6]
        return R_real, s_real, p_est, t_est
    return broken


def _unchanged(R, s_ex, vR, vs, lr):
    return R, s_ex


FAULTS = {
    "step_unchanged": lambda mp, dense: mp.setattr(manifold, "retract",
                                                  _unchanged),
    "half_batch": lambda mp, dense: (
        mp.setattr(pb_program, "create_matrix_arrays",
                   _half_batch(pb_program.create_matrix_arrays)) if dense
        else mp.setattr(pb_program.schurq.SchurQ, "build",
                        staticmethod(_half_batch(
                            pb_program.schurq.SchurQ.build)))),
    "answer_altered": lambda mp, dense: mp.setattr(
        pb_program, "recover_XM" if dense else "recover_XM_implicit",
        _altered(getattr(pb_program,
                         "recover_XM" if dense else "recover_XM_implicit"))),
}


@pytest.mark.parametrize("cell_name", ["bal1936.certify",
                                       "schurq"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(cell_name, fault, monkeypatch):
    cell = pb_tiny.tiny_cell(cell_name, monkeypatch)
    cell.config["solve"]["max_rank"] = 4
    FAULTS[fault](monkeypatch, cell.config["operator"] == "dense")
    res = run.run_cell(cell, 12345, 0.1, False, torch.device("cpu"),
                       log=lambda *a: None)
    assert res["correct"] is False, res["checks"]
