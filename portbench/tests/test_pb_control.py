"""The control, the float32 reference in the program's place, comes out as
not correct where the program comes out correct (small sizes; the cells'
own sizes run on the card through ``control.py``)."""

import pytest
import torch

import pb_tiny  # noqa: I001  (puts the benchmark on the path first)
import control
import pb_judge


@pytest.mark.parametrize("name", ["bal1936.certify", "escape",
                                  "schurq"])
def test_control_fails_where_the_program_passes(name, monkeypatch):
    cell = pb_tiny.tiny_cell(name, monkeypatch)
    out = control.readings(cell, 2**32 + 17, torch.device("cpu"),
                           torch.float32, log=lambda *a: None)
    limits = cell.config["limits"]
    ok, _ = pb_judge.verdict(out["program"], out["program"]["failed"], limits)
    assert ok, out["program"]
    bad, checks = pb_judge.verdict(out["control"], out["control"]["failed"],
                                   limits)
    assert not bad
    for name in ("op_err", "primal_err", "rot_err", "scale_err", "pos_err"):
        assert checks[name]["value"] > limits[name], name
