"""The reader of the fused share of the implicit operator's products, on
made-up ``SolveResult.stages``: the summed ``applies_fused`` over all
``SchurQ`` products, and nothing where a run made no such product or the
program has no such counter."""

from types import SimpleNamespace

import pytest

import pb_tiny  # noqa: F401
import pb_spec


def record(traced=()):
    return SimpleNamespace(trace=None, traced=list(traced))


def _solution(stages):
    return SimpleNamespace(result=SimpleNamespace(stages=tuple(stages)))


def test_fused_share_of_the_implicit_products():
    fused = pb_spec.reader("schurq.fused_pct")
    sols = [_solution([dict(rank=3, applies_f64=40, applies_tf=10,
                            applies_f32=2000, applies_fused=1950),
                       dict(rank=4, applies_f64=10, applies_tf=0,
                            applies_f32=0, applies_fused=0)]),
            _solution([dict(rank=3, applies_f64=30, applies_tf=20,
                            applies_f32=940, applies_fused=940)]),
            SimpleNamespace(result=None)]
    assert fused(record(traced=sols)) == pytest.approx(
        100.0 * (1950 + 940) / 3050)
    # no SchurQ product (the dense route), an untraced run, or a program
    # without the fused counter (the parent) reads nothing
    dense = [_solution([dict(rank=3, applies_f64=0, applies_tf=0,
                             applies_f32=0, applies_fused=0)])]
    parent = [_solution([dict(rank=3, applies_f64=40, applies_tf=10,
                              applies_f32=2000)])]
    for r in (record(traced=dense), record(), record(traced=parent)):
        assert fused(r) is None
