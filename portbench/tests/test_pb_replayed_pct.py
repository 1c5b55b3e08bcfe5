"""The reader of the replayed share of the implicit operator's products, on
made-up ``SolveResult.stages``: the summed ``applies_replayed`` over all
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


def test_replayed_share_of_the_implicit_products():
    replayed = pb_spec.reader("schurq.replayed_pct")
    sols = [_solution([dict(rank=3, applies_f64=40, applies_tf=10,
                            applies_f32=2000, applies_fused=1950,
                            applies_replayed=1800),
                       dict(rank=4, applies_f64=10, applies_tf=0,
                            applies_f32=0, applies_fused=0,
                            applies_replayed=0)]),
            _solution([dict(rank=3, applies_f64=30, applies_tf=20,
                            applies_f32=940, applies_fused=940,
                            applies_replayed=900)]),
            SimpleNamespace(result=None)]
    assert replayed(record(traced=sols)) == pytest.approx(
        100.0 * (1800 + 900) / 3050)
    # an eager program's products: none replayed
    eager = [_solution([dict(rank=3, applies_f64=40, applies_tf=10,
                             applies_f32=2000, applies_fused=1950,
                             applies_replayed=0)])]
    assert replayed(record(traced=eager)) == 0.0
    # no SchurQ product (the dense route), an untraced run, or a program
    # without the counter (the parent) reads nothing
    dense = [_solution([dict(rank=3, applies_f64=0, applies_tf=0,
                             applies_f32=0, applies_fused=0,
                             applies_replayed=0)])]
    parent = [_solution([dict(rank=3, applies_f64=40, applies_tf=10,
                              applies_f32=2000, applies_fused=1950)])]
    for r in (record(traced=dense), record(), record(traced=parent)):
        assert replayed(r) is None
