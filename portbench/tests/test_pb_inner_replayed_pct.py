"""The reader of the replayed share of the f64 tCG's inner iterations, on
made-up solve results: the summed ``inner_replayed`` over the summed
``total_inner``, and nothing where a run made no inner iteration or the
program has no such counter."""

from types import SimpleNamespace

import pytest

import pb_tiny  # noqa: F401
import pb_spec


def record(traced=()):
    return SimpleNamespace(trace=None, traced=list(traced))


def _solution(*solves):
    """A request of several solves, each ``(total_inner, stages)``."""
    return SimpleNamespace(results=[
        SimpleNamespace(total_inner=inner, stages=tuple(stages))
        for inner, stages in solves])


def test_replayed_share_of_the_inner_iterations():
    share = pb_spec.reader("trust_region.inner_replayed_pct")
    sols = [_solution((420, [dict(rank=3, inner_replayed=400,
                                  inner_masked=90, host_reads=300)]),
                      (650, [dict(rank=3, inner_replayed=600,
                                  inner_masked=70, host_reads=500),
                             dict(rank=4, inner_replayed=0,
                                  inner_masked=0, host_reads=4)])),
            SimpleNamespace(result=SimpleNamespace(
                total_inner=30, stages=(dict(rank=3, inner_replayed=30,
                                             inner_masked=2),))),
            SimpleNamespace(result=None)]
    assert share(record(traced=sols)) == pytest.approx(
        100.0 * (400 + 600 + 30) / (420 + 650 + 30))
    # the eager loop's iterations: none replayed
    host = [_solution((420, [dict(rank=3, inner_replayed=0,
                                  inner_masked=0)]))]
    assert share(record(traced=host)) == 0.0
    # no inner iteration, an untraced run, or a program without the
    # counter (the parent) reads nothing
    idle = [_solution((0, [dict(rank=3, inner_replayed=0,
                                inner_masked=0)]))]
    parent = [_solution((420, [dict(rank=3, host_reads=300,
                                    applies_replayed=0)]))]
    for r in (record(traced=idle), record(), record(traced=parent)):
        assert share(r) is None
