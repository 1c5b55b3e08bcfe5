"""The reader of the trust region's graph replays, on made-up
``SolveResult.stages``: the summed ``graph_replays`` per traced solution,
and nothing where the program has no such counter."""

from types import SimpleNamespace

import pb_tiny  # noqa: F401
import pb_spec


def record(traced=()):
    return SimpleNamespace(trace=None, traced=list(traced))


def _solution(stages):
    return SimpleNamespace(result=SimpleNamespace(stages=tuple(stages)))


def test_graph_replays_per_solution():
    replays = pb_spec.reader("trust_region.graph_replays_per_solution")
    sols = [_solution([dict(rank=3, host_reads=300, graph_replays=700),
                       dict(rank=4, host_reads=100, graph_replays=0)]),
            _solution([dict(rank=3, host_reads=200, graph_replays=500)]),
            SimpleNamespace(result=None)]
    assert replays(record(traced=sols)) == 600.0
    # the eager route counts 0; an untraced run, or a program without the
    # counter, reads nothing
    eager = [_solution([dict(rank=3, host_reads=300, graph_replays=0)])]
    assert replays(record(traced=eager)) == 0.0
    for r in (record(), record(traced=[_solution([dict(rank=3,
                                                       host_reads=1)])])):
        assert replays(r) is None
