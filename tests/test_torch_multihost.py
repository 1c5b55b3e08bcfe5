"""Multi-process solves of the port (``xmtpu_torch.parallel.distributed``)
against the JAX package's single-process solve.

Launches coordinated worker processes (``python -m
xmtpu_torch.parallel._multihost_worker``, gloo on the host), each holding
its share of a global ``cam`` mesh of host slots and loading only its own
row slabs of the dense cost through ``distributed_dense_q``; every worker
must report the certified optimum of ``xmtpu.solver.staircase.solve_arrays``
on the same scene (``rtol 1e-9``), all with the same primal bits.  A
process that never joins turns into a clean, prompt error on the others.
Each launch takes a few seconds here (two to four fresh interpreters that
import torch); every subprocess has its own timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_workers(n_proc, slots, extra_env=None, timeout=240):
    """Start ``n_proc`` coordinated workers; return ``(results_by_pid,
    logs)`` with logs ``[(rc, stdout, stderr), ...]``."""
    port = _free_port()
    procs = []
    for pid in range(n_proc):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update({
            "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
            "XMTPU_MH_COORD": f"127.0.0.1:{port}",
            "XMTPU_MH_NPROC": str(n_proc), "XMTPU_MH_PID": str(pid),
            "XMTPU_MH_LOCAL_DEVICES": str(slots), "XMTPU_MH_DEVICE": "cpu",
        })
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "xmtpu_torch.parallel._multihost_worker"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    results, logs = {}, []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append((p.returncode, out, err))
            for line in out.splitlines():
                if line.startswith("XMTPU_MH_RESULT "):
                    r = json.loads(line[len("XMTPU_MH_RESULT "):])
                    results[r["pid"]] = r
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    return results, logs


def _single_process_reference(n_cam=16, n_pts=60):
    from xmtpu.assembly.creatematrix import create_matrix_arrays
    from xmtpu.pipeline.synthetic import make_scene
    from xmtpu.solver.staircase import solve_arrays

    scene = make_scene(n_cameras=n_cam, n_points=n_pts, obs_per_camera=30,
                       noise=1e-4, seed=91)
    C, _ = create_matrix_arrays(scene.weights, scene.edges, scene.landmarks)
    ref = solve_arrays(C, max_rank=4, tol=1e-8, lam=0.0, verbose=False)
    assert ref.certified
    return float(ref.primal)


@pytest.mark.parametrize("n_proc,slots,n_cam,n_pts", [
    (2, 4, 16, 60),     # two processes of four slots: the 8-slot mesh
    (4, 2, 16, 60),     # the same mesh cut twice as fine across processes
    (2, 4, 13, 50),     # 13 cameras over 8 slots: padded to 16, trimmed
])
def test_multi_process_solve_matches_single_process(n_proc, slots, n_cam,
                                                    n_pts):
    primal_ref = _single_process_reference(n_cam, n_pts)
    results, logs = _launch_workers(
        n_proc, slots, {"XMTPU_MH_N": str(n_cam), "XMTPU_MH_M": str(n_pts)})
    assert all(rc == 0 for rc, _, _ in logs), logs
    assert set(results) == set(range(n_proc)), logs
    for r in results.values():
        assert r["n_processes"] == n_proc and r["backend"] == "gloo"
        assert r["n_global_devices"] == n_proc * slots
        assert r["certified"] and r["rank"] == 3, r
        np.testing.assert_allclose(r["primal"], primal_ref, rtol=1e-9,
                                   atol=1e-12)
    assert len({r["primal_hex"] for r in results.values()}) == 1


def test_process_dropout_fails_cleanly_not_hang():
    """One launcher slot never joins: the live process must end with a
    clean non-zero error once the join times out (XMTPU_INIT_TIMEOUT),
    not hang and not report a result."""
    results, logs = _launch_workers(
        2, 2, extra_env={"XMTPU_MH_DROPOUT": "1", "XMTPU_INIT_TIMEOUT": "10"},
        timeout=90)
    assert results == {}, results          # nobody reached a solve
    rc0, out0, err0 = logs[0]
    assert rc0 != 0, (out0, err0)          # clean error, not success
    assert "timed out" in (err0 + out0).lower(), (out0, err0)
    assert logs[1][0] == 0 and "DROPOUT" in logs[1][1]


def test_init_distributed_rules(monkeypatch):
    """No address: a no-op.  NCCL with no card on the host, or with more
    local ranks (``LOCAL_WORLD_SIZE``) than cards, raises before NCCL does,
    naming gloo for ranks that share a card; without ``LOCAL_WORLD_SIZE``
    the global world size says nothing of this host (two hosts of one card
    each): the join goes ahead."""
    import torch.distributed as dist

    from xmtpu_torch.parallel.distributed import (global_mesh,
                                                  init_distributed)

    saved = {k: os.environ.pop(k) for k in ("MASTER_ADDR",) if k in os.environ}
    try:
        init_distributed(device="cpu")
        assert not dist.is_initialized()
    finally:
        os.environ.update(saved)
    with pytest.raises(ValueError, match="backend='gloo'"):
        init_distributed("127.0.0.1:1", 2, 0, device="cpu", backend="nccl")
    assert not dist.is_initialized()
    mesh = global_mesh(slots=3, device="cpu")
    assert (mesh.size, mesh.processes, mesh.rank) == (3, 1, 0)

    class Joined(Exception):
        pass

    def join(backend, **kw):
        raise Joined(backend, kw["world_size"], kw["rank"])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "init_process_group", join)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(Joined) as joined:
        init_distributed("127.0.0.1:1", 2, 1, device="cuda:0")
    assert joined.value.args == ("nccl", 2, 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="2 rank.* on this host, 1 card"):
        init_distributed("127.0.0.1:1", 2, 1, device="cuda:0")


def test_ranks_that_share_a_card_are_refused():
    """Joined, the ranks gather their cards (host and card) over a gloo
    group before NCCL makes a communicator: two ranks on one card make every
    rank leave the group and raise the same error; distinct cards pass."""
    from xmtpu_torch.parallel.distributed import _card_clash

    assert _card_clash(["a/0", "a/1", "b/0", "b/1"]) is None
    assert "ranks 0 and 2 share the card a/0" in _card_clash(
        ["a/0", "a/1", "a/0"])
    port = _free_port()
    code = (
        "import sys, torch.distributed as dist\n"
        "from xmtpu_torch.parallel import distributed as pd\n"
        "r = int(sys.argv[1])\n"
        f"dist.init_process_group('gloo', init_method='tcp://127.0.0.1:"
        f"{port}', world_size=2, rank=r)\n"
        "try:\n"
        "    pd._check_cards('host/card0')\n"
        "except ValueError as e:\n"
        "    print('REFUSED', dist.is_initialized(), e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "REFUSED False" in out and "ranks 0 and 1 share" in out, out
