"""Worker process for the multi-process solve.

Run as ``python -m xmtpu_torch.parallel._multihost_worker`` with env:

  XMTPU_MH_COORD          coordinator address (host:port)
  XMTPU_MH_NPROC          number of coordinated processes
  XMTPU_MH_PID            this process's id
  XMTPU_MH_LOCAL_DEVICES  mesh slots per process (default 4)
  XMTPU_MH_N / XMTPU_MH_M scene size overrides (default 16 / 60 cameras /
                          landmarks; an n the global slot count does not
                          divide gives phantom padding cameras)
  XMTPU_MH_DROPOUT        set on ONE process id: that process exits before
                          joining, simulating a crashed launcher slot; the
                          others must fail with a clean error when the join
                          times out (XMTPU_INIT_TIMEOUT)
  XMTPU_MH_TIMED          "1": a second, timed solve for iterations/s
  XMTPU_MH_DEVICE         the process's device: unset for the CUDA card
                          ``pid % device_count`` (it raises without one),
                          "cpu" for the host
  XMTPU_MH_BACKEND        the process group's backend (default: gloo on the
                          host, NCCL on a card; gloo for ranks that share one)

Each process joins the process group, builds the SAME dense cost matrix
locally (deterministic synthetic scene), loads only its own row slabs into
the global mesh through ``distributed_dense_q``, runs the certified
staircase (``solve_arrays_distributed``: every rank checks that all hold
the same primal to the bit) and prints one ``XMTPU_MH_RESULT {json}`` line.
"""

import json
import os


def main() -> None:
    n_proc = int(os.environ["XMTPU_MH_NPROC"])
    pid = int(os.environ["XMTPU_MH_PID"])
    coord = os.environ["XMTPU_MH_COORD"]
    slots = int(os.environ.get("XMTPU_MH_LOCAL_DEVICES", "4"))
    device = os.environ.get("XMTPU_MH_DEVICE") or None

    if os.environ.get("XMTPU_MH_DROPOUT") == str(pid):
        # simulated launcher-slot crash: exit before joining
        print("XMTPU_MH_DROPOUT exiting", flush=True)
        return

    import time

    import torch
    import torch.distributed as dist

    from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
    from xmtpu_torch.parallel.distributed import (global_mesh,
                                                  init_distributed,
                                                  solve_arrays_distributed)
    from xmtpu_torch.pipeline.synthetic import make_scene

    init_distributed(coordinator_address=coord, num_processes=n_proc,
                     process_id=pid, device=device,
                     backend=os.environ.get("XMTPU_MH_BACKEND"))
    assert dist.get_world_size() == n_proc, dist.get_world_size()
    mesh = global_mesh(slots=slots, device=device)

    n_cam = int(os.environ.get("XMTPU_MH_N", "16"))
    n_pts = int(os.environ.get("XMTPU_MH_M", "60"))
    scene = make_scene(n_cameras=n_cam, n_points=n_pts, obs_per_camera=30,
                       noise=1e-4, seed=91)
    C, _ = create_matrix_arrays(scene.weights, scene.edges, scene.landmarks,
                                device="cpu")
    C_np = C.numpy()

    def solve():
        return solve_arrays_distributed(mesh, lambda a, b: C_np[a:b],
                                        C_np.shape, max_rank=4, tol=1e-8,
                                        lam=0.0, verbose=False)

    res = solve()
    assert res.R.shape[0] == C_np.shape[0]
    out = {"pid": pid, "primal": float(res.primal),
           "primal_hex": float(res.primal).hex(),
           "certified": bool(res.certified), "rank": int(res.rank),
           "status": int(res.status), "n_global_devices": mesh.size,
           "n_processes": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(mesh.lead)}
    if os.environ.get("XMTPU_MH_TIMED") == "1":
        # a second solve for the iterations/s record
        if mesh.lead.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = solve()
        dt = time.perf_counter() - t0
        iters = int(res2.outer_iters) + int(res2.total_inner)
        out["iters_per_s"] = round(iters / dt, 1)
        out["iters"] = iters
    print("XMTPU_MH_RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
