"""Multi-process runtime: initialization and row-slab problem loading.

PyTorch counterpart of ``xmtpu/parallel/distributed.py``:

* :func:`init_distributed` wraps ``torch.distributed.init_process_group``
  (address, process count and id from the arguments or from the environment
  ``torchrun`` sets); the backend follows the device, NCCL for CUDA and
  gloo for the host, and gloo may be named for ranks that share one card;
* :func:`global_mesh`: a 1-D ``cam`` mesh of every process's slots;
* :func:`distributed_dense_q`: each process loads only its own camera-row
  slabs of ``C`` into a :class:`~xmtpu_torch.parallel.sharded.ShardedDenseQ`
  whose applies all-gather the product's rows, so every rank runs the
  staircase on the same replicated carries and takes the same decisions
  (every start vector of the solver and the certificate comes from a fixed
  seed, whatever the rank).
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.parallel.mesh import Mesh
from xmtpu_torch.parallel.sharded import ShardedDenseQ


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     initialization_timeout: float | None = None,
                     device=None, backend: str | None = None) -> None:
    """Initialize the multi-process runtime (no-op without an address).

    ``coordinator_address`` is ``host:port`` (rank 0 serves it); without
    arguments the address, the process count and the id come from
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as
    ``torchrun`` sets them.

    ``initialization_timeout`` (seconds; env ``XMTPU_INIT_TIMEOUT``) bounds
    the join: a process that never joins (a crash before init, a bad
    launcher configuration) turns into a clean error on every live process
    after this long ("timed out"), instead of a hang.  It also bounds each
    collective.

    ``device``: this process's device (None = the CUDA card ``rank %
    device_count``, as :func:`global_mesh` takes it); ``backend``: None =
    NCCL on CUDA, gloo on the host.  NCCL takes one card a rank: it raises
    ``ValueError`` before NCCL's own error when this host has no card, when
    ``LOCAL_WORLD_SIZE`` (set by ``torchrun``) exceeds its cards, and, once
    joined, on every rank when two ranks name the same card of one host
    (:func:`_check_cards`); ranks that share a card name
    ``backend="gloo"``.
    """
    import torch.distributed as dist

    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return  # one process
    if initialization_timeout is None and "XMTPU_INIT_TIMEOUT" in os.environ:
        initialization_timeout = float(os.environ["XMTPU_INIT_TIMEOUT"])
    world = num_processes or int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        # only what is known of this host before the join
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        if cards < local or not cards:
            raise ValueError(f"NCCL takes one card a rank: {local} rank(s) "
                             f"on this host, {cards} card(s); {_SHARE}")
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, **kw)
    if backend == "nccl":
        idx = dev.index if dev.index is not None else rank % cards
        props = torch.cuda.get_device_properties(idx)
        _check_cards(f"{socket.gethostname()}/"
                     f"{getattr(props, 'uuid', idx)}")


_SHARE = "ranks that share a card use backend='gloo'"


def _card_clash(cards: list) -> str | None:
    """The error for the ranks' cards ``cards`` (``host/card`` a rank, in
    rank order) when two ranks name one card, else None."""
    seen = {}
    for rank, card in enumerate(cards):
        if card in seen:
            return (f"NCCL takes one card a rank: ranks {seen[card]} and "
                    f"{rank} share the card {card}; {_SHARE}")
        seen[card] = rank
    return None


def _check_cards(card: str) -> None:
    """Every rank's card, gathered over a gloo group before NCCL makes its
    first communicator: on a clash every rank leaves the process group and
    raises the same ``ValueError``."""
    import torch.distributed as dist

    group = dist.new_group(backend="gloo")
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, card, group=group)
    dist.destroy_process_group(group)
    err = _card_clash(cards)
    if err:
        dist.destroy_process_group()
        raise ValueError(err)


def global_mesh(axis: str = "cam", slots: int = 1, device=None) -> Mesh:
    """The mesh of every process's slots: ``slots`` on this process's
    ``device`` (None = the CUDA card ``rank % device_count``, one card a
    rank where there are enough; ``"cpu"`` for host slots)."""
    import torch.distributed as dist

    processes = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh([dev] * slots, (axis,), processes=processes, rank=rank)


def distributed_dense_q(mesh: Mesh, load_rows, shape, axis: str = "cam",
                        dtype=np.float64) -> ShardedDenseQ:
    """Build a row-sharded global dense C without any process holding all
    of it.

    ``load_rows(start, stop) -> np.ndarray`` supplies a row slab (e.g. a
    slice of ``Q.bin`` through a memory map); this process calls it for its
    own slots' rows only.

    When the camera count does not divide the global slot count, the matrix
    is zero-extended with PHANTOM camera blocks to the next multiple of it,
    the dense analog of ``schurq.pad_cameras``: zero diagonal blocks add
    nothing to the quadratic form, the solver leaves phantom frames at their
    initial iterate, and the certificate's per-camera dual solves are
    ridge-floored.

    RETURN CONTRACT (the reference's): the operator has the PADDED shape
    ``(3 n_pad, 3 n_pad)`` with ``n_pad = ceil(n / mesh.size) * mesh.size``,
    so solver outputs computed on it carry phantom rows the caller slices
    back to ``n``; :func:`solve_arrays_distributed` does that.
    """
    n = shape[0] // 3
    n_pad = n + (-n) % mesh.size
    rows = 3 * n_pad // mesh.size
    slabs, row0 = [], []
    for k, dev in enumerate(mesh.devices):
        a = (mesh.rank * len(mesh.devices) + k) * rows
        b = a + rows
        out = np.zeros((rows, 3 * n_pad), dtype=dtype)
        if a < shape[0]:
            hi = min(b, shape[0])
            out[: hi - a, : shape[1]] = np.asarray(load_rows(a, hi),
                                                   dtype=dtype)
        slabs.append(torch.as_tensor(out, device=dev))
        row0.append(a)
    return ShardedDenseQ.from_slabs(slabs, row0, mesh.lead,
                                    processes=mesh.processes)


def solve_arrays_distributed(mesh: Mesh, load_rows, shape, axis: str = "cam",
                             **kwargs):
    """Certified staircase on a distributed row-slab-loaded dense C, with
    phantom padding cameras sliced back off the solution, run on the mesh's
    lead device.  Every rank ends by checking, through an ``all_reduce`` of
    the primal's minimum and maximum, that all ranks hold the same primal to
    the bit; it raises when they do not."""
    import torch.distributed as dist

    from xmtpu_torch.solver.staircase import solve_arrays

    kwargs.setdefault("device", mesh.lead)
    n = shape[0] // 3
    Cg = distributed_dense_q(mesh, load_rows, shape, axis)
    res = solve_arrays(Cg, **kwargs)
    if Cg.shape[0] != shape[0]:
        res = res._replace(R=res.R[: 3 * n], s_ex=res.s_ex[:n])
    if mesh.processes > 1:
        p = torch.tensor([res.primal], dtype=torch.float64, device=mesh.lead)
        lo, hi = p.clone(), p.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        if not torch.equal(lo, hi):
            raise RuntimeError(f"the ranks' primals differ: "
                               f"{float(lo)!r} .. {float(hi)!r}")
    return res
