"""Fused Steihaug-tCG inner iteration: a hand-written CUDA kernel + plain twins.

Counterpart of ``xmtpu/ops/pallas_tcg.py``.  One kernel template in
``xmtpu_torch/csrc/fused_tcg.cu``, launched in two variants, each with a plain
PyTorch version of the same function in this module:

* ``tcg_step`` replaces ``pallas_tcg._tcg_kernel`` (body ``_tcg_body``): one
  whole preconditioned Steihaug-tCG inner iteration except the operator
  product.  On the H100 it is bound by latency, not bytes (three phases of
  dependent loads around two reductions over every camera), so it is one
  launch spread over a thread-block cluster whose geometry
  :func:`step_geometry` gives (one block up to ``CAMS_PER_BLOCK`` cameras,
  then a block per ``CAMS_PER_BLOCK`` cameras up to ``MAX_CLUSTER``), the
  reductions exchanged through distributed shared memory in block order.
* ``tcg_step_dense`` replaces ``pallas_tcg._tcg_kernel_dense``: the same
  iteration with ``CW = 2 C W`` (``W = pR .* s_ex + R .* ps``, the row-major
  f32 ``C``, n <= ``DENSE_MAX_N``) computed inside the same launch, as the
  TPU kernel did, so the dense variant is one launch per inner iteration.
  The product is bound by the rate at which the launch's SMs pull ``C``
  (L2-resident across the loop) into registers; :func:`dense_geometry`
  gives it more blocks than the iteration body needs (a block per
  ``DENSE_CAMS_PER_BLOCK`` cameras, up to one cluster), each block
  streaming the contiguous rows of ``C`` of its own cameras with 16-byte
  loads, the next item in flight while it adds the last, against ``W`` in
  shared memory, and each warp summing its lanes in lane order.

Above the dense gate the product stays a ``torch.matmul``, as the reference
leaves it to XLA outside its kernel.

Layout: camera-lane-major.  A block array ``X (n, 3, o)`` is stored as
``Xt (3o, n)`` with ``Xt[k*o+j, i] = X[i, k, j]``; scale-channel arrays are
``(n,)`` in camera slots with slot 0 (the pinned camera) held at zero.  The
reference pads ``n`` to the TPU's 128 lanes; the port does not pad.

Wrapper rule: a wrapper runs the plain version only for tensors on the CPU.
For CUDA tensors it launches its kernel (and counts the launch in its
``launches`` attribute) or raises; it never falls back.  The launch goes to
the tensors' own card, whatever card is current (a device guard around the
ctypes call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.utils.timer import host_reads, launcher

# scalar-carry slots (sc, shape (NS,)) and config slots (cfg, shape (NC,))
S_RDOTR, S_RDOTZ, S_VDOTV, S_VDOTP, S_PDOTP, S_ER, S_DONE, S_I = range(8)
NS = 8
C_LAM, C_DELTA, C_GNORM, C_RMIN = range(4)
NC = 4

ER_NEGCURV, ER_BOUNDARY, ER_SUPERLINEAR = 1, 2, 3
ER_SMALL_RDOTR, ER_MAX_INNER = 5, 6

# largest n for which the dense variant folds the operator product into
# tcg_step_dense (the reference's Np <= 512 gate)
DENSE_MAX_N = 512
# largest rank the kernels are instantiated for (csrc/fused_tcg.cu MAXO)
MAX_RANK = 32
# inner iterations enqueued between two reads of the done flag; the kernels
# return at once once the carry is done, so the result does not depend on it
FLAG_EVERY = 4
# tcg_step launch geometry (see step_geometry): cameras a block takes before
# the launch grows by a block, and the most blocks of one launch (a cluster)
CAMS_PER_BLOCK = 128
MAX_CLUSTER = 16
# tcg_step_dense launch geometry (see dense_geometry): cameras a block takes
# before the launch grows by a block, and its threads (phase 0 streams C
# with every warp; threads without a camera add zeros to the reductions)
DENSE_CAMS_PER_BLOCK = 8
DENSE_THREADS = 256
# shared memory a tcg_step_dense block may take: the H100's 232,448 bytes a
# block, less the kernel's static arrays (800 bytes) and a margin
DENSE_SMEM_MAX = 232448 - 1024
# floats of a warp's reduction scratch in tcg_step_dense (csrc/fused_tcg.cu
# DENSE_RED_FLOATS)
DENSE_RED_FLOATS = 16 * 33


# ---------------------------------------------------------------- layout --

def to_t(X: torch.Tensor) -> torch.Tensor:
    """(n, 3, o) -> (3o, n) camera-lane-major, contiguous."""
    n, _, o = X.shape
    return X.permute(1, 2, 0).reshape(3 * o, n).contiguous()


def from_t(Xt: torch.Tensor, n: int, o: int) -> torch.Tensor:
    """(3o, n) -> (n, 3, o)."""
    return Xt.reshape(3, o, n).permute(2, 0, 1)


def pack_s(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n-1,) free-scale array -> (n,) camera slots, slot 0 = 0."""
    return torch.cat([torch.zeros((1,), dtype=x.dtype, device=x.device), x])


def unpack_s(xs: torch.Tensor, n: int) -> torch.Tensor:
    return xs[1:n]


def _blocks9(B: torch.Tensor) -> torch.Tensor:
    """(n, 3, 3) -> (9, n) with row k*3+l holding B[:, k, l]."""
    return B.permute(1, 2, 0).reshape(9, B.shape[0]).contiguous()


# ------------------------------------------------------ plain versions --

def _stopped(sc: torch.Tensor, max_inner: int) -> bool:
    done, i = sc[[S_DONE, S_I]].tolist()
    return done != 0.0 or i >= max_inner


def tcg_cw_dense_plain(C, Rt, s_ex_t, pR, ps, sc, CWt, max_inner: int):
    """The product of the dense variant: writes ``CWt = 2 C W``,
    ``W = pR .* s_ex + R .* ps``, in the (3o, n) layout unless the carry is
    done."""
    if _stopped(sc, max_inner):
        return
    three_o, n = Rt.shape
    o = three_o // 3
    W = pR * s_ex_t + Rt * ps                                  # (3o, n)
    Wf = mf.flatten(from_t(W, n, o))                           # (3n, o)
    CWt.copy_(to_t(mf.unflatten(2.0 * (C @ Wf))))


def _gram_sym(A, B):
    """(3, o, n) x (3, o, n) -> (3, 3, n): 0.5 sum_j (A_kj B_lj + A_lj B_kj)."""
    G = torch.einsum("kjn,ljn->kln", A, B)
    return 0.5 * (G + G.transpose(0, 1))


def _apply(S, X):
    """(3, 3, n) x (3, o, n) -> (3, o, n): sum_l S_kl X_lj."""
    return torch.einsum("kln,ljn->kjn", S, X)


def tcg_step_plain(Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt,
                   inv_ms, CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg,
                   max_inner: int):
    """Plain twin of the ``tcg_step`` kernel (``pallas_tcg._tcg_body``):
    one inner iteration, updating the eight state arrays and the scalar
    carry ``sc`` in place; nothing happens when the carry is done.  The
    scalar logic runs in f32 on the host."""
    if _stopped(sc, max_inner):
        return
    f32 = np.float32
    three_o, n = Rt.shape
    o = three_o // 3
    R, P = Rt.view(3, o, n), pR.view(3, o, n)
    CW, CsR = CWt.view(3, o, n), CsRt.view(3, o, n)
    Seg, Mv = Segrt.view(3, 3, n), minvRt.view(3, 3, n)
    lam, delta, gradnorm, rdotr_min = (f32(x) for x in cfg.tolist())
    rdotr, rdotz, vdotv, vdotp, pdotp, _, _, it = (f32(x) for x in sc.tolist())
    sex, su, msk = s_ex_t, ps, sfree

    # ehess tail and ehess2rhess
    h = CsR * su + CW * sex
    hs = ((CW * R).sum((0, 1)) + (CsR * P).sum((0, 1))
          + 4.0 * float(lam) * (3.0 * sex * sex - 1.0) * su) * msk
    rh = h - _apply(Seg, P)
    rh = rh - _apply(_gram_sym(R, rh), R)
    rhs = (hs * sex * sex + su * sex * egs_t) * msk
    pHp = f32((P * rh).sum().item() + (ps * rhs * inv_s2).sum().item())

    # Steihaug scalars (f32, as in the kernel)
    with np.errstate(all="ignore"):
        alpha = rdotz / pHp
        small = rdotr < rdotr_min
        negcurv = (not small) and alpha <= 0.0
        boundary_q = vdotv + f32(2.0) * alpha * vdotp + alpha * alpha * pdotp
        exceed = (not small) and (not negcurv) and boundary_q > delta * delta
        to_edge = negcurv or exceed
        normal = (not small) and (not to_edge)
        q = np.maximum(vdotp * vdotp + pdotp * (delta * delta - vdotv), f32(0))
        tau = (-vdotp + np.sqrt(q)) / pdotp
    coef = float(tau if to_edge else (alpha if normal else f32(0)))
    step_a = float(alpha if normal else f32(0))

    rh_t = rh.reshape(three_o, n)
    vR.add_(coef * pR)
    vs.add_(coef * ps)
    hvR.add_(coef * rh_t)
    hvs.add_(coef * rhs)
    rR.add_(step_a * rh_t)
    rs.add_(step_a * rhs)

    # projected block-Jacobi preconditioner
    rv = rR.view(3, o, n)
    z = _apply(Mv, rv)
    z = z - _apply(_gram_sym(R, z), R)
    zs = rs * inv_ms
    rdotr_new = f32((rR * rR).sum().item() + (rs * rs * inv_s2).sum().item())
    rdotz_new = f32((rv * z).sum().item() + (rs * zs * inv_s2).sum().item())
    with np.errstate(all="ignore"):
        superlin = normal and bool(
            np.sqrt(rdotr_new) < gradnorm * np.minimum(gradnorm, f32(0.1)))
        beta = rdotz_new / rdotz
    if normal:
        pR.mul_(float(beta)).sub_(z.reshape(three_o, n))
        ps.mul_(float(beta)).sub_(zs)
        new = [rdotr_new, rdotz_new,
               vdotv + f32(2.0) * alpha * vdotp + alpha * alpha * pdotp,
               beta * (vdotp + alpha * pdotp),
               beta * beta * pdotp + rdotz_new]
    else:
        new = [rdotr, rdotz, vdotv, vdotp, pdotp]
    er = (ER_SMALL_RDOTR if small else ER_NEGCURV if negcurv
          else ER_BOUNDARY if exceed else ER_SUPERLINEAR if superlin
          else ER_MAX_INNER)
    done = small or to_edge or superlin
    sc.copy_(torch.tensor([float(x) for x in new]
                          + [er, float(done), float(it) + 1.0],
                          dtype=torch.float32, device=sc.device))


def tcg_step_dense_plain(C, Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt,
                         minvRt, inv_ms, CWt, vR, vs, rR, rs, pR, ps, hvR,
                         hvs, sc, cfg, max_inner: int):
    """Plain twin of the ``tcg_step_dense`` kernel: :func:`tcg_cw_dense_plain`
    (the product into ``CWt``) followed by :func:`tcg_step_plain`."""
    tcg_cw_dense_plain(C, Rt, s_ex_t, pR, ps, sc, CWt, max_inner)
    tcg_step_plain(Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt,
                   inv_ms, CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg,
                   max_inner)


# ------------------------------------------------------------ geometry --

def max_threads(o: int, dense: bool = False) -> int:
    """Most threads of one ``tcg_step`` block at rank ``o``: the kernel's
    ``__launch_bounds__`` for its ``MAXO`` instantiation (4, 8 -> 512;
    16, 32 -> 256), which leaves a thread 128 or 255 registers; 256 at
    every rank for ``tcg_step_dense`` (255 registers: its product and
    phase 2 keep their loads in registers)."""
    return 256 if dense or o > 8 else 512


def step_geometry(n: int, o: int) -> "tuple[int, int]":
    """``(blocks, threads)`` of one ``tcg_step`` launch at ``n`` cameras:
    a block per ``CAMS_PER_BLOCK`` cameras, up to one cluster of
    ``MAX_CLUSTER`` blocks, and the fewest threads (a multiple of 32, at
    most :func:`max_threads`) that give every camera a thread; past that a
    thread takes every ``blocks * threads``-th camera.  Up to
    ``CAMS_PER_BLOCK`` cameras the launch is one block, whose reductions
    need no cross-block barrier."""
    blocks = min(MAX_CLUSTER, -(-n // CAMS_PER_BLOCK))
    threads = min(max_threads(o), 32 * -(-n // (32 * blocks)))
    return blocks, threads


def dense_smem_bytes(n: int, o: int, blocks: int, threads: int) -> int:
    """Shared memory of one ``tcg_step_dense`` block: ``W`` (o columns of
    3n floats, padded to a multiple of 4), the block's ``CW`` (3o rows of
    ``ceil(n / blocks)`` cameras) and each warp's reduction scratch (16
    rows of 33 floats), as ``csrc/fused_tcg.cu`` ``dense_smem_floats``
    computes it."""
    cpb = -(-n // blocks)
    return 4 * (o * (-(-3 * n // 4) * 4) + 3 * o * cpb
                + threads // 32 * DENSE_RED_FLOATS)


def dense_geometry(n: int, o: int) -> "tuple[int, int]":
    """``(blocks, threads)`` of one ``tcg_step_dense`` launch at ``n``
    cameras: a block per ``DENSE_CAMS_PER_BLOCK`` cameras up to one cluster
    of ``MAX_CLUSTER``, cut so that no block is empty; block ``b`` owns the
    contiguous cameras ``[b*cpb, (b+1)*cpb)``, ``cpb = ceil(n / blocks)``,
    in every phase, and its ``3*cpb`` rows of ``C``.  Threads:
    ``DENSE_THREADS`` within :func:`max_threads` ``(o, dense=True)``, and at
    least one a camera.
    Raises ``ValueError`` where a block's shared memory (:func:`dense_smem_bytes`)
    would pass ``DENSE_SMEM_MAX``."""
    blocks = min(MAX_CLUSTER, -(-n // DENSE_CAMS_PER_BLOCK))
    cpb = -(-n // blocks)
    blocks = -(-n // cpb)
    threads = min(max_threads(o, dense=True),
                  max(DENSE_THREADS, 32 * -(-cpb // 32)))
    smem = dense_smem_bytes(n, o, blocks, threads)
    if smem > DENSE_SMEM_MAX:
        raise ValueError(f"tcg_step_dense: n={n}, o={o} needs {smem} bytes of "
                         f"shared memory a block, above {DENSE_SMEM_MAX}")
    return blocks, threads


# ------------------------------------------------------------ wrappers --

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' library, loaded and typed once a process (``_build.load``
    hashes the sources to find it)."""
    from xmtpu_torch import _build

    lib = _build.load("fused_tcg")
    lib.xm_tcg_step.argtypes = [_P] * 21 + [_I] * 5 + [_P]
    lib.xm_tcg_step.restype = _I
    lib.xm_tcg_step_dense.argtypes = [_P] * 22 + [_I] * 5 + [_P]
    lib.xm_tcg_step_dense.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape, device,
           dtype=torch.float32) -> int:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


_STEP_NAMES = ("Rt", "s_ex_t", "sfree", "inv_s2", "egs_t", "Segrt", "CsRt",
               "minvRt", "inv_ms", "CWt", "vR", "vs", "rR", "rs", "pR", "ps",
               "hvR", "hvs", "sc", "cfg")


def _step_ptrs(what: str, args, work):
    """Checked pointers of the twenty ``tcg_step`` arguments and ``work``
    (allocated when None), with ``(n, o, device, work)``."""
    Rt = args[0]
    three_o, n = Rt.shape
    o = three_o // 3
    if o < 1 or o > MAX_RANK or three_o != 3 * o:
        raise ValueError(f"{what}: rank {three_o / 3} outside 1..{MAX_RANK}")
    dev = Rt.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if work is None:
        work = torch.empty(((6 * o + 1), n), dtype=torch.float32, device=dev)
    blk, row = (three_o, n), (n,)
    shapes = (blk, row, row, row, row, (9, n), blk, (9, n), row, blk,
              blk, row, blk, row, blk, row, blk, row, (NS,), (NC,))
    ptrs = [_check(nm, t, sh, dev) for nm, t, sh in zip(_STEP_NAMES, args,
                                                         shapes)]
    ptrs.append(_check("work", work, ((6 * o + 1), n), dev))
    return ptrs, n, o, dev, work


class Checked(NamedTuple):
    """One set of launch arguments with their checked pointers
    (:func:`check_step`), for a loop that launches on the same tensors
    again and again: the checks run once, not once a launch."""
    args: tuple            # the twenty tcg_step arguments
    C: "torch.Tensor | None"   # the dense variant's matrix
    work: torch.Tensor
    ptrs: list             # C's first for the dense variant, then work's last
    n: int
    o: int
    dev: torch.device

    def holds(self, args, C, work) -> bool:
        return (C is self.C and (work is None or work is self.work)
                and all(a is b for a, b in zip(args, self.args)))


def check_step(args, work=None, C=None) -> Checked:
    """Checks the twenty ``tcg_step`` arguments ``args`` (and the dense
    variant's ``C``) once; ``work`` is allocated when None."""
    what = "tcg_step" if C is None else "tcg_step_dense"
    ptrs, n, o, dev, work = _step_ptrs(what, args, work)
    if C is not None:
        ptrs.insert(0, _check("C", C, (3 * n, 3 * n), dev))
    return Checked(tuple(args), C, work, ptrs, n, o, dev)


def _checked(what: str, args, C, work, checked) -> Checked:
    if checked is None:
        return check_step(args, work, C)
    if not checked.holds(args, C, work):
        raise ValueError(f"{what}: ``checked`` was made for other tensors")
    return checked


@launcher
def tcg_step(Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt, inv_ms,
             CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg, max_inner: int,
             work=None, checked: "Checked | None" = None):
    """One fused inner iteration (see :func:`tcg_step_plain`), launched at
    :func:`step_geometry` ``(n, o)``.  ``work`` is optional ``((6o+1), n)``
    f32 scratch for the kernel; ``checked``, from :func:`check_step` on
    these very tensors, skips the argument checks.  A cluster the card
    cannot schedule raises."""
    args = (Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt, inv_ms,
            CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg)
    if _on_cpu(*args):
        tcg_step_plain(*args, max_inner)
        return
    c = _checked("tcg_step", args, None, work, checked)
    blocks, threads = step_geometry(c.n, c.o)
    with torch.cuda.device(c.dev):  # ctypes launches on the current device
        stream = torch.cuda.current_stream(c.dev).cuda_stream
        rc = _lib().xm_tcg_step(*c.ptrs, c.n, c.o, int(max_inner), blocks,
                                threads, stream)
    _raise_on(rc, "tcg_step")
    tcg_step.launches += 1


@launcher
def tcg_step_dense(C, Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt,
                   inv_ms, CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg,
                   max_inner: int, work=None,
                   checked: "Checked | None" = None):
    """One fused inner iteration of the dense variant, the product
    ``CW = 2 C W`` included (see :func:`tcg_step_dense_plain`; ``CWt``
    receives it), launched at :func:`dense_geometry` ``(n, o)``.  ``C`` is
    the row-major f32 (3n, 3n); ``work`` and ``checked`` as for
    :func:`tcg_step`."""
    args = (Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt, inv_ms,
            CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg)
    if _on_cpu(C, *args):
        tcg_step_dense_plain(C, *args, max_inner)
        return
    c = _checked("tcg_step_dense", args, C, work, checked)
    blocks, threads = dense_geometry(c.n, c.o)
    with torch.cuda.device(c.dev):
        stream = torch.cuda.current_stream(c.dev).cuda_stream
        rc = _lib().xm_tcg_step_dense(*c.ptrs, c.n, c.o, int(max_inner),
                                      blocks, threads, stream)
    _raise_on(rc, "tcg_step_dense")
    tcg_step_dense.launches += 1


# ----------------------------------------------------------- the loop --

# positions of the twenty tcg_step arguments: const (Rt .. CWt), the eight
# carried state arrays (vR .. hvs), sc, cfg
ARG = {name: i for i, name in enumerate(_STEP_NAMES)}


def prepare_arrays(R, s_ex, CsR, egR, egs, pgR, pgs, minv):
    """The loop's arrays in the kernel layout: ``(const, state, sc)``, where
    ``const`` holds the ten read-only arrays of ``tcg_step`` (``CWt`` as its
    scratch output), ``state`` the eight carried arrays ``(vR, vs, rR, rs,
    pR, ps, hvR, hvs)`` and ``sc`` the scalar carry.  Device work only: the
    graph route captures it."""
    n, _, o = R.shape
    dev = R.device
    s = s_ex[1:]
    Segr = mf.sym3(mf.gram3(R, egR))
    minv_R, ms = minv
    zR0 = mf.apply3(minv_R, pgR)
    zR0 = zR0 - mf.apply3(mf.sym3(mf.gram3(R, zR0)), R)
    zs0 = pgs / ms
    rdotr0 = mf.inner(pgR, pgR, pgs, pgs, s)
    rdotz0 = mf.inner(pgR, zR0, pgs, zs0, s)

    f32 = torch.float32
    const = dict(
        Rt=to_t(R.to(f32)),
        s_ex_t=s_ex.to(f32).contiguous(),
        sfree=pack_s(torch.ones((n - 1,), dtype=f32, device=dev), n),
        inv_s2=pack_s((1.0 / (s * s)).to(f32), n),
        egs_t=pack_s(egs.to(f32), n),
        Segrt=_blocks9(Segr.to(f32)),
        CsRt=to_t(CsR.to(f32)),
        minvRt=_blocks9(minv_R.to(f32)),
        inv_ms=pack_s((1.0 / ms).to(f32), n),
        CWt=torch.zeros((3 * o, n), dtype=f32, device=dev),
    )
    pgRt, zRt = to_t(pgR.to(f32)), to_t(zR0.to(f32))
    state = (torch.zeros_like(pgRt), torch.zeros((n,), dtype=f32, device=dev),
             pgRt, pack_s(pgs.to(f32), n), -zRt, -pack_s(zs0.to(f32), n),
             torch.zeros_like(pgRt), torch.zeros((n,), dtype=f32, device=dev))
    zero = torch.zeros((), dtype=f32, device=dev)
    sc = torch.stack([rdotr0.to(f32), rdotz0.to(f32), zero, zero,
                      rdotz0.to(f32), zero + ER_MAX_INNER, zero, zero])
    return const, state, sc


def config_carry(lam, delta, gradnorm, rdotr_min, device) -> torch.Tensor:
    """The loop's configuration slots ``cfg`` (``C_LAM`` .. ``C_RMIN``) in
    f32, uploaded from host scalars."""
    return torch.tensor([float(lam), float(delta), float(gradnorm),
                         float(rdotr_min)], dtype=torch.float32,
                        device=device)


def prepare(R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm, delta, lam, cfg,
            minv):
    """Inputs of the fused loop in the kernel layout: returns ``(const,
    state, sc, cfgsc)``, :func:`prepare_arrays`' three and
    :func:`config_carry`'s."""
    const, state, sc = prepare_arrays(R, s_ex, CsR, egR, egs, pgR, pgs, minv)
    return const, state, sc, config_carry(lam, delta, gradnorm,
                                          cfg.rdotr_min, R.device)


def dense_matrix(qmul, n: int):
    """The f32 dense matrix behind ``qmul`` when the dense variant applies:
    ``qmul`` is ``DenseQ.apply`` and n <= DENSE_MAX_N (the reference's gate,
    ``pallas_tcg.inner_tcg_fused``); else None."""
    qop = getattr(qmul, "__self__", None)
    C = getattr(qop, "C", None) if qop is not None else None
    if C is None or n > DENSE_MAX_N or tuple(C.shape) != (3 * n, 3 * n):
        return None
    return C.to(torch.float32).contiguous()


def split_product(qmul, args) -> None:
    """The split variant's product before each launch, into ``CWt``:
    ``2 Q W``, ``W = pR .* s_ex + R .* ps``, through ``qmul`` (the
    reference leaves it to XLA outside its kernel)."""
    Rt, s_ex_t, pR, ps = (args[ARG[k]] for k in ("Rt", "s_ex_t", "pR", "ps"))
    three_o, n = Rt.shape
    W = mf.flatten(from_t(pR * s_ex_t + Rt * ps, n, three_o // 3))
    args[ARG["CWt"]].copy_(to_t(mf.unflatten(2.0 * qmul(W))))


def loop_result(args, dt):
    """The loop's ``(vR, vs, hvR, hvs)`` out of the kernel layout, in
    ``dt``."""
    three_o, n = args[ARG["Rt"]].shape
    o = three_o // 3
    vR, vs, hvR, hvs = (args[ARG[k]] for k in ("vR", "vs", "hvR", "hvs"))
    return (from_t(vR, n, o).to(dt), unpack_s(vs, n).to(dt),
            from_t(hvR, n, o).to(dt), unpack_s(hvs, n).to(dt))


class Loop(NamedTuple):
    """What one fused loop launches on: the twenty ``tcg_step`` arguments,
    the dense variant's ``C`` (None: the split variant), the product that
    fills ``CWt`` before each split launch, and the checked pointers (None
    on the CPU, where the plain twins run)."""
    args: tuple
    C: "torch.Tensor | None"
    product: object
    checked: "Checked | None"


def bind_loop(qmul, args, product=None) -> Loop:
    """The loop over ``args``: the dense variant where :func:`dense_matrix`
    finds the matrix, else the split one with ``product`` (default: a call
    of :func:`split_product`)."""
    n = args[ARG["Rt"]].shape[1]
    C = dense_matrix(qmul, n)
    if C is not None:
        product = None
    elif product is None:
        product = functools.partial(split_product, qmul, args)
    checked = None if _on_cpu(*args) else check_step(args, None, C)
    return Loop(args, C, product, checked)


def _read_carry(sc: torch.Tensor) -> list:
    """The scalar carry on the host: a device tCG loop's one read between
    two stretches of iterations (:func:`until_done`; counted in
    ``utils.timer.host_reads``)."""
    host_reads.n += 1
    return sc.tolist()


def until_done(advance, carry: torch.Tensor, max_inner: int,
               at=(S_DONE, S_I)) -> list:
    """The flag-every-k loop that the device tCG loops run: ``advance()`` (a
    stretch of iterations, enqueued), then one read of ``carry``
    (:func:`_read_carry`), until its done flag (slot ``at[0]``) is set or
    its iteration count (slot ``at[1]``) reaches ``max_inner``.  Returns
    the last read."""
    done_at, i_at = at
    while True:
        advance()
        read = _read_carry(carry)
        if read[done_at] != 0 or read[i_at] >= max_inner:
            return read


def inner_tcg_fused(qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm, delta,
                    lam, cfg, minv, loop: "Loop | None" = None):
    """Drop-in replacement for ``trust_region._inner_tcg`` on the f32 +
    block-Jacobi path.  Same returns: ``(vR, vs, hvR, hvs, endreason,
    iters)`` with host ints for the last two.  ``loop``: the launch
    arguments, already filled (the graph route's static buffers); None
    prepares them from the other arguments."""
    max_inner = int(cfg.max_inner)
    if loop is None:
        const, state, sc, cfgsc = prepare(R, s_ex, CsR, egR, egs, pgR, pgs,
                                          gradnorm, delta, lam, cfg, minv)
        loop = bind_loop(qmul, tuple(const.values()) + state + (sc, cfgsc))
    args, C32, product, checked = loop

    def advance():
        for _ in range(FLAG_EVERY):
            if C32 is not None:
                # the dense variant: one launch, the product inside
                tcg_step_dense(C32, *args, max_inner, checked=checked)
                continue
            # the split variant: the product outside the kernel
            product()
            tcg_step(*args, max_inner, checked=checked)

    carry = until_done(advance, args[ARG["sc"]], max_inner)
    return loop_result(args, R.dtype) + (int(carry[S_ER]), int(carry[S_I]))
