"""Fused Steihaug-tCG inner iteration: hand-written CUDA kernels + plain twins.

Counterpart of ``xmtpu/ops/pallas_tcg.py``.  Two kernels in
``xmtpu_torch/csrc/fused_tcg.cu``, each with a plain PyTorch version of the
same function in this module:

* ``tcg_step`` replaces ``pallas_tcg._tcg_kernel`` (body ``_tcg_body``): one
  whole preconditioned Steihaug-tCG inner iteration except the operator
  product.
* ``tcg_cw_dense`` replaces the in-kernel GEMM of
  ``pallas_tcg._tcg_kernel_dense``: ``CW = 2 C W`` with
  ``W = pR .* s_ex + R .* ps`` on the row-major f32 ``C``.  The dense
  variant is then two launches per inner iteration.

Above the dense gate (n > 512) the product stays a ``torch.matmul``, as the
reference leaves it to XLA outside its kernel.

Layout: camera-lane-major.  A block array ``X (n, 3, o)`` is stored as
``Xt (3o, n)`` with ``Xt[k*o+j, i] = X[i, k, j]``; scale-channel arrays are
``(n,)`` in camera slots with slot 0 (the pinned camera) held at zero.  The
reference pads ``n`` to the TPU's 128 lanes; the port does not pad.

Wrapper rule: a wrapper runs the plain version only for tensors on the CPU.
For CUDA tensors it launches its kernel (and counts the launch in its
``launches`` attribute) or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from xmtpu_torch.ops import manifold as mf

# scalar-carry slots (sc, shape (NS,)) and config slots (cfg, shape (NC,))
S_RDOTR, S_RDOTZ, S_VDOTV, S_VDOTP, S_PDOTP, S_ER, S_DONE, S_I = range(8)
NS = 8
C_LAM, C_DELTA, C_GNORM, C_RMIN = range(4)
NC = 4

ER_NEGCURV, ER_BOUNDARY, ER_SUPERLINEAR = 1, 2, 3
ER_SMALL_RDOTR, ER_MAX_INNER = 5, 6

# largest n for which the dense variant folds the operator product into
# tcg_cw_dense (the reference's Np <= 512 gate)
DENSE_MAX_N = 512
# largest rank the kernels are instantiated for (csrc/fused_tcg.cu MAXO)
MAX_RANK = 32
# inner iterations enqueued between two reads of the done flag; the kernels
# return at once once the carry is done, so the result does not depend on it
FLAG_EVERY = 4


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
    """Plain twin of the ``tcg_cw_dense`` kernel: writes ``CWt = 2 C W`` in
    the (3o, n) layout unless the carry is done."""
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


# ------------------------------------------------------------ wrappers --

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from xmtpu_torch import _build

    lib = _build.load("fused_tcg")
    if not getattr(lib, "_xm_typed", False):
        lib.xm_tcg_step.argtypes = [_P] * 21 + [_I, _I, _I, _P]
        lib.xm_tcg_step.restype = _I
        lib.xm_tcg_cw_dense.argtypes = [_P] * 7 + [_I, _I, _I, _P]
        lib.xm_tcg_cw_dense.restype = _I
        lib._xm_typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, device) -> int:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
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


def tcg_step(Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt, inv_ms,
             CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg, max_inner: int,
             work=None):
    """One fused inner iteration (see :func:`tcg_step_plain`).  ``work`` is
    optional ``((6o+1), n)`` f32 scratch for the kernel."""
    args = (Rt, s_ex_t, sfree, inv_s2, egs_t, Segrt, CsRt, minvRt, inv_ms,
            CWt, vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg)
    if _on_cpu(*args):
        tcg_step_plain(*args, max_inner)
        return
    three_o, n = Rt.shape
    o = three_o // 3
    if o < 1 or o > MAX_RANK or three_o != 3 * o:
        raise ValueError(f"tcg_step: rank {three_o / 3} outside 1..{MAX_RANK}")
    dev = Rt.device
    if dev.type != "cuda":
        raise ValueError(f"tcg_step: unsupported device {dev}")
    if work is None:
        work = torch.empty(((6 * o + 1), n), dtype=torch.float32, device=dev)
    blk, row = (three_o, n), (n,)
    shapes = (blk, row, row, row, row, (9, n), blk, (9, n), row, blk,
              blk, row, blk, row, blk, row, blk, row, (NS,), (NC,))
    names = ("Rt", "s_ex_t", "sfree", "inv_s2", "egs_t", "Segrt", "CsRt",
             "minvRt", "inv_ms", "CWt", "vR", "vs", "rR", "rs", "pR", "ps",
             "hvR", "hvs", "sc", "cfg")
    ptrs = [_check(nm, t, sh, dev) for nm, t, sh in zip(names, args, shapes)]
    ptrs.append(_check("work", work, ((6 * o + 1), n), dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().xm_tcg_step(*ptrs, n, o, int(max_inner), stream)
    _raise_on(rc, "tcg_step")
    tcg_step.launches += 1


tcg_step.launches = 0


def tcg_cw_dense(C, Rt, s_ex_t, pR, ps, sc, CWt, max_inner: int):
    """``CWt = 2 C W``, ``W = pR .* s_ex + R .* ps`` (see
    :func:`tcg_cw_dense_plain`); ``C`` is the row-major f32 (3n, 3n)."""
    args = (C, Rt, s_ex_t, pR, ps, sc, CWt)
    if _on_cpu(*args):
        tcg_cw_dense_plain(*args, max_inner)
        return
    three_o, n = Rt.shape
    o = three_o // 3
    if o < 1 or o > MAX_RANK or three_o != 3 * o:
        raise ValueError(
            f"tcg_cw_dense: rank {three_o / 3} outside 1..{MAX_RANK}")
    dev = Rt.device
    if dev.type != "cuda":
        raise ValueError(f"tcg_cw_dense: unsupported device {dev}")
    blk = (three_o, n)
    shapes = ((3 * n, 3 * n), blk, (n,), blk, (n,), (NS,), blk)
    names = ("C", "Rt", "s_ex_t", "pR", "ps", "sc", "CWt")
    ptrs = [_check(nm, t, sh, dev) for nm, t, sh in zip(names, args, shapes)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().xm_tcg_cw_dense(*ptrs, n, o, int(max_inner), stream)
    _raise_on(rc, "tcg_cw_dense")
    tcg_cw_dense.launches += 1


tcg_cw_dense.launches = 0


# ----------------------------------------------------------- the loop --

def prepare(R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm, delta, lam, cfg,
            minv):
    """Inputs of the fused loop in the kernel layout: returns ``(const,
    state, sc, cfgsc)`` where ``const`` holds the ten read-only arrays of
    ``tcg_step`` (``CWt`` as its scratch output) and ``state`` the eight
    carried arrays ``(vR, vs, rR, rs, pR, ps, hvR, hvs)``."""
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
    cfgsc = torch.tensor([float(lam), float(delta), float(gradnorm),
                          float(cfg.rdotr_min)], dtype=f32, device=dev)
    return const, state, sc, cfgsc


def dense_matrix(qmul, n: int):
    """The f32 dense matrix behind ``qmul`` when the dense variant applies:
    ``qmul`` is ``DenseQ.apply`` and n <= DENSE_MAX_N (the reference's gate,
    ``pallas_tcg.inner_tcg_fused``); else None."""
    qop = getattr(qmul, "__self__", None)
    C = getattr(qop, "C", None) if qop is not None else None
    if C is None or n > DENSE_MAX_N or tuple(C.shape) != (3 * n, 3 * n):
        return None
    return C.to(torch.float32).contiguous()


def inner_tcg_fused(qmul, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm, delta,
                    lam, cfg, minv):
    """Drop-in replacement for ``trust_region._inner_tcg`` on the f32 +
    block-Jacobi path.  Same returns: ``(vR, vs, hvR, hvs, endreason,
    iters)`` with host ints for the last two."""
    n, _, o = R.shape
    max_inner = int(cfg.max_inner)
    const, state, sc, cfgsc = prepare(R, s_ex, CsR, egR, egs, pgR, pgs,
                                      gradnorm, delta, lam, cfg, minv)
    vR, vs, rR, rs, pR, ps, hvR, hvs = state
    Rt, s_ex_t, CWt = const["Rt"], const["s_ex_t"], const["CWt"]
    C32 = dense_matrix(qmul, n)
    work = (torch.empty(((6 * o + 1), n), dtype=torch.float32,
                        device=R.device) if R.device.type == "cuda" else None)
    step_args = tuple(const.values()) + state + (sc, cfgsc)

    while True:
        for _ in range(FLAG_EVERY):
            if C32 is not None:
                tcg_cw_dense(C32, Rt, s_ex_t, pR, ps, sc, CWt, max_inner)
            else:
                # the split variant: the product outside the kernel
                W = mf.flatten(from_t(pR * s_ex_t + Rt * ps, n, o))
                CWt.copy_(to_t(mf.unflatten(2.0 * qmul(W))))
            tcg_step(*step_args, max_inner, work=work)
        carry = sc.tolist()
        if carry[S_DONE] != 0.0 or carry[S_I] >= max_inner:
            break

    dt = R.dtype
    return (from_t(vR, n, o).to(dt), unpack_s(vs, n).to(dt),
            from_t(hvR, n, o).to(dt), unpack_s(hvs, n).to(dt),
            int(carry[S_ER]), int(carry[S_I]))
