#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xmtpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):

1. build the CUDA kernels from ``xmtpu_torch/csrc`` (nvcc, all at once),
   and measure the chain floor's terms (:func:`measure_floors`);
2. hold each kernel against its plain PyTorch version on the card, on real
   f32-phase inputs (the first outer iteration of a stage, and one later in
   the phase where the Steihaug loop runs long): one inner iteration, two
   launches of it on the same inputs that must give the same bits, and a
   whole Steihaug loop; time both versions beside the kernel's bound and
   print the launch geometry (``fused_tcg.step_geometry``, or
   ``dense_geometry`` for ``tcg_step_dense``, which the dense cases also
   time beside ``torch.matmul`` on the same W and ``tcg_step`` alone);
3. scene A (n=120, the saddle-escape anchor): dense assembly on the card
   (its sums by frame and by landmark through ``sorted_segment_sum``, one
   launch each; its wall and launches printed) and the mixed certified
   staircase, which must certify at rank 4 through the dense kernel
   variant — one ``tcg_step_dense`` launch for each inner iteration the
   fused loops enqueue, no ``tcg_step`` — and match the port's own CPU
   run; then the assembly and the staircase again, which must repeat the
   bits of C (phase 2's too), the primal's bits, the outer and inner
   counts and every launch count; ``sorted_segment_sum`` held on the
   assembly's layouts (by frame at D = 13, by landmark at D = 1: the CPU
   twin's bits, twice, one launch a call, timed beside ``index_add_``);
   the CPU staircase on the card's C, its outer and inner counts printed;
4. scene B (n=1934): the same through the split variant, certified at
   rank 3, its assembly's C the bits of phase 2's, the kernel held on its
   assembly's layouts as in phase 3;
5. scene C (n=6144, the implicit size): ``xm2._assemble_operator`` must pick
   the implicit ``SchurQ``; both segment-sum kernels are held against their
   plain twin on its real orderings (landmark and frame, D in {3, 6, 9, 18},
   f32 and f64, the blocked one on ``schedule_edges``' layout of the landmark
   ordering), two launches must give the same bits, and each is timed beside
   its bound, its chain floor, the earlier design's time and
   ``index_add_``, the CSR
   kernel also bit for bit against the CPU twin; then ``tcg_step`` is held
   as in phase 2 at
   n=6144 (the split variant on the f32 cast of ``Q_C``, the f64 loop on
   ``Q_C``), at the phase's first outer iteration and at ``LONG_C``;
6. scene B through ``SchurQ`` (the mixed ladder on the two-float operator,
   the matvec certificate): certified at rank 3 within 5e-3 of the
   reference's primal; before it, the same operator built on the host and
   moved to the card must apply through the segment-sum kernel (exact, f32
   cast and two-float), with the same bits on two applies;
7. scene C through ``xm2._solve_recover`` at xm2's defaults: certified at
   rank 3 within 5e-3 of the reference's primal, recovered rotations no
   worse than 1.5x the reference's errors, segment-sum and tcg_step
   launches > 0; then a second, traced solve gives ``tcg_step``'s mean
   device time inside the solve (``solve_ms``);
8. ``xm2_solve(implicit=True)`` on scene B: its phases, and rotation errors
   no worse than 1.5x the reference's;
9. scene D (200 frames on a loop in a room, matched exhaustively, 5 % of
   the pairs corrupted; ``make_scene_d``) written as a COLMAP database:
   ``python -m xmtpu_torch mapper`` twice through ``__main__.main`` (equal
   tempdata files; images, valid pairs, tracks and observations equal to
   the JAX package's; every corrupted pair dropped, no clean one; ``R_rel``
   within 1e-4 of GT), the launches and host reads of one ``filter_pairs``
   call; ``filter_pairs`` on every stored pair with the rotations
   decomposed from their E (mask = the clean pairs, twice; its loops'
   iterations, launches and host reads); lifting with GT depth,
   ``xm2_solve`` at its defaults (dense: each pass's assembly wall, its
   sums by frame and by landmark launched once a pass, and the kernel held
   on each pass's assembly layouts as in phase 3) and implicit
   at tol 1e-4 (``sorted_segment_sum`` launched), each certified at the
   JAX package's rank within 5e-3 of its primal and 1.5x its rotation
   errors; the implicit route at its default tol certified at the rank of
   the dense route on its observations at the lam it picked, within 5e-3
   of that primal; ``sorted_segment_sum`` on each frame ordering the two
   implicit runs' ``SchurQ`` operators built, through their planned
   offsets, at every type and width those runs summed by frame, as in
   phase 10; and
   ``calibrate_view_graph`` within 1 % of the focal and 1e-6 of the JAX
   package's; per-stage seconds and the phase's device memory peak above
   what it started with;
10. scene D's mapper again with its tail stages 5-8 on (``--skip_* 0``):
   the observations after stages 5, 6 and 7, the tracks positioned, the
   strong clusters and the images kept held against the JAX package's;
   the focal within 1e-6 and ``R_global`` and the camera centres within
   1e-6 / 1e-5 of the JAX package's; the errors against ground truth
   (rotations after a global rotation, centres after a similarity) within
   1.5x of the JAX package's; every f64 segment-sum shape of the tail
   launched, every named layout launched, and no camera sum over the
   edges; a second ``global_positioning`` and positions-only
   ``bundle_adjustment`` call, traced, giving the same bits;
   ``sorted_segment_sum`` on the layouts the run built (BATA's two, BA's
   image, track and camera ones, the triangulation's tracks), through
   their planned offsets: the CPU twin's bits twice, one launch a call,
   timed beside ``index_add_``, the byte bound, the chain floor and the
   earlier design's time; per-stage seconds, launches by shape and by layout, the BA loops'
   host reads and the phase's device memory peak;
11. XM-SfM's last stage on scene D (``examples/05_refine.py``'s flow):
   phase 9's lifted observations with a thirtieth of the rows moved as
   planted outliers, ``relpose_filter`` with phase 9's exported relative
   poses (kept and dropped counts against the JAX package's), ``xm2_solve``
   at its defaults (rank and primal against the JAX package's; each
   pass's dense assembly twice more from its inputs, the same bits of C
   and Abar, the kernel held on each pass's assembly layouts as in phase
   3, one traced: segment sums, no ``index_add_`` kernel) and
   ``refine_bundle`` on its output (the XM^2 primal and the final cost
   also printed in hex, to compare runs): LM steps, final cost and the refined
   rotations and centres against the JAX package's, GT errors within 1.5x
   of its, the mean reprojection error falling, one host read a LM step and
   ``sorted_segment_sum`` at the refine's f64 shapes and on both its named
   layouts; the kernel on the refine's two layouts (by frame, by landmark)
   as in phase 10; the tiny monodepth net on the card against
   the port on the CPU and the JAX package's recorded numbers; a second
   ``refine_bundle`` call with the same bits; and a short call (5 LM
   steps) traced: its launches, no scalar read, no copy to the host beyond
   one a LM step and the result, no ``index_add_`` kernel, its device busy
   time by kernel;
12. the parallel paths (``xmtpu_torch.parallel``) on a 4-slot mesh: four
   cards where there are four, else ``Mesh((cuda:0,) * 4)``, four slots on
   the one card; on more than one card, ``tcg_step`` at scene C's n once
   on every card after the lead, with the lead current, giving the lead's
   bits; (a) scene B's dense C row-sharded, one ``sharded_tr_step``
   (the loss falls; R', s', loss' within 1e-9 of the single-card outer
   step) and ``solve_arrays_sharded`` at phase 4's settings (certified rank
   3 within 1e-4 of the reference's primal by the matvec certificate,
   ``tcg_step`` launched, never ``tcg_step_dense``), each slab's bytes;
   (b) scene C's ``SchurQ`` sharded by ``shard_schurq`` and solved at phase
   7's settings (certified rank 3 within 5e-3 of the reference's primal;
   ``sorted_segment_sum`` launched once for each slot's sum, each slot
   holding whole segments, and no launch of the twin; ``tcg_step``
   launched), then the f32
   phase's first outer iterations traced; (c) scene B's C written as
   ``Q.bin`` and solved by two spawned ranks on the card over gloo with
   CUDA tensors, each loading only its rows through a memory map
   (``solve_arrays_distributed``: both certify rank 3 with equal primal
   bits; their difference from (a) printed), and over NCCL, one rank a
   card, where there are two cards (else ``nccl: not run (1 card)``, and
   two NCCL ranks on the one card must be refused by
   ``init_distributed``'s card check with ``ValueError`` on both); each
   part's wall, device busy and idle share, launches and the ranks'
   all-gather seconds, with the card's name and power limit;
13. print the kernels' JSON line, the card's name and power limit, and the
   contract line ``{"ok": true, "device": {...}}`` last.

A kernel's ``ms`` is its time on the card per launch (profiler durations);
``enqueue_ms`` is the rate at which back-to-back calls of its Python wrapper
complete (CUDA events), which the host bounds at these sizes; ``plain_ms``
is the plain version's time per call by CUDA events, its host syncs
included; ``bound_ms`` is the larger of the bytes it must move over the
L2's read rate (:data:`L2_READ_BYTES`, an achieved rate, not a published
peak; past the L2's 50 MB, over the HBM rate: launches timed again and
again keep up to that much of their inputs in L2; ``bound_basis`` says
which) and its operations over the f32 (f64) peak; a segment sum's
``chain_floor_ms`` is its longest segment's chain of dependent adds at the
add latency measured in this run, plus an empty launch measured in this
run (``floors`` on its row), the floor under its contract (each segment
added in row order);
``library_ms`` is the card's time for ``torch.matmul`` on the same W (the
dense variant's product) or for one ``index_add_`` on the same tensors
(segment sums, whose plain twin is ``zeros`` + ``index_add_``).  Each kernel's ``launches`` sums
its counter over the main-path runs of phases 3, 4, 6, 7, 8, 9, 10, 11 and
12 (its ranks' counts read in each rank), each read just after its run with
the counters set to 0 just before (also under ``sharded`` for phase 12); the
segment sum's launches are also counted by dtype and D (its ``shapes``)
and by the layout its offsets' plan names (its ``layouts``: ``SchurQ
landmark`` / ``frame``, the tail's and the refine's ``Segments``), and its
row on the ``kernels`` line shows the most launched shape, f32 D=3 on the
landmark ordering, with the tail's and the refine's layouts under ``tail``
and ``refine`` (each with the launches of its layout and D in that phase's
main-path run) and phase 9's frame orderings under ``schurq_frame`` (the
launches of its layout, type and D in the two implicit runs) and the
dense assembly's layouts of scenes A and B and of the dense XM^2 passes
of phases 9 and 11 under ``assembly`` (the launches of its layout in the
run of its scene: phase 3's, phase 4's, phase 9's dense XM^2 and phase
11's XM^2).

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

# scene A, the repository's saddle-escape anchor: rank 3 refuted, rank 4
# certified at this primal (tests/test_scale.py, rtol 1e-4 as there)
SCENE_A = dict(n_cameras=120, n_points=400, obs_per_camera=10, noise=0.35,
               seed=1)
PRIMAL_A = 66.46483
# scene B, the n=1934 testbed (bench.py's _scale_metric shapes).  Reference
# value: the JAX package on the CPU at commit 7924370,
# solve_arrays(create_matrix_arrays(...)[0], max_rank=6, tol=1e-3,
# precision="mixed", inner_f32=True) -> certified rank 3, 77 outer / 294
# inner, lam_min -4.6e-13, primal 0.3741873841357
SCENE_B = dict(n_cameras=1934, n_points=7736, obs_per_camera=60, noise=1e-3,
               seed=0)
PRIMAL_B = 0.3741873841357
# scene B through the implicit operator.  Reference value: the JAX package
# on the CPU at commit 0f67b61, solve_arrays(SchurQ.build(...),
# max_rank=6, tol=1e-3, precision="mixed", inner_f32=True, edge_tf=True)
# -> certified rank 3, 117 outer / 338 inner, lam_min 1.1e-5
PRIMAL_B_IMPLICIT = 0.3742101204813012
# scene C, the implicit size (benchmarks/n6k_bench.py's scene): E = 270,336
SCENE_C = dict(n_cameras=6144, n_points=24576, obs_per_camera=40,
               noise=1e-3, seed=0, long_range=4)
# reference values, the JAX package on the CPU at commit 0f67b61:
# xm2._solve_recover(xm2._assemble_operator(..., implicit="auto",
# precision="mixed"), None, True, 5, 1e-1, 0.0, 1000.0, ..., "mixed") ->
# certified rank 3, 248 outer / 3230 inner, and the recovered rotations'
# errors against R_gt (radians, gauge-fixed to camera 0)
PRIMAL_C = 0.8487572611415747
ROT_C = dict(max=0.0005336820037861338, mean=0.00014647454844549592)
# xm2_solve(scene B, implicit=True) at its defaults, same commit: the final
# rotations' errors against R_gt
ROT_XM2_B = dict(max=0.0012587838027017166, mean=0.00011281938882602603)
RTOL_IMPLICIT = 5e-3
ROT_SLACK = 1.5
# the dense anchor of scene B, printed beside the implicit run's primal
DENSE_ANCHOR_B = 0.3741873841357
# the largest scene the dense variant's gate admits (n <= 512)
SCENE_512 = dict(n_cameras=512, n_points=2048, obs_per_camera=60, noise=1e-3,
                 seed=0)
RTOL_PRIMAL = 1e-4
# f32-phase outer iterations after which the Steihaug loop runs long (on
# the host: 54 iterations at scene A, 12 at scene B)
LONG_A, LONG_B = 85, 56
# the same at scene C on the f32 cast of SchurQ: 20 iterations after 104
# outer ones, 11-25 at every index from 95 to 119 (chip_profile.py
# --kernels, H100)
LONG_C = 104
LONG_C_ITERS = 10  # the fewest inner iterations the case must run

# scene D, a Replica-scale sequence matched exhaustively (the reference
# driver's pycolmap.match_exhaustive; Replica room sequences): a closed loop
# of frames in a room, a two-view geometry for every pair that shares enough
# points, 5 % of them corrupted; the mapper, lifting with GT depth and XM^2
SCENE_D = dict(n_frames=200, n_points=8000, seed=0)
SCENE_D_ROOM = (10.0, 8.0, 3.0)       # x, y, z extent (m), floor at z = 0
SCENE_D_LOOP = dict(rx=2.5, ry=2.0, height=1.5, sway=0.6, sway_cycles=3)
# the Replica camera: SIMPLE_PINHOLE 1200 x 680, prior focal kept
SCENE_D_CAMERA = dict(width=1200, height=680, f=600.0, cx=599.5, cy=339.5)
SCENE_D_MIN_SHARED = 50               # points a pair shares to be stored
SCENE_D_PIXEL_NOISE = 0.5             # keypoint noise (px)
SCENE_D_BAD = dict(share=0.05, deg=(20.0, 40.0))  # corrupted relative poses
# reference values: the JAX package on the CPU at commit 872ab1b, same
# generator and seed.  ``python -m xmtpu mapper --database_path D
# --output_path T`` on write_scene_d's database: images with observations in
# output.txt, lines of relative_pose.txt, tracks, observations
MAPPER_D = dict(registered=200, valid_pairs=7950, n_tracks=7381,
                n_obs=297217)
# then parse_glomap_tempdata(T) -> build_view_graph -> lift_dataset(GT depth
# of scene_d_depth) -> xm2_solve(..., verbose=False, **XM2_D_ARGS[route]):
# the last staircase solve's certified rank and primal, and the rotation
# errors of the result against GT.  The implicit route is held at tol=1e-4,
# where its stages run in f64: at the default tol=1e-1 (and at 1e-3) the f32
# and two-float stages stop at their noise floor, where the libraries'
# orders part, and on scene D that flips the rank-3 probe's scale test
# (|s_avg - 1| vs 2 std at std 1.5e-4), hence lam, rank and primal.  On the
# CPU the port takes the JAX package's branch at the default tol (lam 0,
# certified rank 3 at 6.666298070003821, commit fac41b7).  The default-tol
# run is held against the dense route at the lam it picked
# (hold_default_tol) and printed beside XM2_D_DEFAULT and XM2_D_FORCED
XM2_D_ARGS = dict(dense={}, implicit=dict(implicit=True, tol=1e-4))
XM2_D = dict(
    dense=dict(rank=4, primal=6.66350697353551,
               rot=dict(max=0.0009281971801524574,
                        mean=0.0005249496173795711)),
    implicit=dict(rank=4, primal=6.663506976056988,
                  rot=dict(max=0.0009281347632745869,
                           mean=0.0005249035385708607)))
XM2_D_DEFAULT = dict(rank=3, primal=6.665356859005428, lam=0.0,
                     rot=dict(max=0.0013050636879244804,
                              mean=0.0007242564219372327))
# the JAX package's default-tol implicit run with pass 2's final
# _solve_recover given lam = |E| / N of its observations (the branch its
# probe declined), at commit fac41b7: certified rank 4
XM2_D_FORCED = dict(rank=4, primal=6.777635902752089, lam=1337.475)
# calibrate_view_graph(*scene_d_calibration_inputs(scene D),
# prior_mask=[False]) -> focal
CALIB_D = 600.0000000000765

# scene D through the mapper's tail stages 5-8 (the four --skip_* flags 0).
# Reference values: the JAX package on the CPU at commit c758f5b,
# global_mapper_solve(database_to_view_graph(read_database(D)),
# GlobalMapperOptions(skip_global_positioning=False,
# skip_bundle_adjustment=False, skip_retriangulation=False,
# skip_pruning=False), verbose=True) on write_scene_d's database: the
# observations after stages 5, 6 and 7 and the tracks stage 5 positioned (its
# log lines), the strong clusters and the images kept by stage 8, the final
# focal, tail_gt_errors(R_global, t_global) and, in TAIL_D_POSES, R_global
# as rotation vectors and the camera centres (N x 3 each, float32, base64;
# tail_poses decodes them).  The same call through xmtpu_torch
# (device="cpu") gave equal counts, the focal 4.6e-7 px apart, R_global
# 4.5e-10 and the centres 3.6e-9 apart (the centres span 4.13 in the normalised frame).  On the card
# they are held to TAIL_D_TOL: counts within 1e-4 of the reference's (the
# filters are thresholds, and the card's f64 products add in other orders),
# the focal within 1e-6 relative, R_global entries within 1e-6 and the
# centres within 1e-5; and the errors against ground truth within ROT_SLACK
# of the reference's
TAIL_D = dict(gp_obs=258883, positioned=7381, ba_obs=127023, tri_obs=143544,
              clusters=1, registered=200)
TAIL_D_FOCAL = 589.3809540372678
TAIL_D_GT = dict(rot_max=0.02022909213798919, rot_mean=0.006541770547908728,
                 centre_max=0.001566667619792864,
                 centre_mean=0.0004965192971045819)
TAIL_D_TOL = dict(count=1e-4, focal=1e-6, R=1e-6, centre=1e-5)
TAIL_D_POSES = (
    "AAAAAAAAAAAAAAAAstExudovxD0Cgkc3YXGsOKt7Qz5a55c3KWjct5fukT74ONi3AOwCuHhL"
    "wT7YwVC4c+qJNnCZ7z5Vwnu2+FO1uNs9Dj+m0ha2u/YZudrtIz9p5Zm3H0O8uE2vOD9rkGI4"
    "leE0uPNmTD+OOaY3XhlruLEHXz93+VG1z7U1ucJ8cD/FDMO30dXTt7BUgD9tYq43o8TouPS7"
    "hz/gNts35xeZtyRzjj+fg484MPi/uAhzlD+XBS+4JKgPuRe5mT9lMzQ3cx4yuIdAnj/uQDw3"
    "VxL5t3oJoj9hVhA4/YVouPITpT/llg44gQJ6uPJqpz+lo5A3ogwKuXILqT9l07a36JAtuJD7"
    "qT+FU244jxRKOFhFqj/ERY238nnsNxnrqT+97+O3A4sDuYcAqT/dbcy4Xq+5tz2Mpz95IDm4"
    "o9EyuF2epT/8YGg4F7yLuPs6oz9/Yig4dDdJuVx8oD878J+4fDwDualmnT8HAA64rwaEuEkV"
    "mj874AO3r7gAuUaSlj/mtAw46f5XuSnskj9nebw3ZPc/uaQ0jz+CSZy4AG0xucSDiz+mneW3"
    "og11uQfhhz8H5UK4Ij1huDhkhD8/LK02l3znuNUYgT9aTSQ4Kj5EuaMgfD9GS8G4uEfSuHO2"
    "dj/Zuwo4xhLEuHIPcj+PjXu20C0QuThUbj+kpRG41b6EuY2Maz+y2Sm3asmIuKuxaT8Zc1S2"
    "lSjNuLEAaT/ok9Q4xiuCuJCFaT93zwO4nKVWuY9Eaz/WSYm4QU2guZhlbj8oEnq3akKVOArL"
    "cj/Hthm4+ghVuDGCeD9Bn1U4d0wauCKnfz/XG6Q4d7+PuO4WhD+78pg3i2lkuVn2iD9/w5+4"
    "TLwFt/mPjj+90Og3HerBN+XElD+V3Og4w6AfufWbmz+FvTm4pkIhuXcMoz/xFZ23mvDvN+YI"
    "qz/kzVE1hEILuZWFsz9jRR64wkfMuNt9vD90T704A7N7uafkxT/8Sgi3NKfauLelzz/dqFi3"
    "9QMjNhK52T8yUDI5voZYuTwN5D/D7R65GADYt/KW7j/KLjE5iDA6uY5G+T+9MKw2/Co8uFwH"
    "AkDd/Cc5Elg3ODNqB0BIeo45ZJlDuW3HDEBt5Au3z6gpue4XEkB+KzQ4Mbi2uGhTF0DV0L44"
    "6oYAuZVzHEC0WDk4BSFJuSBuIUCZHDm4SOrTuM4+JkCo2hg5CQZ/t8TdKkDavwM5t8+xuJZH"
    "L0AfU2I5BMmaN9tzM0CLQA85lnKeuIlfN0Ax0Eo5FEz0NQMEO0A/vx44Z55+uCdlPkAiHNa3"
    "JOA3uXl3QUARUS03HaHYt4U9REAwcgs5rchguYmzRkDSAos5M4saOMTaSEDnH6s40oYAN8Js"
    "R8BEY1a5e/97OHjkRcDjTIu5vSFZOLaoRMAiG3e57xq9OMy6Q8Cq70a58uXmOEITQ8Dv2Vi5"
    "z+/hOOquQsCd+YK5TjL3OCKLQsDsU7+54CjfNwWlQsA5z6m57TwHOXv1QsAp7Lu432R0NzV1"
    "Q8AgTO25wkG9OBghRMDotiQ5FSwWOTnyRMAlpEu5oM8YOD3eRcC5iOi4f+jBONfiRsDTbaC5"
    "jZcpOfP1R8CmKOm4fIWjOJ4MScCeC/64xsI/uZv2R0Alt4Y4xBEJtVHmRkARyaU5c3m7tmDf"
    "RUBI9f85/8scufzzRED1yjS5lVf9N4MkREBnXoo5hEkYueR5Q0A9g6Y5lU1duLz3QkDbU6M5"
    "q2KDuJ2oQkDXtjU5Oj/9NluNQkBDfK45bvEWuH2yQkDOcg05yhD8uEAUQ0Bia7o4DltBuYy7"
    "Q0BjYSG5dd2cuGyqREA8bgE6MrqXuNjlRUCuo3458MeZuDZzR0AiUbc5xhcOOVrZSMCf6Ay6"
    "caTuOHWyRsD0VoC5mRasOIs8RMCpGeW4n5poORV4QcCFVDW59GyZt5djPsBhbbS3J7suOOsD"
    "O8BSXNw3gWnqOO5gN8AuxrI5HGKXt7JyM8BPIZW5GLgEOdNIL8DGJai5ubk4uIDeKsBeV504"
    "5nAFN8E9JsD5kTC5sTOrOKVsIcCmaZk2vGdyOChyHMAQXCu5JuoyuFxSF8DeGsa4PtNSt5IZ"
    "EsCb9DC5vMGXuOPGDMDXONe42Mz4OPZnB8DkdFS5zqa8Np0EAsAZRfS3GutxuO1I+b9nUyK4"
    "EdP/NoeZ7r/KU7K4ihBFuFgO5L986+W4uEYYuK602b+N+Me4Jda8uCyez78aTpu4CGKDto7a"
    "xb8/CxC5hnGnNzh4vL9CNhW5BbgMN3p/s79G9Cm5dCxpNxwBq78dAy+5bpLtN4AGo79BeV+5"
    "Ga6QuIObm7/oq8K4s4M0t0HDlL+pmhS5qtGdOLyJjr9WTE+5zEC2N3X3iL/YhBG5E8BruEYN"
    "hL8dCzq4m7bwNwCdf7/wtV65Pjqut2eDeL+kJia5wffFOFDJcr/wgyq5/5eSt2Fjbr9Y9q+4"
    "e7l+N+1Ma78oRQO5g3sDucCAab+Dyca4UKV1uAkBab9gGeq4OmIFODqnab8u/uO4aKDUt+xz"
    "a79lPyG5pt2luDNCbr9BX5q4+U+1uAsUcr9TG6a4osBBuV67dr9K5cS4ZxQON9IjfL9reAa5"
    "bFaGt1EZgb8hMsO4SAuhNwtihL9iI9S4Ts8wuJ3fh788WjO4iMssuAx/i78nccG4WnjKuDIy"
    "j7+5Kqy4Cy41uTTokr+fvuM3OHnzN66Mlr/CVh65XomHuXQRmr+cpAo52kfpOCFknb91HGi5"
    "d3UquZt5oL/EEcA3NVqPN3k0o7+nDEO3xrZUOLSVpb9eoiK5Es8tucmLp78MtuS3R+AjONT9"
    "qL/jzIG41Sp/uLPoqb+ojSu59tGKuCNCqr9ZX+649nt5uPj4qb8rJYS4ELBduAQKqb95bLO4"
    "z96CuElrp78chQe5Key1uMsWpb/0Udm4jwkFufsDor8OkI24GPK3t9pAnr/B26i42BE5uBm0"
    "mb9eozq5mMkEN9VwlL9RjRY4BxsvOQ1ujr+DVUS5JU/XuDK5h79atqW4yD5sub9NgL92B8I4"
    "zPumuFtycL9jox25KscDuCD4Xr/t0824u63SuLNcTL+wfrS481CTuI2mOL9e4C25pogRuaDa"
    "I79OZBi4A36uuBU8Dr8m0JS4TPvSuCSK776qhAm5NoOatxlMwb5yzrO4BwpguEoNkr76ByO5"
    "9juvuGFrQ76hdOm42TEbuU/cw70MAre4niKEQAMLD7n5MaU8oxeEQFQrSTqeAf095N+DQOoa"
    "ibryd2c+d4+DQGmKx7eCY6g+FhyDQOMmDLlC5tw+3YqCQJAmG7qJwgg/7tKBQLtApLd8uyI/"
    "4PyAQHDyATr8sjw/KAiAQI3GbLmwYlY/ltV9QNUkhLnznm8/E2d7QFkpPbmDa4Q/ocN4QHZQ"
    "OzoL+JA/ENZ1QJxNGLoxWp0/CqpyQKIxbjgWe6k/4UlvQGKOSbrSfbU/j6trQCwS6bgQWcE/"
    "sNBnQEz30DlQD80/2rBjQAKF6LlahNg/ymVfQOjsJbrIueM/zd9aQE0L9LjZoe4/sxpWQNVX"
    "ebnFkfk/EiNRQJdEyDlAFwJALPRLQPrSFLpxPQdAQppGQDmBLrqFSwxAnQ5BQEC3JLrIGhFA"
    "wlU7QM3iKDqh3xVAD2k1QBr6yrjEcxpAJEsvQG/1KbqI9x5AMAApQHABDrrYMSNAvY8iQLhi"
    "GTpYXCdAlvsbQPCHpjklRytARDQVQPBpk7iOHi9AMlAOQDfpj7kkyDJANkYHQO0pHTocOTZA"
    "zRcAQEiABToSbzlAUKfxPzXywTkXjTxApdDiP1kuHDptcD9AdMHTP80WBboJKkJAxoTEP0BC"
    "l7kaqURAkRS1PyzeZjoJ/UZAom6lP+JX5LkkHElAO6uVP49ce7l6C0tA4MWFPy7T+7g75kxA"
    "KIBrPwJgKDooik5AvgNLPxLkmblhxk9AqYIqPxGrrrkl31BA4sQJPyrKsrnkxlFAj/PRPhQv"
    "CTq8a1JAlymQPm7YgDo4F1NA1pccPpl2ibr4XFNAI8TEPKHEDLpKa1NASIbXvciQZbolVlNA"
    "tRZvvuhEtLmmH1NAZ8a5vvPvjDlwelJAaiP7vr/zY7qh0FFAFF8evxejZbp33FBA8OE+v9hM"
    "BLlIt09A1DVfv8+SBjlXdE5AZlZ/v1W6eboh5kxAZJWPv+N13Dm7IUtA9Vqfvye2DrpZMUlA"
    "OASvv5Bp8Dn7G0dAtnW+v3CpnbkXuURA4L3Nv0XU0rpNLEJAurDcv1TJeDp3bD9AyH7rv031"
    "nLpBezxAxSD6vxMYRjkSaTlA30UEwCDtHLpALDZA1UYLwC++3bo6uDJAcyQSwPQ47ThuES9A"
    "v+IYwKPAArmFQCtAcoEfwIjHebmrSSdAbfQlwJxpBjj9KyNAkzoswP67zDnd2x5AqFEywKWo"
    "K7pWcBpAFDg4wKCVOLr22BVAg/49wBmvQ7r9HBFAKYZDwAVxM7rAOwxAIOFIwCmwGLqyMAdA"
    "evdNwIF4JzlWCgJATgJTwKZ5NDqOhfk/B7pXwMm4ujk2ue4/CkVcwG1RjLnFqeM/tJNgwBeL"
    "SLoSaNg/26hkwMFKl7kJ7cw/RJBowIuV3rnTQME/OzBswDwufLrNZbU/xphvwO34FLowVqk/"
    "n7RywNtV+rmyNJ0/iZ51wKj5ELpR2JA/H1V4wJOAYrq6YYQ/nsp6wAb1jrp4Z28/c/h8wIHT"
    "iLqL1lU/U9t+wAzSg7nUPjw/VEyAwHxesrqpRSI/wf+AwOExtDr2QQg/Co+BwIoxxbkNedw+"
    "vgeCwLhIRLl446c+OVeCwNzkMbq2u2Y+I4iCwOIBmLk6K/o9waGCwIQeErdR/5g8NIeCwKsg"
    "9Tjz8ay951uCwI9vhLpHnD++Bv6BwLudy7r3pZS+r46BwIHKjzrgE8m+e/yAwDtxGbqrSP2+"
    "IEqAwNFXd7qZwxi/O95+wDFWHLpEljK/o/h8wPK4A7qeNEy/erx6wGpMV7rfs2W/ymF4wGG3"
    "mrl24H6/8a51wObNCTi5Aoy/27pywAkIbDqOVZi/Ao5vwH0LlrrUcKS//C9swLF6tLkJjLC/"
    "1qlowMvs+bnvZry/F7VkwE0exrrIEsi/FJ9gwBn7Gbq4h9O/8klcwOv9TLdZyd6/H7ZXwJEt"
    "A7obx+m/tAVTwJ8v7jlvtvS/wBdOwMKt/TnqS/+/CNdIwBJH8jqDvATAVYpDwDyKAbpuyAnA"
    "Ru49wAHmErqhnw7A6i84wJ3OkjplYxPAf08ywJVfgjgeAxjAjzMswNcc3DmSdRzABeglwChs"
    "dziStSDAP3MfwNQT1Tno4yTAbd0YwBegjDjrwijAQBcSwOZd8DlonyzAijELwN/VNbrPQDDA"
    "4ioEwIHq6TmHrjPARP75v5uKPToO6DbAimHrvz41PDn8/znAhZjcv03XFToq5zzAkYbNv+a8"
    "Ijpqpj/A1Ua+v6SadDr8MkLAJtOuv4y4SzkYi0TA/Dyfv16RhLXfo0bAem6Pv4sK3riDmkjA"
    "pBt/v4UVZbl6V0rAFv9ev2B7iLmw20vA78U+vzBnbzoML03ANyQev3OiiTnkWk7A4dH6vrIA"
    "TbrxT0/Au1S5vjmVXbmfBlDAxVBuvl4AFzoGi1DA58TUvaauDLrc3lDAmPzJPKyUCrnY7VDA"
    "lzkcPqTESLpLz1DA+0KQPj4DCTqZelDAdQTSPu/Gm7mFAFDARgcKP5G/hzpSSk/Aa5EqP+ou"
    "/Dl+XE7AQ0BLP60/sDiFO03A/m1rP3XEnDiC5EvAztuFPz30QTokY0rAnrqVP8paTzoxmEjA"
    "znylP2stwzq/qEbAOyW1P0H6kzdNhETA9o/EP5P0Czo1KkLApNzTP3n+kjhtoj/AGebiPx0C"
    "Zjq17jzA4LXxP+AWMToqDjrA4SUAQDjwoDoC8jbAQU4HQA6StDotqzPANFgOQGP7FbknOjDA"
    "lEYVQGIUIzsGmyzAQgUcQOuuGLr70CjAkZciQBXs2Trx0iTADRkpQPH9BTpgwCDAz1gvQLIi"
    "KLn+dxzAF2s1QCtsoDoR9xfA9F87QAi1BTp3ahPAsxpBQPyLCTripw7AEKJGQBNtJDpCvwnA"
    "r/9LQMUgIDqCugTAIChRQAElPDoDJf+/nh5WQCDlMjqDl/S/A+RaQCsWLzpuu+m/nnNfQCIv"
    "Njra1N6/LrZjQDy59Tn1YtO/CN9nQFjy7TmDBsi/aqxrQB+f/DnuTby/Y1hvQBBqP7qch7C/"
    "+LRyQLnAozp0ZaS/ctp1QAFj4zoCQpi/IMx4QNlTpzll34u/Kol7QFB1zDnmAX+/yeR9QE74"
    "JzrppWW//gOAQBYICDo160u/WgSBQH7GmzqZdjK/pNSBQOuoLzobWxi/eIaCQNbHMToN4fy+"
    "sRmDQAcKk7kUaMi+dYKDQBqSCDqX35O+CeiDQNqdbjlMJj6+VxeEQBibTDp53am9")

# scene D through XM-SfM's last stage (examples/05_refine.py's flow at
# scene D's size; the reference's 5_test_ceres.py): phase 9's lifted
# observations with a thirtieth of the rows moved by N(0, 1) * 5
# (plant_outliers, the example's seed), relpose_filter with the export's
# relative poses, xm2_solve at its defaults, refine_bundle on its output from
# obs2d = landmarks[:, :2] / landmarks[:, 2:3].  Reference values: the JAX
# package on the CPU at commit 63fd83d, the same flow from
# parse_glomap_tempdata(T) of ``python -m xmtpu mapper --database_path D
# --output_path T`` on write_scene_d's database, build_view_graph and
# lift_dataset (GT depth of scene_d_depth): relpose_filter(edges, weights,
# landmarks, rgbs, relposes)'s kept and dropped rows; xm2_solve(...,
# verbose=False)'s last staircase solve (rank, primal) and
# rotation_error_stats of its output (REFINE_D_XM2_ROT);
# refine_bundle(out.edges, obs2d, out.R_real, out.t_est, out.p_est)'s LM
# steps and final cost, tail_gt_errors of its poses (REFINE_D_GT) and, in
# REFINE_D_POSES, its c2w rotations as rotation vectors and its camera
# centres (N x 3 each, solved order, float32, base64; tail_poses decodes
# them).  The refine's 100-step CG loses orthogonality on this problem's
# conditioning, so the last bits of its products decide the trajectory:
# over eight runs with its observations or its points moved by 1e-15 to
# 4e-15 relative, the JAX package itself lands up to 5.4e-5 (final cost,
# relative), 2.2e-5 (rotation entries) and 1.0e-4 (centres) from this run,
# and the port on the CPU (this flow from its own mapper) 4.9e-6, 7.7e-6 and
# 2.3e-5.  REFINE_D_TOL holds the refine at about three times the
# reference's own spread, the counts within 1e-4 (the relative poses come
# from the card's stage 3), XM^2's primal within RTOL_IMPLICIT
REFINE_D_OUTLIERS = dict(seed=1, every=30, sigma=5.0)
REFINE_D = dict(kept=98341, dropped=198876, rank=4,
                primal=2.9339556150344563, iterations=50,
                final_cost=0.07476225354117479)
REFINE_D_XM2_ROT = dict(max=0.0009490327993792669,
                        mean=0.0004999530401834997)
REFINE_D_GT = dict(rot_max=0.06846485509490155, rot_mean=0.029753771492641627,
                   centre_max=0.005737173396296902,
                   centre_mean=0.0020858121045522152)
REFINE_D_TOL = dict(count=1e-4, primal=RTOL_IMPLICIT, cost=2e-4, R=1e-4,
                    centre=3e-4)
REFINE_D_TRACED = 5    # LM steps of the traced refine call
REFINE_D_POSES = (
    "UVSuuTQgHjnYfs+2EZQ1OtPIyL/k+R+66SEWOmnx1L9mLRm6lmn9OUf64L83Zam5WDr1OQPT"
    "7L8f1uC537/lOaNl+L8USUi6WFQfOo3QAcCbmh+6G9O/Oe07B8Bf7TC6pJcUOmVqDMAwLiK6"
    "Cc4IOpBVEcA3d466u9r4OfH+FcDMsTy6dKIkOg1cGsCZNkK6Q6YKOb9mHsAA9Z26IH1mORgV"
    "IsDUH7S6SVy6OXh3JcCQhL66TcfkORx0KMAHWoi6OADUOacVK8ABcoO6y1WYOYFbLcBMPLC6"
    "bPOrOXhCL8BkEci6JBerOSDIMMA4ILu6bLiAOZ3yMcB+6Ka6MpbCOSHBMsAcg8y6I/SOOeQ7"
    "M8DPpq26XpcuOcJdM8DymOq69dwxOXkwM8CjNs66pIapObm8MsB2hq66ds+ZOQgDMsB3Ip26"
    "KDCTOZoLMcBg98K6rAXOOXzbL8A/wbW6AizCOTR5LsDloJS6/i6bOTTvLMCZ77m6Ee+zOeFF"
    "K8COZLS6eDsMOmSGKcD77li6ycW8Ofq0J8CX/Ke6RQLlOQrWJcAd1I26TcT9OTr9I8AkS4C6"
    "9Ib3OZAvIsBYH426tQcIOh5wIMA9jXK6TAwCOqbMHsDxgX+6qwSPOTtDHcBnDnW6fHM9OiLr"
    "G8BoYS66HG1mOU++GsDBCXi6psK/ONLUGcC82ZW6DcUNOuckGcBgLUG6bDxLOf2iGMCchIm6"
    "EoGlOcx7GMDQoY+6SfzCOYCZGMCTH5G6bwr/OfAGGcAWUlS6nuJIOuDaGcADn0q6TmCaOU3q"
    "GsA89aG6Fb5xOdVYHMD4iKa6Cot8OZInHsDnHqG6DEYkOiZDIMDsj6W6Qo11Oke9IsD5yoe5"
    "3JokOrCFJcDUb326LDKxOWGhKMCGpau6x9T6OdMNLMCk+Lq6Hi3UOTvKL8DOIGK6WZXjOXnD"
    "M8CJ5qK6mD0UOgP/N8CvX0C6kOc8Ojp7PMC20iO66loBOq80QcBY8IG6Fm7SOFkTRsCfRjm6"
    "bPM4uvgAR0CbkWw6x1/nucDaQUB4xjk6aWO7uWSVPEAcUbM54nkuuj89N0CSII06r+MKuuHX"
    "MUBQ2YQ6LcH1uQFyLEDYnFY61c98uWIaJ0CjnFQ6NJ5bue/LIUAjLj86Y4LRuTaLHECFKXE6"
    "t8jhuVRvF0D/bpU6BmzBuX11EkBU5046QUbQuRejDUDKF3c6xEGQuWgGCUDq1E864nQZugWd"
    "BEAhRZw6OI3UuFhsAECgkTs6UOI7ug8A+T/2O8k6mNl7uRu78T8g9086LeYNuSz16j/vgzw6"
    "mCOBuavR5D9Njw46muliuDBI3z9VcOo5HXS1uRhY2j9/KCc6VNCCuZYE1j++3WE6iVPVNrNU"
    "0j+L+Pk5cgvzuQBJzz/8zF466VuhuabLzD/gXhw6I7QcuSzxyj/e5/U5tDQbuZ6iyT855dE5"
    "F/WcuXrYyD+yEBo69sOhufGUyD82SCI6wFHBuEvFyD/jauw5i65vuctpyT+8ASU6zmrEuQdm"
    "yj8PpCY6OGIgOHXCyz8slNY52+0fuS9lzT9bGhU6XM8suEY6zz9WB8I5p5aKuRVD0T+5GvE5"
    "kAtoOQtk0z9q1+64e+3aNwKU1T8v1A06pHzKuNPJ1z9P+sM5+p/9ONL02T/9OeA4OGhaODwB"
    "3D8MEhM6tHFQN33f3T8LEb45ozUBuTxu3z8MTmI60cUlN73N4D+MYQg6KQenucbS4T8y9T46"
    "xr6XOQdn4j8kyGc5iQ+oOEKb4j8NdwA6LhESOk1b4j/vSGy5u/LOuJuj4T8xE805kUEVOgNI"
    "4D+PfrO5Ii64uL9e3j8yO+Q5342qObf12z/M+I05oD64OMrR2D9ZCDs5F1DGueJA1T90rhU6"
    "FFKVub/i0D9sFfI56b7vOUD7yz8BNTK5lBnEOTBoxj8h8I25gR0jOZVBwD92yRY476PbObaA"
    "uT8ESPi46hqzOf0psj/prio667a8uOZgqj8jbmk5N+JOuVALoj+N4O05y2axOeVCmT+2a7m3"
    "vzBUN3T9jz/TDcI4o+8rOUBchj+Od8G3CHmGuLXaeD9kUx84IZP0NatZZD9ZuPU4pVfNuYZ4"
    "Tz/cGoQ5GQFvuREzOj/BiE859Q94uVK9JD9Ikjq4RyMRuX0xDz9ft/y2BAQ8uYBm8z4F/WW3"
    "0M6CuXunyD4tySg45jHDuT1nnj7uZsA4N8osuXD9aT4PfuI3d9aSudFSGT7n8hU4A1OhuW03"
    "lj2mKxk4fNPVuXdtS76w8r64KHSEucNdj70hABu4Y3+6uWC4C75IwLm3o2kNOoB8vL8eGbq5"
    "KYETubttg772jG64qBodunrVnr41RD45D+NYucKxt77MAM64W6qOudPyzb5ENg+5RR56uIOv"
    "4b48Bpq53hqWuROi8r4N8hy5CTa5uQtnAL9UK9u4+DgVueQiBr9FDDy5sxZGuQ6RCr+1eJi5"
    "pmZZuY6XDb8o7Jm5bEBFuJJnD7/5uSi5wFC3uW7tD7+366W5AcsLueFCD79YNJe5q9+5uTxx"
    "Db/PGa25gi9CuZ+pCr85TvK58UhYuDjZBr8KjWm5NxWfOTszAr+6P0m5stqPOD2J+b5Lucu5"
    "d97kuI2D7b40rri5k68buKZc4L5grVW58wZjNxZY0r4WZDG5Q/OuOLbkw76BLdm4QOCCOVQJ"
    "tb40Wvq3AbTgOAIopr5lORu52fJdOYDBl76k+yW5ybuzOVChib5NLwe4T7ErOPSueL6G3T25"
    "b/MQOvILYL4+C/e4zuWLOXppSr5/i4a5jhxWued7N76Ir2S5pQRaOljwJr66MoG4+WlVOu71"
    "G75Nolm5oQZCOnzLFL6roAy4whe2OXDdEb43iHO2SJQnOmEvFL4IwGW4pgc3Oq5yG74N+RC5"
    "ldNzOtSxKL5U3b84opGpOeYVO745yKa43rplOvrBU74e+0w47ZkFOlzbcb5BvYe4Wne/OXsG"
    "i768dhs54JxTOlscoL5sYpC5kCgEuQE0uL7glnO5JsuAuHca077je765/Es3One/8L6Ekpq5"
    "KjukuOOUCL/TBDE5NfF3OArqGb/rYmS5pumfOU5vLL/MmbO5vqiuOfZIQL8P0WG5JC6mOVoM"
    "Vb8wDgu6DACxORXIar9DMgm5e5fROQSPgL9WRKe5JH6DOaAgjL9IWw+6QBfAOW/0l79LVUm5"
    "Gc7vORQHpL+cEp65XESKOZE8sL9jxu+5aXBsumBa77qjeRs6qsjRv7oGrLo9/lxAX7PZv+7q"
    "h7qlG11A3t3hvyvKLLleE11ArArqv5J6RrpE7lxAaSjyvwLG9brLoVxAJEH6v7g/nLplKFxA"
    "yy0BwDRJoLqmfFtAXTMFwLx8ZboYrFpAcEYJwPvkX7svdVlAHBsNwOeXoLr9l1hAQxARwNN4"
    "hbr7WFdA7AEVwBXnOLvQ7lVALeEYwBLfi7tOMFRAo8YcwNZEV7uXp1JAgIcgwLUTCrumxFBA"
    "LEokwIz3urpixk5APQgowPOUObt7lkxA7LwrwBtzWLsEYUpAu1IvwJcfKLvX7kdAE+kywAZa"
    "HrvKY0VA0mA2wDFqTbu5qEJAxd45wBHUIrvk0j9A4y89wLxCg7tz4TxAtmdAwGYQUrvI0zlA"
    "4rBDwEBZLrtDnTZAu9JGwFi/FbuhTzNAGelJwDuKQLsf2S9A6N1MwIQ2R7uqUSxAnbZPwMnG"
    "G7sPsChA+3tSwJdmPruE8yRAbyxVwDkQM7suCiFAK9hXwLK1qboSIB1AUWBawL49MbtOERlA"
    "c7NcwJ4JLLvw5RRAAf5ewG1wAbtRsRBAF0ZhwEdiHLseXAxAklJjwJrdELs/9wdArlBlwJcp"
    "C7uPhANArxxnwE6LBLvY3/0/r+powLhdrrp7vvQ/AX5qwN/vJ7t2Vus/2ypswJKxV7u78+E/"
    "Y65twB5h3rqgctg/MLtuwJG1Qbtoo84/yvBvwEn5M7uX+cQ/Cu9wwHXYKLtuHLs/c85xwIoO"
    "47o7QrE/1dhywEDlvLoVeac/jV9zwOx4S7shc50/xOtzwMwCObtqb5M/6XB0wIQYOru8eIk/"
    "krV0wLrcMbvAr34/Ofp0wDjfv7k3r2o/Agd1wO6oFLuzolY/nPJ0wJS1KbtDj0I/v7x0wJJ+"
    "UbslYS4/fot0wCtRrrp5kBo/MAV0wEVLI7sMawY/0V1zwMplq7lzguU+I6RywPyGPrlcM74+"
    "RftxwAS/lLqIVZc+rvJwwNGUVLl0YmE+qeVvwPkafLonshM+FphuwBQaGLmZfZE9dURtwIRj"
    "ezrIqBi78NZrwB35o7o4FZi9o1NqwEIqI7rHkhW+l69owEqu3rnS8V2+m8lmwEnVzLkemZG+"
    "X95kwCIKgTl0AbS++eliwLWjWbogsta+NcFgwAdayrrfcve+BnlewAwv07ljJQy/zipcwKJk"
    "vrr69Bu/VLRZwNTwX7qiPCu/ECZXwGfnEbtOYzq/gIxUwAxZv7l3Rkm/la9RwMJqPbtWoFe/"
    "kfROwB9hELrN7WS/NgxMwL+ahjkym3K/oA1JwC74nTiIVn+/cflFwLquJzo0w4W/S89CwBri"
    "x7l0uou/gI4/wDDeibo8fJG/ITw8wPvWPjpB45a/v9w4wOXc4ro84Zu/2mU1wIYP4rlh2aC/"
    "fOYxwL1nVDjJSqW/b1IuwBkanzlFi6m/ZLUqwBNSMbqvmK2/YAMnwPSiQLqePLG/hUcjwL3I"
    "ojnsv7S/SH4fwOCVYroBu7e/VasbwDEDkbpRmrq/lNQXwH0/ZzorCb2/bPMTwBFODTggKL+/"
    "9gcQwFLAhzl6GsG/txwMwHiAGbkIpcK/tCgIwMLxKzvJ98O/7icEwEpixDmU7sS/MiUAwNAu"
    "FTnnh8W/li34v6birjojtsW/DiLwv3YN5DkNocW/6S7ov8bJLDoTO8W/LBfgvzHJf7r1zsS/"
    "KwzYv8Xxh7mWycO/nQnQvxZlj7r5e8K/lhLIvwnFWzr6D8G/DBTAvygUiTisIL+/7Ce4vyBG"
    "LjtB6by/NRewv4L9eLkxO7q/DmOovwCgQDuZh7e/3LWgv2sW1Lg7m7S/0OCYv6ifhTrjErG/"
    "m1GRv0aElTr9oa2/VaOJv3ofGLoIMam//0mCv0rOebqjO6W/2Px1vyA+3jroi6C/YUJnvxgk"
    "CjvHwJu/cv9Yv2pdODp4uJa/TcRKv/kZ6ToHZpG/wQ08vzyiIztBg4u/scgvv7SI3bl6u4W/"
    "h4MivwxC7bkT/36/qt0Vv8441zoADnK/lSAJvxYRU7fd/2S/hM35vmMJRTptNle/ZXXivsaE"
    "pLh510i/C8vKvi+J1rnIJDq/DMW0vsPW2brr+yq/Ht+evqVRlbroeRu/9QmKvg2DerqCdQu/"
    "P+lrvn+HNrptfPa+izFGvrn4iLouG9W+/+ggvnzPn7r+G7O+qQ35vclgzrqoNZC+3R+1vZMB"
    "SLrl8Fm+bfBqvc8zuLq+DBK+tyzhvP4j3rq//JG9+caSPeMrCLuAmGI+jZjPPBHQxLotg5c9"
    "dS5LPSAiB7uZ3hc+Zp/Jv1XbTbrnlVxAgKq6PZCejLrOypg+6bbhPf/yOLsYDcE+PYoBPhL1"
    "r7qEPec+7bwPPihbv7qnXwc/c2AdPuGRnbpGZBs/axQoPsfj87qCTC8/KzYwPgsKCbs/RkM/"
    "+wU3Pm37q7pNClc/9sY7PgrCzLreT2s/ZwU+PlZd/7oCMX8/jlI/PmSqaro9r4k/I9A+PsOW"
    "IbtXp5M/Whw7PqIwt7qVs50/aqE1PhV+J7ufiqc/NksvPlfuK7tzfbE/YJ4lPrC8w7qqWLs/"
    "fj4aPgR3dbmsG8U/QC0MPkJpw7rKz84/FgX8PdxU+Lp/dtg/eNLYPapZ67p4CuI/y/ixPZPg"
    "jrreYus/QYSIPR9VmLqyv/Q/wRszPY46dLm46/0/HSGbPPwgtrqPcwNA5He0uxFaebre9AdA"
    "wWIKvfCJ8bnVWwxA3DKCvaqS4bqRqBBA8WjCvWc1hTgf5BRANdEBvk9QmLoBFBlA9t0lvnyQ"
    "RLtFER1Ah+hNvlmIhTqy/iBAxAFyvpWiYzpX6iRA/POMvmbs3Tm1rChAqeSiviabQbrrTSxA"
    "72K4vuwgr7mX3i9AbXTPvo2ulDh0UjNAQ8rlvjfQnDrGnTZAsFH+vkGzpbrKzTlAbU8Lv9tj"
    "jzmZ7DxACzUYvzCVP7r13z9AQCQlvzSzOrpxvEJAVVcyv+BlgrmXX0VA8Jg/v+MVTbsq/0dA"
    "yXRNv7DSUrtabEpA6lZbv4sPMrqUrUxAja5pvwiWILub305AXYJ4vw9JIruq0lBAnqWDv9ug"
    "B7vphVJAvB+Lv4TWtLrZXVRAK6qSv80+CLv87lVAcIGav8+Cj7qndFdATheiv4eWg7rRilhA"
    "Ct6pvxYwGburqFlAocSxv7IrZ7pKlVpAF625v4ZikroRcVtAeLPBv6Mo8LrqGFxA")

# the tiny monodepth net on render_plane_scene's views: the JAX package's
# TinyMonoDepthModel() (CPU, cv2's blur) at commit 63fd83d, per view
# depth_net_summary: the mean log-depth, then depth and confidence at each
# of DEPTH_NET_PIXELS (row, column); held within DEPTH_NET_RTOL of
# max(1, |value|), as is the port on the card against the port on the CPU
# (relative to each map's maximum)
DEPTH_NET_SCENE = dict(n_views=4, size=192, seed=5)
DEPTH_NET_PIXELS = ((40, 40), (96, 96), (150, 120))
DEPTH_NET = (
    (1.2704993103045525, 3.35367488861084, 0.2630186676979065,
     3.535179853439331, 0.056401923298835754, 3.8286335468292236,
     0.06547069549560547),
    (1.2632031882010653, 3.3030178546905518, 0.7844609618186951,
     3.5238494873046875, 0.08084539324045181, 3.8089818954467773,
     0.08770082890987396),
    (1.257085369977606, 3.2780954837799072, 0.8229672908782959,
     3.512702465057373, 0.09039799869060516, 3.7833428382873535,
     0.10319305211305618),
    (1.2584346097527837, 3.2927560806274414, 0.3497569262981415,
     3.514904022216797, 0.0929693877696991, 3.802901268005371,
     0.0922577753663063))
DEPTH_NET_RTOL = 1e-4

# the settings of the phase-12 solves: phase 4's on scene B, phase 7's on
# scene C (xm2._solve_recover(Q_C, None, True, 5, 1e-1, ..., "mixed"))
PAR_B = dict(max_rank=6, tol=1e-3, precision="mixed", inner_f32=True,
             verbose=False)
PAR_C = dict(max_rank=5, tol=1e-1, lam=0.0, max_time=1000.0,
             precision="mixed", inner_f32=True, edge_tf=True, verbose=False)
PAR_SLOTS = 4          # the single-process mesh's slots
PAR_TRACED_OUTER = 5   # outer iterations of the traced scene C window
PAR_RANK_TIMEOUT = 400  # seconds the two ranks of phase 12 (c) may take

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32 /
# f64 FLOP/s outside the tensor cores, and its L2's size
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
L2_BYTES = 50 * 2**20
F32 = 4  # bytes
# the L2's read rate under every bound_ms: the best that
# ``chip_profile.py --probe`` reached on an H100 80GB HBM3 at 700 W,
# sweeping buffers of 4-40 MB (read again and again, the way launches timed
# again and again read inputs that fit the L2), grids and loads in flight:
# a 40 MB buffer, 264 blocks of 1,024 threads, 8 loads in flight a thread
# (4-32 MB buffers: 7.03-7.40e12).  NVIDIA publishes no L2 rate; this one
# is achieved, not a peak, so a kernel could in principle beat a bound
# made with it
L2_READ_BYTES = 7.601e12
# the chain floor's terms, measured in this run by measure_floors(): the
# latency of one dependent add by item size (ns) and an empty launch's
# device time (ms)
FLOORS = {}
# spin-kernel launches that open every traced window (see traced)
TRACE_PAD = 256


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean ms per call of ``fn`` by CUDA events over ``reps`` back-to-back
    calls, minus the time of ``setup`` alone when given (it runs before every
    call).  Where the host cannot enqueue as fast as the card runs, this is
    the enqueue rate, not the kernel's time: see :func:`device_ms`."""
    import torch

    def run(with_fn):
        for _ in range(3):
            if setup:
                setup()
            if with_fn:
                fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            if setup:
                setup()
            if with_fn:
                fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    base = run(False) if setup else 0.0
    return max(run(True) - base, 0.0)


def traced(fn) -> list:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activities): the
    profiler's raw events, read as they are (building its event tree costs
    the host seconds a traced call).  Once a process has worked the card a
    while, the profiler drops the first device events of every window (on
    an H100 with torch 2.11: none when fresh, 1-4 after 20-50 s of scene
    A's staircases, 87 of 100 by phase 5 of a whole run), never the last:
    so each window opens with ``TRACE_PAD`` launches of ATen's spin
    kernel (``torch.cuda._sleep``), left out of the events returned, and a
    window in which none of them was recorded is taken again with twice as
    many."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = TRACE_PAD
    for _ in range(6):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        ev = prof.profiler.kineto_results.events()
        kept = [e for e in ev if not (e.device_type() == DeviceType.CUDA
                                      and "spin_kernel" in e.name())]
        if len(kept) < len(ev):
            return kept
        pad *= 2
    raise RuntimeError(f"traced: the profiler kept none of the {pad // 2} "
                       f"launches opening its window")


def device_events(ev) -> list:
    """``(name, ns)`` of the device events among :func:`traced`'s."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns()) for e in ev
            if e.device_type() == DeviceType.CUDA]


def device_ms(fn, reps: int, setup=None) -> float:
    """Mean ms per call of the card's own work in ``fn``: the durations of
    the kernels and copies it issues, as ``torch.profiler`` records them
    (:func:`traced`), minus those of ``setup`` alone when given.  Host gaps
    between launches do not count.  ``fn`` and ``setup`` each launch at
    least one kernel or copy a call; a traced run that recorded fewer than
    ``reps`` of them (the profiler now and then drops a whole run's events)
    is taken again, and five such runs in a row raise."""
    import torch

    def calls(with_fn):
        for _ in range(reps):
            if setup:
                setup()
            if with_fn:
                fn()

    def busy_ns(with_fn):
        for _ in range(5):
            for _ in range(3):
                if setup:
                    setup()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
            ev = device_events(traced(lambda: calls(with_fn)))
            if len(ev) >= reps:
                return sum(ns for _, ns in ev)
        raise RuntimeError(f"device_ms: the profiler recorded {len(ev)} "
                           f"device events over {reps} calls, five times")

    base = busy_ns(False) if setup else 0.0
    return max(busy_ns(True) - base, 0.0) / reps / 1e6


def launch_ms(fn, reps: int, tries: int = 5) -> float:
    """Mean device ms of the one kernel that each call of ``fn`` launches,
    over ``reps`` calls under ``torch.profiler`` (:func:`traced`): the mean
    of the launches it recorded.  The profiler drops launches at times (3 of
    50 in one process, 34 of 50 after the tail's traced calls in another),
    and a mean over the launches it kept is a mean over identical launches;
    a traced run that recorded none is taken again, ``tries`` times.  More
    than one kernel a call raises."""
    import torch

    for _ in range(tries):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [ns for n, ns in device_events(traced(
            lambda: [fn() for _ in range(reps)]))
              if not n.startswith(("Memcpy", "Memset"))]
        if len(ev) > reps:
            raise RuntimeError(f"launch_ms: {len(ev)} kernels recorded over "
                               f"{reps} calls of one kernel each")
        if ev:
            return sum(ev) / len(ev) / 1e6
    raise RuntimeError(f"launch_ms: no kernel recorded, {tries} times")


def kernel_mean_ms(fn, name: str):
    """Runs ``fn`` once under ``torch.profiler`` (:func:`traced`): the mean
    device ms of the kernels whose name holds ``name``, and their count."""
    ev = [ns for n, ns in device_events(traced(fn)) if name in n]
    if not ev:
        raise RuntimeError(f"kernel_mean_ms: no device event named {name}")
    return sum(ev) / len(ev) / 1e6, len(ev)


def f32_phase_inputs(q, R, s_ex, outer: int = 0, lam=0.0):
    """Real inputs of ``fused_tcg.inner_tcg_fused`` on the f32 operator
    ``q``: the mixed ladder's f32 phase started at (R, s_ex) is run for
    ``outer`` outer iterations, and its next outer iteration's tCG arguments
    are computed as ``_outer_step`` does (``outer=0``: the phase's first
    outer iteration)."""
    import torch

    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.solver import trust_region as tr

    f32 = torch.float32
    n, _, o = R.shape
    cfg32, gradtol32 = tr.TRConfig().f32_ladder(1e-6)
    delta_bar = np.float32(np.sqrt(float(n * (3 * o - 6) + n - 1)))
    st = tr._init_state(q, R.to(f32), s_ex.to(f32), np.float32(lam),
                        delta_bar, cfg32)
    st = tr._run_chunk(q, st, lam, gradtol32, delta_bar, cfg32, outer)
    R, s_ex = st.R, st.s_ex
    egR, egs, CsR = mf.egrad_csr(q.apply, R, s_ex, lam)
    pgR, pgs = mf.project(R, s_ex[1:], egR, egs)
    gradnorm = np.float32(torch.sqrt(
        mf.inner(pgR, pgR, pgs, pgs, s_ex[1:])).item())
    minv = tr._build_minv(q.diag_blocks(), s_ex, np.float32(lam))
    return dict(qmul=q.apply, R=R, s_ex=s_ex, CsR=CsR, egR=egR, egs=egs,
                pgR=pgR, pgs=pgs, gradnorm=gradnorm, delta=st.delta,
                lam=np.float32(lam), cfg=cfg32, minv=minv)


def step_bytes_ops(n: int, o: int):
    """Bytes one tcg_step must move (inputs read once, outputs written
    once) and the f32 operations it does, from the kernel's arithmetic."""
    blk, row = 3 * o * n, n
    reads = 3 * blk + 5 * row + 2 * 9 * n + 8 + 4      # const arrays, sc, cfg
    state = 4 * blk + 4 * row                           # read and written
    nbytes = F32 * (reads + 2 * state + 8)
    ops = n * (183 * o + 40)
    return nbytes, ops


def cw_bytes_ops(n: int, o: int):
    """The dense variant's product alone: C, W's inputs, CW out."""
    m = 3 * n
    nbytes = F32 * (m * m + 2 * 3 * o * n + 2 * n + 8 + 3 * o * n)
    ops = 2 * m * m * o + 3 * 3 * o * n
    return nbytes, ops


def dense_bytes_ops(n: int, o: int):
    """One ``tcg_step_dense``: ``tcg_step``'s bytes with C read once more
    (W's inputs are already among them, CWt now written instead of read),
    and both operation counts."""
    m = 3 * n
    sb, so = step_bytes_ops(n, o)
    cb, co = cw_bytes_ops(n, o)
    return sb + F32 * m * m, so + co


def bound_ms(nbytes, ops, peak_ops=PEAK_F32):
    """The least time of a launch that moves ``nbytes`` and does ``ops``:
    ``(ms, "bytes" or "operations", basis)``.  Launches timed again and
    again find up to ``L2_BYTES`` of their inputs in L2, so the bytes are
    bounded by the L2's read rate and, past ``L2_BYTES``, by device memory:
    basis ``"L2"`` (everything fits) or ``"L2 + HBM"``."""
    tb = max(nbytes / L2_READ_BYTES,
             max(nbytes - L2_BYTES, 0) / PEAK_BYTES) * 1e3
    to = ops / peak_ops * 1e3
    basis = "L2" if nbytes <= L2_BYTES else "L2 + HBM"
    return max(tb, to), ("bytes" if tb >= to else "operations"), basis


def chain_floor_ms(longest: int, item: int):
    """The floor of a segment sum that adds each segment's rows in row
    order: its longest segment's chain of dependent adds, plus an empty
    launch, at this run's :data:`FLOORS` (None where this process did not
    measure them: ``chip_profile.py``'s kernel times)."""
    if not FLOORS:
        return None
    return (longest * FLOORS["t_add_ns"][item] * 1e-6
            + FLOORS["launch_floor_ms"])


def probe_lib():
    """``csrc/probe.cu``'s library (built with the package's kernels), its
    functions typed."""
    import ctypes

    from xmtpu_torch import _build

    lib = _build.load("probe")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.xm_probe_add_chain.argtypes = [I, I, P, P]
    lib.xm_probe_add_chain.restype = I
    lib.xm_probe_read.argtypes = [P, ctypes.c_longlong] + [I] * 4 + [P, P]
    lib.xm_probe_read.restype = I
    return lib


def launched(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def measure_floors(dev) -> dict:
    """Fills :data:`FLOORS`: the latency of one dependent f32 and f64 add
    (``probe.cu``'s one-thread chain of n adds, device time at two n) and
    the device time of an empty launch of one 128-thread block
    (``segsum.cu``'s floor kernel)."""
    import torch

    from xmtpu_torch.ops import segsum as ss

    lib, seg = probe_lib(), ss._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(4, dtype=torch.float64, device=dev)
    n1, n2 = 1 << 16, 1 << 18
    t_add = {}
    for item in (4, 8):
        ms = [device_ms(lambda n=n: launched(lib.xm_probe_add_chain(
            item, n, out.data_ptr(), stream), "add chain"), 20)
            for n in (n1, n2)]
        t_add[item] = (ms[1] - ms[0]) / (n2 - n1) * 1e6
    floor = device_ms(lambda: launched(seg.xm_segsum_floor(
        1, 128, 0, stream), "empty launch"), 100)
    FLOORS.update(t_add_ns=t_add, launch_floor_ms=floor)
    return FLOORS


def assert_close(name, got, want, atol, rtol):
    """Fails unless ``|got - want| <= atol + rtol |want|`` everywhere;
    returns the largest error, absolute and relative to ``max |want|``."""
    import torch

    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    bad = int((err > lim).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {bad} entries beyond atol={atol:.2e} rtol={rtol:.0e} "
            f"(max err {float(err.max()):.3e})")
    return float(err.max()), float(err.max()) / max(float(want.abs().max()),
                                                    1e-30)


def worst(errs):
    """(largest absolute, largest relative) of ``assert_close`` results."""
    return max(e[0] for e in errs), max(e[1] for e in errs)


def f64_loop(q, inp):
    """The Steihaug loop of ``inp`` in float64 through the generic path, on
    the f64 operator ``q``: ``(vR, vs, hvR, hvs, endreason, iters)``."""
    import torch

    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.solver import trust_region as tr

    R, s_ex = inp["R"].double(), inp["s_ex"].double()
    lam = float(inp["lam"])
    egR, egs, CsR = mf.egrad_csr(q.apply, R, s_ex, lam)
    pgR, pgs = mf.project(R, s_ex[1:], egR, egs)
    minv = tr._build_minv(q.diag_blocks(), s_ex, np.float64(lam))
    gradnorm = float(torch.sqrt(mf.inner(pgR, pgR, pgs, pgs, s_ex[1:])))
    return tr._inner_tcg(q.apply, R, s_ex, CsR, egR, egs, pgR, pgs, gradnorm,
                         float(inp["delta"]), np.float64(lam), inp["cfg"],
                         minv=minv)


def rel_gap(a, b) -> float:
    """Largest gap between the arrays of two loop results, each relative to
    the largest entry of its array in ``b``."""
    return max(float((x.double() - y.double()).abs().max())
               / max(1e-3, float(y.abs().max())) for x, y in zip(a[:4], b[:4]))


def step_inputs(inp):
    """``fused_tcg.prepare`` on ``inp``, with ``CWt`` holding the split
    variant's product for the first iteration: ``(args, const, state, sc,
    cfgsc)``."""
    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf

    n, _, o = inp["R"].shape
    args = {k: inp[k] for k in ("R", "s_ex", "CsR", "egR", "egs", "pgR",
                                 "pgs", "gradnorm", "delta", "lam", "cfg",
                                 "minv")}
    const, state, sc, cfgsc = ft.prepare(**args)
    Wf = mf.flatten(ft.from_t(state[4] * const["s_ex_t"]
                                 + const["Rt"] * state[5], n, o))
    const["CWt"].copy_(ft.to_t(mf.unflatten(2.0 * inp["qmul"](Wf))))
    return args, const, state, sc, cfgsc


def time_step(const, state, sc, cfgsc, max_inner: int, reps: int = 200,
              C32=None):
    """Device ms per ``tcg_step`` launch (profiler durations; with ``C32``,
    per ``tcg_step_dense`` launch) on clones of the inputs, the carry reset
    to ``sc`` before every launch so that none returns early."""
    from xmtpu_torch.ops import fused_tcg as ft

    ck = [v.clone() for v in const.values()]
    sk = [t.clone() for t in state]
    sck = sc.clone()
    if C32 is None:
        step = lambda: ft.tcg_step(*ck, *sk, sck, cfgsc, max_inner)  # noqa: E731
    else:
        step = lambda: ft.tcg_step_dense(C32, *ck, *sk, sck, cfgsc,  # noqa: E731
                                         max_inner)
    return device_ms(step, reps, setup=lambda: sck.copy_(sc))


def geometry_text(blocks: int, threads: int) -> str:
    return (f"{blocks} block{'s' * (blocks > 1)} "
            f"({'a cluster' if blocks > 1 else 'no cluster'}) x {threads} "
            f"threads")


def hold_kernels(q64, inp, tag, dense: bool):
    """One iteration and a whole Steihaug loop: kernel vs plain on the card
    (``dense``: ``tcg_step_dense``, the product inside; else ``tcg_step``
    with the split product); ``q64`` is the f64 operator of the reference
    loop.  Returns the max errors, the timings and the launch geometry of
    this case."""
    import torch

    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf

    R = inp["R"]
    n, _, o = R.shape
    max_inner = int(inp["cfg"].max_inner)
    args, const, state, sc, cfgsc = step_inputs(inp)
    C32 = ft.dense_matrix(inp["qmul"], n) if dense else None
    out = {"geometry": geometry_text(*(ft.dense_geometry(n, o) if dense
                                       else ft.step_geometry(n, o))),
           "step_geometry": geometry_text(*ft.step_geometry(n, o))}

    # --- one iteration --------------------------------------------------
    def clone_all():
        c = {k: v.clone() for k, v in const.items()}
        return c, tuple(t.clone() for t in state), sc.clone()

    def launch(c, st, s_):
        if dense:
            ft.tcg_step_dense(C32, *c.values(), *st, s_, cfgsc, max_inner)
        else:
            ft.tcg_step(*c.values(), *st, s_, cfgsc, max_inner)

    ck, sk, sck = clone_all()
    cp, sp, scp = clone_all()
    cr, sr, scr = clone_all()
    launch(ck, sk, sck)
    launch(cr, sr, scr)
    if dense:
        ft.tcg_step_dense_plain(C32, *cp.values(), *sp, scp, cfgsc, max_inner)
    else:
        ft.tcg_step_plain(*cp.values(), *sp, scp, cfgsc, max_inner)
    torch.cuda.synchronize()
    name = "tcg_step_dense" if dense else "tcg_step"
    if not all(torch.equal(a, b) for a, b in zip((ck["CWt"], *sk, sck),
                                                 (cr["CWt"], *sr, scr))):
        raise AssertionError(f"{tag} {name}: two launches on the same "
                             f"inputs differ")
    if dense:
        scale = max(1e-3, float(cp["CWt"].abs().max()))
        out["cw_err"] = assert_close(f"{tag} {name} CW", ck["CWt"],
                                     cp["CWt"], 5e-4 * scale, 5e-3)
    sc_k, sc_p = sck.tolist(), scp.tolist()
    if [sc_k[i] for i in (ft.S_ER, ft.S_DONE, ft.S_I)] != \
            [sc_p[i] for i in (ft.S_ER, ft.S_DONE, ft.S_I)]:
        raise AssertionError(f"{tag} {name} carry: kernel {sc_k} vs "
                             f"plain {sc_p}")
    # the step v (and its scale part) at the v tolerance, everything derived
    # from the Hessian product at the Hv tolerance
    errs = [assert_close(f"{tag} {name} carry", sck[:ft.S_ER],
                         scp[:ft.S_ER], 0.0, 5e-3)]
    names = ("vR", "vs", "rR", "rs", "pR", "ps", "hvR", "hvs")
    for nm, a, b in zip(names, sk, sp):
        at, rt = (2e-4, 2e-3) if nm in ("vR", "vs") else (5e-4, 5e-3)
        scale = max(1e-3, float(b.abs().max()))
        errs.append(assert_close(f"{tag} {name} {nm}", a, b, at * scale, rt))
    out["step_err"] = worst(errs)

    # --- the whole Steihaug loop -----------------------------------------
    res_k = ft.inner_tcg_fused(inp["qmul"], **args)

    def plain_loop(gen=None):
        """The loop through the plain versions; with ``gen``, every product
        is perturbed by a fresh relative f32 rounding (another summation
        order's worth of noise)."""
        cp, sp, scp = {k: v.clone() for k, v in const.items()}, \
            tuple(t.clone() for t in state), sc.clone()
        for _ in range(max_inner):
            if dense:
                ft.tcg_cw_dense_plain(C32, cp["Rt"], cp["s_ex_t"], sp[4],
                                      sp[5], scp, cp["CWt"], max_inner)
            else:
                Wf = mf.flatten(ft.from_t(sp[4] * cp["s_ex_t"]
                                             + cp["Rt"] * sp[5], n, o))
                cp["CWt"].copy_(ft.to_t(mf.unflatten(2.0 * inp["qmul"](Wf))))
            if gen is not None:
                u = torch.rand(cp["CWt"].shape, generator=gen) * 2.0 - 1.0
                cp["CWt"].mul_(1.0 + 2.0 ** -24 * u.to(cp["CWt"].device))
            ft.tcg_step_plain(*cp.values(), *sp, scp, cfgsc, max_inner)
            if ft._stopped(scp, max_inner):
                break
        car = scp.tolist()
        return (ft.from_t(sp[0], n, o), ft.unpack_s(sp[1], n),
                ft.from_t(sp[6], n, o), ft.unpack_s(sp[7], n),
                int(car[ft.S_ER]), int(car[ft.S_I]))

    res_p = plain_loop()
    # How far f32 rounding alone moves this loop: the plain loop against the
    # same loop in f64.  Where that is within the f32 tolerance (a
    # well-separated problem) the kernel must match the plain version to the
    # tolerance, end reason and iteration count included.  Where it is not
    # (near a saddle, every f32 summation order ends elsewhere), the kernel
    # must be no further from the f64 loop than twice the f32 noise band:
    # the largest gap of the plain version, as it runs and under three
    # seeded f32-rounding perturbations of its products (one sample of that
    # band ranged over 1.4e-2-5.4e-2 at scene A's escape point across runs).
    res_64 = f64_loop(q64, inp)
    d64 = rel_gap(res_p, res_64)
    out["loop"], out["loop_f64_gap"] = (res_k[4], res_k[5]), d64
    if d64 <= 2e-3 and res_p[4:] == res_64[4:]:
        if res_k[4:] != res_p[4:]:
            raise AssertionError(f"{tag} Steihaug loop: kernel endreason/"
                                 f"iters {res_k[4:]} vs plain {res_p[4:]}")
        scale = max(1e-3, float(res_p[0].abs().max()))
        hscale = max(1e-3, float(res_p[2].abs().max()))
        out["loop_err"] = worst([
            assert_close(f"{tag} loop vR", res_k[0], res_p[0], 2e-4 * scale,
                         2e-3),
            assert_close(f"{tag} loop vs", res_k[1], res_p[1], 2e-4, 2e-3),
            assert_close(f"{tag} loop hvR", res_k[2], res_p[2],
                         5e-4 * hscale, 5e-3),
            assert_close(f"{tag} loop hvs", res_k[3], res_p[3], 5e-4, 5e-3)])
    else:
        band = [d64] + [rel_gap(plain_loop(torch.Generator().manual_seed(k)),
                                res_64) for k in range(3)]
        out["loop_f64_gap"] = max(band)
        dk = rel_gap(res_k, res_64)
        if not dk <= 2.0 * max(band) + 2e-3:
            raise AssertionError(f"{tag} Steihaug loop: kernel {dk:.3e} from "
                                 f"the f64 loop, plain "
                                 f"{', '.join(f'{b:.3e}' for b in band)}")
        out["loop_err"] = (max(float((a - b).abs().max())
                               for a, b in zip(res_k[:4], res_p[:4])),
                           rel_gap(res_k, res_p))

    # --- timings -----------------------------------------------------------
    reps = 200
    out["step_ms"] = time_step(const, state, sc, cfgsc, max_inner, reps)
    out["step_bound"] = bound_ms(*step_bytes_ops(n, o))
    ck, sk, sck = clone_all()
    reset = lambda: sck.copy_(sc)  # noqa: E731 — a live carry every launch
    if dense:
        out["dense_ms"] = time_step(const, state, sc, cfgsc, max_inner, reps,
                                    C32=C32)
        out["dense_enqueue_ms"] = cuda_ms(lambda: launch(ck, sk, sck), reps,
                                          setup=reset)
        ck, sk, sck = clone_all()
        out["dense_plain_ms"] = cuda_ms(lambda: ft.tcg_step_dense_plain(
            C32, *ck.values(), *sk, sck, cfgsc, max_inner), 20, setup=reset)
        out["dense_bound"] = bound_ms(*dense_bytes_ops(n, o))
        # the library yardstick: the product alone, on this call's W
        Wf = mf.flatten(ft.from_t(sk[4] * ck["s_ex_t"] + ck["Rt"] * sk[5],
                                  n, o)).contiguous()
        out["cw_library_ms"] = device_ms(lambda: torch.matmul(C32, Wf),
                                         reps)
    else:
        out["step_enqueue_ms"] = cuda_ms(lambda: launch(ck, sk, sck), reps,
                                         setup=reset)
        ck, sk, sck = clone_all()
        out["step_plain_ms"] = cuda_ms(lambda: ft.tcg_step_plain(
            *ck.values(), *sk, sck, cfgsc, max_inner), 20, setup=reset)
    return out


def hold_case(tag, q64, inp, dense: bool) -> dict:
    """:func:`hold_kernels` on one case, logged."""
    r = hold_kernels(q64, inp, tag, dense)
    msg = (f"[smoke] {tag}: {r['geometry']}; step err {r['step_err'][1]:.1e} "
           f"(two launches: same bits) loop (endreason, iters)={r['loop']} "
           f"err {r['loop_err'][1]:.1e} (f32 noise band vs f64 loop "
           f"{r['loop_f64_gap']:.1e}); ")
    if dense:
        msg += (f"tcg_step_dense CW err {r['cw_err'][1]:.1e}, "
                f"{r['dense_ms']:.4f} ms (enqueue {r['dense_enqueue_ms']:.4f})"
                f" plain {r['dense_plain_ms']:.4f} ms bound "
                f"{r['dense_bound'][0]:.5f}; yardsticks: matmul "
                f"{r['cw_library_ms']:.4f} ms, tcg_step alone "
                f"{r['step_ms']:.4f} ms ({r['step_geometry']}, bound "
                f"{r['step_bound'][0]:.5f})")
    else:
        msg += (f"tcg_step {r['step_ms']:.4f} ms (enqueue "
                f"{r['step_enqueue_ms']:.4f}) plain {r['step_plain_ms']:.4f} "
                f"ms bound {r['step_bound'][0]:.5f}")
    log(msg)
    return r


def segsum_bytes_ops(rows: int, S: int, D: int, item: int, idx_words: int):
    """Bytes a segment sum must move (values and ``idx_words`` int32 index
    words read once, the (S, D) output written once) and its adds."""
    return rows * D * item + idx_words * 4 + S * D * item, rows * D


# the segment sums' times under the earlier design, one thread an output
# for every segment (ms a launch, H100 80GB HBM3 at 700 W: scene C's f32
# D=3 sums by chip_profile.py --kernels, the tail's and the refine's f64
# layouts by chip_smoke.py), printed beside this run's
PREV_SEGSUM_MS = {"csr l float32 D=3": 0.0027, "csr f float32 D=3": 0.0026}
PREV_TAIL_MS = {
    "BATA dst D=3": 0.0040, "BATA src D=3": 0.0696, "BA image D=6": 0.0641,
    "BA image D=12": 0.0614, "BA image D=36": 0.1331, "BA track D=3": 0.0041,
    "BA track D=9": 0.0050, "BA camera D=6": 0.0058, "BA camera D=36": 0.0059,
    "tri track D=1": 0.0041, "tri track D=16": 0.0087,
    "refine frame D=6": 0.0253, "refine landmark D=3": 0.0035}
# the tail's and the refine's Segments layouts by name, with the widths
# the kernel is held at on each (every f64 width the main path sums)
TAIL_LAYOUTS = {"BATA dst": (3,), "BATA src": (3,), "BA image": (6, 12, 36),
                "BA track": (3, 9), "BA camera": (6, 36),
                "tri track": (1, 16)}
REFINE_LAYOUTS = {"refine frame": (6,), "refine landmark": (3,)}


def launched_layouts(run: dict, layouts: dict, what: str) -> None:
    """Fails unless the run launched the segment sum on every named
    layout (``sorted_segment_sum layouts`` keys ``"<name> f64 D=<D>"``)."""
    seen = {k.rsplit(" ", 2)[0] for k, v in run[
        "sorted_segment_sum layouts"].items() if v > 0}
    if not set(layouts) <= seen:
        raise AssertionError(f"{what}: no segment sum on "
                             f"{sorted(set(layouts) - seen)}")


def hold_segsum(Q, dev, reps: int = 100):
    """Both segment-sum kernels against their plain twin on the card, on the
    operator's real orderings.  Returns one dict per case."""
    import torch

    from xmtpu_torch.ops import segsum as ss

    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    E = int(Q.l_l.shape[0])
    sched = ss.schedule_edges(Q.l_l.cpu().numpy().astype(np.int32),
                              Q.n_landmarks)
    ids_s, gidx, pad, blk, first, band = sched
    ids_s = torch.as_tensor(ids_s, device=dev)
    gidx = torch.as_tensor(gidx, device=dev)
    live = torch.as_tensor(~pad, device=dev)
    G = len(blk)
    cases = []
    for order, ids, off, S in (("l", Q.l_l, Q.bounds_l, Q.n_landmarks),
                               ("f", Q.f_f, Q.bounds_f, Q.n_cameras)):
        longest = int((off[1:] - off[:-1]).max())
        for dt in (torch.float32, torch.float64):
            eps = float(torch.finfo(dt).eps)
            item = torch.finfo(dt).bits // 8
            peak = PEAK_F32 if dt == torch.float32 else PEAK_F64
            for D in (3, 6, 9, 18):
                vals = torch.randn((E, D), generator=gen,
                                   dtype=torch.float64).to(dt).to(dev)
                # both versions sum each segment in some order: each lies
                # within (L-1) eps sum|x| of the exact sum, L the longest
                # segment
                absum = ss.sorted_segment_sum_plain(vals.abs(), ids, S)
                tol = 2.0 * longest * eps * absum
                scale = float(absum.max())
                runs = [("csr", lambda: ss.sorted_segment_sum(
                            vals, ids, S, offsets=off),
                         ss.sorted_segment_sum_plain(vals, ids, S),
                         segsum_bytes_ops(E, S, D, item, S + 1))]
                if order == "l":
                    vs = (vals[gidx] * live[:, None]).contiguous()
                    runs.append(("blocked", lambda: ss.sorted_segment_sum_blocked(
                        vs, ids_s, S, blk, first, band),
                        ss.sorted_segment_sum_plain(vs, ids_s, S),
                        segsum_bytes_ops(G * ss.CHUNK, S, D, item,
                                         G * ss.CHUNK + G)))
                for kind, call, want, (nbytes, ops) in runs:
                    a, b = call(), call()
                    torch.cuda.synchronize()
                    tag = f"{kind} {order} {str(dt)[6:]} D={D}"
                    if not torch.equal(a, b):
                        raise AssertionError(f"segsum {tag}: two launches "
                                             f"differ")
                    # the CSR kernel adds in row order from zero, as the
                    # CPU twin does: the same bits
                    if kind == "csr" and not torch.equal(
                            a.cpu(), ss.sorted_segment_sum_plain(
                                vals.cpu(), ids.cpu(), S)):
                        raise AssertionError(f"segsum {tag}: not the CPU "
                                             f"twin's bits")
                    err = (a - want).abs()
                    if bool((err > tol).any()) or not bool(
                            torch.isfinite(a).all()):
                        raise AssertionError(
                            f"segsum {tag}: {int((err > tol).sum())} entries "
                            f"beyond 2 L eps sum|x| (max err "
                            f"{float(err.max()):.3e})")
                    src = vals if kind == "csr" else vs
                    sid = ids if kind == "csr" else ids_s
                    out = torch.zeros_like(want)
                    cases.append(dict(
                        kernel=kind, tag=tag, order=order, D=D,
                        dtype=str(dt)[6:], max_abs_err=float(err.max()),
                        max_rel_err=float(err.max()) / max(scale, 1e-30),
                        ms=device_ms(call, reps),
                        plain_ms=cuda_ms(lambda: ss.sorted_segment_sum_plain(
                            src, sid, S), reps),
                        library_ms=device_ms(
                            lambda: out.index_add_(0, sid, src), reps),
                        bound=bound_ms(nbytes, ops, peak),
                        chain_floor=chain_floor_ms(longest, item),
                        prev_ms=PREV_SEGSUM_MS.get(tag)))
    return cases


def rotation_error_stats(R_real, R_gt, indices_all=None):
    """Max and mean angular error (radians) of recovered c2w rotation blocks
    ``R_real (3, 3N)`` against the scene's ``R_gt``, gauge-fixed to camera
    0; ``indices_all`` maps original frames to the cleaned ones."""
    from xmtpu_torch.pipeline.synthetic import rotation_errors

    N = R_real.shape[1] // 3
    B = R_real.reshape(3, N, 3).transpose(1, 0, 2)
    gt = R_gt
    if indices_all is not None:
        gt = np.zeros((N, 3, 3))
        live = indices_all > -1
        gt[indices_all[live]] = R_gt[live]
    e = rotation_errors(B, gt, gauge="left")
    return dict(max=float(e.max()), mean=float(e.mean()))


def check_rotations(tag, got, ref):
    for k in ("max", "mean"):
        if not got[k] <= ROT_SLACK * ref[k]:
            raise AssertionError(f"{tag}: rotation error {k} {got[k]:.3e} "
                                 f"beyond {ROT_SLACK} x the reference's "
                                 f"{ref[k]:.3e}")


def counted_kernels():
    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import segsum as ss
    from xmtpu_torch.ops.schurq import schurq_product

    return (ft.tcg_step, ft.tcg_step_dense, ss.sorted_segment_sum,
            ss.sorted_segment_sum_blocked, schurq_product)


def reset_counts():
    from xmtpu_torch.ops import segsum as ss

    for k in counted_kernels():
        k.launches = 0
    ss.sorted_segment_sum.shapes = {}
    ss.sorted_segment_sum.layouts = {}


def read_counts() -> dict:
    """Launches by kernel, and the segment sum's by dtype and D and by
    layout."""
    from xmtpu_torch.ops import segsum as ss

    out = {k.__name__: k.launches for k in counted_kernels()}
    out["sorted_segment_sum shapes"] = dict(ss.sorted_segment_sum.shapes)
    out["sorted_segment_sum layouts"] = dict(ss.sorted_segment_sum.layouts)
    return out


def hold_carried_operator(scB, dev) -> dict:
    """Scene B's ``SchurQ`` built on the host, moved to the card by
    ``as_qop``: each variant's apply must launch the segment-sum kernel (the
    f32 cast: the fused product's kernels, ``schurq_product``), give
    the same bits twice, and lie no further from the exact host apply than
    twice the same variant's host apply does (1e-9 for the exact operator;
    the f32 variants sit at their f32-accumulation floor, ~6e-6 here).
    Returns ``(card, host)`` relative distances from the exact apply by
    variant."""
    import torch

    from xmtpu_torch.ops import segsum as ss
    from xmtpu_torch.ops.qop import as_qop, cast_qop
    from xmtpu_torch.ops.schurq import SchurQ, schurq_product

    q_host = SchurQ.build(scB.weights, scB.edges, scB.landmarks, device="cpu")
    q_card = as_qop(q_host, device=dev)
    gen = torch.Generator().manual_seed(0)
    Y = torch.randn((q_host.dim, 3), generator=gen, dtype=torch.float64)
    exact = q_host.apply(Y)

    def rel(a):
        return float(torch.linalg.norm(a.cpu().double() - exact)
                     / torch.linalg.norm(exact))

    out = {}
    for tag, make in (("SchurQ", lambda q: q),
                      ("f32 cast", lambda q: cast_qop(q, torch.float32)),
                      ("two_float", lambda q: q.two_float())):
        qh, qc = make(q_host), make(q_card)
        y = Y.to(qh.Q1.dtype)
        n0, f0 = ss.sorted_segment_sum.launches, schurq_product.launches
        a, b = qc.apply(y.to(dev)), qc.apply(y.to(dev))
        torch.cuda.synchronize()
        launched = (schurq_product.launches == f0 + 2 if tag == "f32 cast"
                    else ss.sorted_segment_sum.launches >= n0 + 8)
        if not launched or not torch.equal(a, b):
            raise AssertionError(f"carried {tag}: launches "
                                 f"{ss.sorted_segment_sum.launches - n0} "
                                 f"segment sums, "
                                 f"{schurq_product.launches - f0} fused, "
                                 f"repeatable {torch.equal(a, b)}")
        d_card, d_host = rel(a), rel(qh.apply(y))
        if not d_card <= 2.0 * d_host + 1e-9:
            raise AssertionError(f"carried {tag}: {d_card:.2e} from the "
                                 f"exact apply, host {d_host:.2e}")
        out[tag] = (d_card, d_host)
    return out


def assemble(weights, edges, landmarks, device, precision="f64"):
    """``create_matrix_arrays`` on ``device``, synchronised: ``(C, Abar,
    seconds, launches)``, the ``sorted_segment_sum`` launches it made by
    layout (its frame and landmark sums)."""
    import torch

    from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
    from xmtpu_torch.ops import segsum as ss

    before = dict(ss.sorted_segment_sum.layouts)
    t0 = time.perf_counter()
    C, Abar = create_matrix_arrays(weights, edges, landmarks,
                                   precision=precision, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return C, Abar, secs, {k: v - before.get(k, 0) for k, v
                           in ss.sorted_segment_sum.layouts.items()
                           if v != before.get(k, 0)}


def scene(params, device):
    """``make_scene(**params)`` and its dense assembly on ``device``: ``(C,
    make_scene seconds, assembly seconds, the assembly's launches by
    layout, the scene)``."""
    from xmtpu_torch.pipeline.synthetic import make_scene

    t0 = time.perf_counter()
    sc = make_scene(**params)
    t_gen = time.perf_counter() - t0
    C, _, t_asm, launches = assemble(sc.weights, sc.edges, sc.landmarks,
                                     device)
    return C, t_gen, t_asm, launches, sc


class SceneD(NamedTuple):
    R: np.ndarray            # (N, 3, 3) world-to-camera rotations
    t: np.ndarray            # (N, 3) world-to-camera translations
    pts: np.ndarray          # (M, 3) room points
    K: np.ndarray            # (3, 3)
    keypoints: list          # N arrays (k_i, 2), f32-representable pixels
    point_of_kp: list        # N arrays (k_i,) point id of each keypoint
    pairs: np.ndarray        # (P, 2) frame pairs i < j, sorted
    matches: list            # P arrays (K_p, 2) keypoint indices
    E: np.ndarray            # (P, 3, 3) stored essential matrices
    corrupted: np.ndarray    # (P,) bool: E from a corrupted rotation


def _rotvec(w):
    """Rodrigues of one rotation vector (numpy)."""
    th = float(np.linalg.norm(w))
    if th == 0.0:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * Kx + (1.0 - np.cos(th)) * Kx @ Kx


def make_scene_d(n_frames: int = 200, n_points: int = 8000,
                 seed: int = 0) -> SceneD:
    """Scene D (numpy only, seeded): ``n_frames`` on a closed elliptic loop
    heading along it with a yaw sway, ``n_points`` spread over the walls,
    floor and ceiling of the room by area, the Replica camera, keypoints
    with ``SCENE_D_PIXEL_NOISE`` px of noise, and for every pair sharing at
    least ``SCENE_D_MIN_SHARED`` points a ``CALIBRATED`` two-view geometry
    whose E comes from the GT relative pose, or for a seeded
    ``SCENE_D_BAD`` share of them from that rotation turned by 20-40
    degrees."""
    from xmtpu_torch.pipeline.viewgraph import essential_from_motion

    rng = np.random.default_rng(seed)
    lp, cam = SCENE_D_LOOP, SCENE_D_CAMERA
    W, H = cam["width"], cam["height"]
    K = np.array([[cam["f"], 0.0, cam["cx"]], [0.0, cam["f"], cam["cy"]],
                  [0.0, 0.0, 1.0]])

    a = 2.0 * np.pi * np.arange(n_frames) / n_frames
    centers = np.stack([lp["rx"] * np.cos(a), lp["ry"] * np.sin(a),
                        np.full(n_frames, lp["height"])], axis=1)
    yaw = (np.arctan2(lp["ry"] * np.cos(a), -lp["rx"] * np.sin(a))
           + lp["sway"] * np.sin(lp["sway_cycles"] * a))
    fwd = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n_frames)], axis=1)
    down = np.broadcast_to([0.0, 0.0, -1.0], fwd.shape)
    R = np.stack([np.cross(down, fwd), down, fwd], axis=1)
    t = -np.einsum("nab,nb->na", R, centers)

    # room surfaces, picked by area: floor, ceiling, walls x = +-X/2,
    # walls y = +-Y/2
    X, Y, Z = SCENE_D_ROOM
    areas = np.array([X * Y, X * Y, Y * Z, Y * Z, X * Z, X * Z])
    face = rng.choice(6, size=n_points, p=areas / areas.sum())
    u = rng.random((n_points, 2))
    lo, ext = np.array([-X / 2, -Y / 2, 0.0]), np.array([X, Y, Z])
    pts = np.zeros((n_points, 3))
    for k, (fixed, val, free) in enumerate(
            [(2, 0.0, (0, 1)), (2, Z, (0, 1)), (0, -X / 2, (1, 2)),
             (0, X / 2, (1, 2)), (1, -Y / 2, (0, 2)), (1, Y / 2, (0, 2))]):
        sel = face == k
        pts[sel, fixed] = val
        for c, f in enumerate(free):
            pts[sel, f] = lo[f] + ext[f] * u[sel, c]

    keypoints, point_of_kp = [], []
    kp_of_point = np.full((n_frames, n_points), -1, dtype=np.int64)
    for i in range(n_frames):
        pc = pts @ R[i].T + t[i]
        front = pc[:, 2] > 0.1
        uv = (pc[:, :2] / np.where(front, pc[:, 2], 1.0)[:, None]
              * cam["f"] + [cam["cx"], cam["cy"]])
        uv = uv + rng.normal(scale=SCENE_D_PIXEL_NOISE, size=uv.shape)
        # the database keeps f32 keypoints: hold them so from the start
        uv = uv.astype(np.float32).astype(np.float64)
        ok = (front & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0)
              & (uv[:, 1] < H))
        ids = np.flatnonzero(ok)
        keypoints.append(uv[ids])
        point_of_kp.append(ids)
        kp_of_point[i, ids] = np.arange(len(ids))

    vis = (kp_of_point >= 0).astype(np.float32)
    shared = vis @ vis.T
    ii, jj = np.triu_indices(n_frames, k=1)
    keep = shared[ii, jj] >= SCENE_D_MIN_SHARED
    pairs = np.stack([ii[keep], jj[keep]], axis=1)
    P = len(pairs)
    bad = np.zeros(P, dtype=bool)
    bad[rng.choice(P, size=int(round(SCENE_D_BAD["share"] * P)),
                   replace=False)] = True
    lo_deg, hi_deg = SCENE_D_BAD["deg"]
    matches, E = [], np.zeros((P, 3, 3))
    for p, (i, j) in enumerate(pairs):
        common = np.flatnonzero((kp_of_point[i] >= 0) & (kp_of_point[j] >= 0))
        matches.append(np.stack([kp_of_point[i, common],
                                 kp_of_point[j, common]], axis=1))
        Rij = R[j] @ R[i].T                          # cam2_from_cam1
        tij = t[j] - Rij @ t[i]
        if bad[p]:
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            Rij = _rotvec(axis * np.radians(rng.uniform(lo_deg, hi_deg))) @ Rij
        E[p] = essential_from_motion(Rij, tij / np.linalg.norm(tij))
    return SceneD(R, t, pts, K, keypoints, point_of_kp, pairs, matches, E,
                  bad)


def write_scene_d(path: str, sc: SceneD) -> None:
    """The scene as a COLMAP ``database.db`` (the port's writer): one
    camera with its prior focal, frames named ``frame%04d.png``."""
    from xmtpu_torch.pipeline import colmap_db as cdb
    from xmtpu_torch.pipeline.undistort import Camera

    cam = SCENE_D_CAMERA
    cameras = {1: Camera(model="SIMPLE_PINHOLE",
                         params=[cam["f"], cam["cx"], cam["cy"]],
                         width=cam["width"], height=cam["height"])}
    N = len(sc.R)
    images = {i + 1: (f"frame{i:04d}.png", 1) for i in range(N)}
    kps = {i + 1: sc.keypoints[i] for i in range(N)}
    tvgs = {(int(i) + 1, int(j) + 1): {"matches": m, "config": cdb.CALIBRATED,
                                       "E": E}
            for (i, j), m, E in zip(sc.pairs, sc.matches, sc.E)}
    cdb.write_database(path, cameras, images, keypoints=kps,
                       two_view_geometries=tvgs, prior_focal={1: True})


def scene_d_depth(sc: SceneD, i: int):
    """GT depth map of frame ``i``: the true z of each keypoint's point at
    its truncated pixel, zeros elsewhere; unit confidence."""
    cam = SCENE_D_CAMERA
    d = np.zeros((cam["height"], cam["width"]))
    uv = sc.keypoints[i].astype(int)
    d[uv[:, 1], uv[:, 0]] = (sc.pts[sc.point_of_kp[i]] @ sc.R[i][2]
                             + sc.t[i][2])
    return d, np.ones_like(d)


def scene_d_calibration_inputs(sc: SceneD, seed: int = 0):
    """Inputs of ``calibrate_view_graph`` at scene D's pair count: F of
    general-position relative poses (a random axis turned by 0.2-0.6 rad, a
    random translation direction; as ``tests/test_colmap_db.py`` builds
    them) under scene D's camera, one camera starting at 0.85 f.  The
    loop's own relative poses turn about the vertical only, so every two
    optical axes meet and the focal is not observable from them (the JAX
    package lands at 634.1 instead of 600 on the 24-frame scene).  Returns
    ``(F, cam0, cam1, principal_points, focals0)``."""
    from xmtpu_torch.pipeline.calibration import fundamental_from_pose

    rng = np.random.default_rng(seed)
    P = len(sc.pairs)
    F = np.zeros((P, 3, 3))
    for p in range(P):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        Rij = _rotvec(axis * (0.2 + 0.4 * rng.random()))
        tij = rng.normal(size=3)
        F[p] = fundamental_from_pose(sc.K, sc.K, Rij, tij / np.linalg.norm(tij))
    zero = np.zeros(P, dtype=np.int64)
    return (F, zero, zero, sc.K[None, :2, 2].copy(),
            np.array([0.85 * SCENE_D_CAMERA["f"]]))


def scene_d_stored_relposes(sc: SceneD):
    """The relative rotation of every stored pair, decomposed from its E on
    its matches' bearings as the mapper's stage 0 does, before stage 2's
    inlier test: the corrupted pairs carry their corrupted rotations."""
    from xmtpu_torch.pipeline.manipulation import pose_from_essential
    from xmtpu_torch.pipeline.undistort import Camera, undistorted_bearings

    c = SCENE_D_CAMERA
    cam = Camera(model="SIMPLE_PINHOLE", params=[c["f"], c["cx"], c["cy"]],
                 width=c["width"], height=c["height"])
    R_rel = np.empty((len(sc.pairs), 3, 3))
    for p, (i, j) in enumerate(sc.pairs):
        m = sc.matches[p]
        R_rel[p] = pose_from_essential(
            sc.E[p], undistorted_bearings(cam, sc.keypoints[i][m[:, 0]]),
            undistorted_bearings(cam, sc.keypoints[j][m[:, 1]]))[0]
    return R_rel


def filter_iterations(fn):
    """Runs ``fn`` (a ``filter_pairs`` call) counting the iterations of its
    loops: the L1 phase's (calls of the ADMM solve), the ADMM's over all of
    them (its z-update soft-thresholds each leaf of ``b`` once an
    iteration) and the IRLS phase's (rotation updates past the L1 phase's).
    Returns ``(fn(), counts)``."""
    from xmtpu_torch.ops import l1
    from xmtpu_torch.pipeline import rotation_averaging as ra

    n = dict(l1=0, admm=0, irls=0, shrink=0, updates=0)
    make, shrink, expm = ra.make_l1_admm, l1._shrinkage, ra._expm_so3

    def counting_make(*a, **k):
        solve = make(*a, **k)

        def counted(b, x0, max_iters):
            n["l1"] += 1
            before = n["shrink"]
            x = solve(b, x0, max_iters)
            n["admm"] += (n["shrink"] - before) // len(b)
            return x
        return counted

    def counting_shrink(*a):
        n["shrink"] += 1
        return shrink(*a)

    def counting_expm(*a):
        n["updates"] += 1
        return expm(*a)

    ra.make_l1_admm, l1._shrinkage, ra._expm_so3 = (
        counting_make, counting_shrink, counting_expm)
    try:
        out = fn()
    finally:
        ra.make_l1_admm, l1._shrinkage, ra._expm_so3 = make, shrink, expm
    n["irls"] = n.pop("updates") - n["l1"]
    del n["shrink"]
    return out, n


def scene_d_report(out, sc: SceneD):
    """``metrics.evaluate`` of an ``XM2Result`` against scene D's GT (w2c
    convention, solved frames mapped through ``indices_all``), as the
    reference's example 03 reports it."""
    from xmtpu_torch.pipeline import metrics

    R_gt = sc.R.transpose(0, 2, 1)                   # c2w
    centers = -np.einsum("nba,nb->na", sc.R, sc.t)
    live = out.indices_all > -1
    order = out.indices_all[live]
    R_gt_w2c = np.concatenate([R.T for R in R_gt[live]], axis=1)
    t_w2c = -np.einsum("nba,nb->na", R_gt[live], centers[live]).T
    N2 = out.s_real.shape[0]
    Rb = out.R_real.reshape(3, N2, 3).transpose(1, 0, 2)[order]
    return metrics.evaluate(Rb.transpose(1, 0, 2).reshape(3, -1),
                            out.t_est[:, order], R_gt_w2c, t_w2c)


def device_work(fn, tries: int = 5):
    """Runs ``fn`` once under ``torch.profiler`` (:func:`traced`): the
    kernels it launched on the card, its device-to-host copies, its scalar
    reads (``_local_scalar_dense``: ``bool``/``float`` of a card tensor),
    its ``index_add_`` kernels, its segment-sum kernels, the summed
    durations of its device events (``busy_ms``) and the six names that
    took most of them (``top``: name, count, ms).  A traced run with no
    kernel or no copy recorded (the profiler now and then drops a run's
    events) is taken again."""
    from torch.autograd import DeviceType

    for _ in range(tries):
        ev = traced(fn)
        dev_ev = device_events(ev)
        kernels = sum(not n.startswith(("Memcpy", "Memset"))
                      for n, _ in dev_ev)
        d2h = sum("DtoH" in n for n, _ in dev_ev)
        reads = sum(e.name() == "aten::_local_scalar_dense" for e in ev
                    if e.device_type() == DeviceType.CPU)
        # index_add_'s CUDA kernels (ATen's indexFuncSmall/LargeIndex), and
        # the segment sums' (csrc/segsum.cu)
        index_add = sum("indexFunc" in n for n, _ in dev_ev)
        segsum = sum("segsum" in n for n, _ in dev_ev)
        by_name = {}
        for n, ns in dev_ev:
            c, t = by_name.get(n, (0, 0))
            by_name[n] = (c + 1, t + ns)
        top = [(n[:60], c, t / 1e6) for n, (c, t) in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:6]]
        if kernels and d2h:
            return dict(launches=kernels, d2h_copies=d2h, scalar_reads=reads,
                        index_add=index_add, segsum=segsum,
                        busy_ms=sum(ns for _, ns in dev_ev) / 1e6, top=top)
    raise RuntimeError("device_work: the profiler recorded no kernel or no "
                       f"copy, {tries} times")


def run_xm2_d(xm2, lifted, N, M, dev, **kw):
    """``xm2_solve`` on scene D's lifted data; returns the result, the last
    staircase solve (the certified one), the ranks of every solve, the
    phase timer and the wall."""
    import torch

    from xmtpu_torch.utils.timer import PhaseTimer

    edges, weights, landmarks = lifted
    solves, orig = [], xm2.solve_arrays

    def recording(*a, **k):
        solves.append(orig(*a, **k))
        return solves[-1]

    timer = PhaseTimer()
    xm2.solve_arrays = recording
    t0 = time.perf_counter()
    try:
        out = xm2.xm2_solve(edges.copy(), weights.copy(), landmarks.copy(),
                            np.zeros((len(landmarks), 3)), N, M,
                            verbose=False, timer=timer, device=dev, **kw)
        torch.cuda.synchronize()
    finally:
        xm2.solve_arrays = orig
    return (out, solves[-1], [r.rank for r in solves], timer,
            time.perf_counter() - t0)


def hold_default_tol(xm2, out, last, dev):
    """Holds scene D's implicit run at the default tol, whose f32 and
    two-float stages let noise pick pass 2's lam (see ``XM2_D_ARGS``): its
    last solve must certify at the rank that the dense f64 route certifies
    on the same observations at the lam the run picked, with the primal
    within ``RTOL_IMPLICIT`` of that route's."""
    import torch

    t0 = time.perf_counter()
    op, _, _ = xm2._assemble_operator(out.weights, out.edges, out.landmarks,
                                      False, False, "f64", dev)
    wit = xm2.solve_arrays(op, 5, 1e-1, out.lam, 1000.0, verbose=False,
                           precision="f64", device=dev)
    torch.cuda.synchronize()
    log(f"[smoke] scene D default tol, the dense route on its "
        f"{len(out.edges)} observations at lam {out.lam}: certified "
        f"{wit.certified} at rank {wit.rank}, primal {wit.primal!r} "
        f"({time.perf_counter() - t0:.2f} s); the JAX package: lam "
        f"{XM2_D_DEFAULT['lam']}, rank {XM2_D_DEFAULT['rank']}, primal "
        f"{XM2_D_DEFAULT['primal']!r}; with lam forced to "
        f"{XM2_D_FORCED['lam']}: rank {XM2_D_FORCED['rank']}, primal "
        f"{XM2_D_FORCED['primal']!r}")
    if not (wit.certified and last.certified and last.rank == wit.rank):
        raise AssertionError(f"scene D default tol: certified "
                             f"{last.certified} at rank {last.rank}, the "
                             f"dense route at its lam {wit.certified} at "
                             f"rank {wit.rank}")
    if abs(last.primal - wit.primal) > RTOL_IMPLICIT * wit.primal:
        raise AssertionError(f"scene D default tol: primal {last.primal} vs "
                             f"the dense route's {wit.primal}")


def run_scene_d(dev, counts):
    """Phase 9: scene D written as a COLMAP database, ``python -m
    xmtpu_torch mapper`` twice (equal tempdata), held against the JAX
    package's counts; ``filter_pairs``' launches and host reads; lifting
    with GT depth; ``xm2_solve`` dense and implicit, held against the JAX
    package's runs; ``calibrate_view_graph`` on the card.  Then the segment
    sum on the dense run's assembly layouts (:func:`hold_assembly_sums`)
    and on the frame orderings of the implicit runs' operators
    (:func:`hold_schurq_frames`).  Returns the scene, the mapper's parsed
    export and the lifted observations, which phase 11 refines, and the
    frame orderings' and the assembly layouts' cases."""
    import filecmp
    import tempfile

    import torch

    from xmtpu_torch.__main__ import main as cli
    from xmtpu_torch.pipeline import global_mapper as gm
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.calibration import calibrate_view_graph
    from xmtpu_torch.pipeline.frontend import (build_view_graph, lift_dataset,
                                               parse_glomap_tempdata)
    from xmtpu_torch.pipeline.rotation_averaging import filter_pairs

    t0 = time.perf_counter()
    scD = make_scene_d(**SCENE_D)
    t_gen = time.perf_counter() - t0
    n_obs = [len(k) for k in scD.keypoints]
    log(f"[smoke] scene D: {len(scD.R)} frames, {len(scD.pts)} points, "
        f"{np.mean(n_obs):.1f} keypoints a frame ({sum(n_obs)} in all), "
        f"{len(scD.pairs)} pairs sharing >= {SCENE_D_MIN_SHARED} points, "
        f"{sum(len(m) for m in scD.matches)} matches, "
        f"{int(scD.corrupted.sum())} corrupted; generated in {t_gen:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "database.db")
        t0 = time.perf_counter()
        write_scene_d(db, scD)
        log(f"[smoke] scene D database: {time.perf_counter() - t0:.2f} s, "
            f"{os.path.getsize(db) / 2**20:.1f} MiB")

        # the mapper twice through the command line; the first run's first
        # filter_pairs call is kept to count its launches and host reads
        first, orig = [], gm.filter_pairs

        def recording(*a, **k):
            if not first:
                first.append((a, k))
            return orig(*a, **k)

        outs, walls = [], []
        gm.filter_pairs = recording
        try:
            for k in range(2):
                outs.append(os.path.join(tmp, f"tempdata{k}"))
                t0 = time.perf_counter()
                rc = cli(["mapper", "--database_path", db, "--output_path",
                          outs[-1]], device=dev)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if rc != 0:
                    raise AssertionError(f"scene D mapper: exit code {rc}")
        finally:
            gm.filter_pairs = orig
        log(f"[smoke] scene D mapper walls: {walls[0]:.2f} s, "
            f"{walls[1]:.2f} s")
        for name in ("output.txt", "filename.txt", "relative_pose.txt"):
            if not filecmp.cmp(os.path.join(outs[0], name),
                               os.path.join(outs[1], name), shallow=False):
                raise AssertionError(f"scene D: the two mapper runs wrote "
                                     f"different {name}")
        (a, k), = first
        work = device_work(lambda: orig(*a, **k))
        log(f"[smoke] scene D filter_pairs ({len(a[0])} pairs, one call): "
            f"{work['launches']} kernel launches, {work['scalar_reads']} "
            f"scalar reads, {work['d2h_copies']} device-to-host copies")
        exp = parse_glomap_tempdata(outs[0])

    # the mapper's counts, exact, and its pair filter
    got = dict(registered=len(np.unique(exp.matches[:, 0])),
               valid_pairs=len(exp.relposes), n_tracks=exp.M,
               n_obs=len(exp.matches))
    log(f"[smoke] scene D mapper: {got} (JAX package: {MAPPER_D})")
    if got != MAPPER_D:
        raise AssertionError(f"scene D mapper counts {got} vs {MAPPER_D}")
    pair_of = {(int(i) + 1, int(j) + 1): p
               for p, (i, j) in enumerate(scD.pairs)}
    kept = np.zeros(len(scD.pairs), dtype=bool)
    r_err = 0.0
    for (id1, id2), (R, _) in exp.relposes.items():
        kept[pair_of[(id1, id2)]] = True
        R_gt = scD.R[id2 - 1] @ scD.R[id1 - 1].T
        r_err = max(r_err, float(np.abs(R - R_gt).max()))
    log(f"[smoke] scene D pairs: {int((kept & scD.corrupted).sum())} of "
        f"{int(scD.corrupted.sum())} corrupted kept, "
        f"{int((~kept & ~scD.corrupted).sum())} clean dropped; R_rel "
        f"{r_err:.2e} from GT at most")
    if (kept & scD.corrupted).any() or (~kept & ~scD.corrupted).any():
        raise AssertionError("scene D: a corrupted pair kept or a clean pair "
                             "dropped")
    if not r_err <= 1e-4:
        raise AssertionError(f"scene D: R_rel {r_err:.2e} from GT")

    # the robust path: filter_pairs on every stored pair with the rotation
    # decomposed from its E, the corrupted ones included (in the mapper
    # stage 2's inlier test drops them before stage 3 sees them)
    t0 = time.perf_counter()
    R_st = scene_d_stored_relposes(scD)
    t_dec = time.perf_counter() - t0
    w_st = np.array([len(m) for m in scD.matches], dtype=np.float64)

    def robust():
        return filter_pairs(scD.pairs, R_st, len(scD.R), max_angle_deg=10.0,
                            weights=w_st, device=dev)

    t0 = time.perf_counter()
    (keep_r, res_r), iters = filter_iterations(robust)
    torch.cuda.synchronize()
    t_rob = time.perf_counter() - t0
    keep_again = robust()[0]
    t0 = time.perf_counter()
    work = device_work(robust)
    t_traced = time.perf_counter() - t0
    ang = np.degrees(res_r.residual_angles)
    log(f"[smoke] scene D filter_pairs on all {len(scD.pairs)} stored pairs "
        f"({int(scD.corrupted.sum())} corrupted; decomposed in {t_dec:.2f} "
        f"s): {t_rob:.3f} s ({t_traced:.1f} s traced), iterations {iters}, "
        f"{work['launches']} kernel "
        f"launches, {work['scalar_reads']} scalar reads, "
        f"{work['d2h_copies']} device-to-host copies; residuals: clean "
        f"{ang[~scD.corrupted].max():.4f} deg at most, corrupted "
        f"{ang[scD.corrupted].min():.2f} deg at least; "
        f"{int((keep_r != ~scD.corrupted).sum())} pairs misjudged")
    if not np.array_equal(keep_r, ~scD.corrupted):
        raise AssertionError("scene D filter_pairs on the stored pairs: the "
                             "mask is not the clean pairs")
    if not np.array_equal(keep_again, keep_r):
        raise AssertionError("scene D filter_pairs: two calls' masks differ")

    # lifting with GT depth, then XM^2 dense (its defaults) and implicit
    t0 = time.perf_counter()
    vg = build_view_graph(exp.matches, N=exp.N, M=exp.M)
    lifted = lift_dataset(vg, lambda i: scene_d_depth(scD, i),
                          lambda i: scD.K)
    log(f"[smoke] scene D lifting: {time.perf_counter() - t0:.2f} s, "
        f"{len(lifted[0])} observations, {vg.N} frames, {vg.M} tracks")
    R_gt = scD.R.transpose(0, 2, 1)
    frame_runs = []     # the implicit runs' operators' frame orderings
    asm_cases = []      # the kernel on the dense run's assembly layouts
    for tag, kw, ref in (
            ("dense", XM2_D_ARGS["dense"], XM2_D["dense"]),
            ("implicit", XM2_D_ARGS["implicit"], XM2_D["implicit"]),
            ("implicit default tol", dict(implicit=True), XM2_D_DEFAULT)):
        reset_counts()
        with _SchurQRecorder() as rec, recorded_calls(
                xm2, "create_matrix_arrays") as asm_in:
            out, last, ranks, timer, wall = run_xm2_d(xm2, lifted, vg.N,
                                                      vg.M, dev, **kw)
        counts[f"D {tag}"] = read_counts()
        if rec.built:
            frame_runs.append((tag, rec.built))
        rot = rotation_error_stats(out.R_real, R_gt, out.indices_all)
        m = scene_d_report(out, scD)
        log(f"[smoke] scene D xm2_solve {tag}: wall {wall:.2f} s, ranks "
            f"{ranks}, certified {last.certified} at rank {last.rank}, "
            f"primal {last.primal!r} (JAX package {ref['primal']!r}, "
            f"rank {ref['rank']}), lam {out.lam}, rotation errors {rot} "
            f"(JAX package {ref['rot']}); ATE/RPE "
            f"{ {k: float(v) for k, v in m.items()} }; launches "
            f"{counts[f'D {tag}']}; phases:")
        for line in timer.report().splitlines():
            log(f"[smoke]   {line}")
        if tag == "dense":
            asm = {k: v for k, v in counts["D dense"][
                "sorted_segment_sum layouts"].items()
                if k.startswith("assembly")}
            log(f"[smoke] scene D xm2_solve dense: assembly walls pass 1 "
                f"{timer.totals['pass1_assemble']:.3f} s, pass 2 "
                f"{timer.totals['pass2_assemble']:.3f} s; sorted_segment_sum "
                f"launches {asm}")
            if not (asm.get("assembly frame f64 D=13") == 2
                    and asm.get("assembly landmark f64 D=1") == 2):
                raise AssertionError(f"scene D dense: the two assemblies' "
                                     f"segment sums launched {asm}")
            for p, (a, _) in enumerate(asm_in, 1):
                asm_cases += hold_assembly_sums(
                    f"scene D xm2_solve dense pass {p}", a[1], ("D dense",),
                    dev)
        del asm_in
        if ref is XM2_D_DEFAULT:
            hold_default_tol(xm2, out, last, dev)
            continue
        if not (last.certified and last.rank == ref["rank"]):
            raise AssertionError(f"scene D {tag}: not certified at rank "
                                 f"{ref['rank']}")
        if abs(last.primal - ref["primal"]) > RTOL_IMPLICIT * ref["primal"]:
            raise AssertionError(f"scene D {tag}: primal {last.primal} vs "
                                 f"{ref['primal']}")
        check_rotations(f"scene D {tag}", rot, ref["rot"])
    if counts["D implicit"]["sorted_segment_sum"] <= 0:
        raise AssertionError("scene D implicit: sorted_segment_sum never "
                             "launched")
    if [t for t, _ in frame_runs] != ["implicit", "implicit default tol"]:
        raise AssertionError(f"scene D: SchurQ built by "
                             f"{[t for t, _ in frame_runs]}")
    frame_cases = hold_schurq_frames(frame_runs, counts, dev)
    for c in frame_cases:
        log(tail_case_line("scene D implicit", c))
    del frame_runs

    # view-graph calibration on the card
    F, cam0, cam1, pp, f0 = scene_d_calibration_inputs(scD)
    t0 = time.perf_counter()
    cal = calibrate_view_graph(F, cam0, cam1, pp, f0, prior_mask=[False],
                               device=dev)
    f_cal = float(cal["focals"][0])
    log(f"[smoke] scene D calibrate_view_graph ({len(F)} pairs, from "
        f"{f0[0]}): focal {f_cal!r} (JAX package {CALIB_D!r}), "
        f"{int(cal['pair_valid'].sum())} pairs valid, "
        f"{time.perf_counter() - t0:.2f} s")
    f_true = SCENE_D_CAMERA["f"]
    if not (abs(f_cal - f_true) <= 0.01 * f_true
            and abs(f_cal - CALIB_D) <= 1e-6 * CALIB_D):
        raise AssertionError(f"scene D calibration: focal {f_cal}")
    return scD, exp, lifted, frame_cases, asm_cases


def tail_gt_errors(R, t, sc: SceneD, frames=None) -> dict:
    """Cam_from_world poses (R, t) against scene D's GT (of ``frames``, the
    scene's frame of each row; all frames in order by default): the
    rotation errors (degrees) after the best global rotation, and the
    camera-centre errors (metres) after the best similarity (Umeyama), max
    and mean."""
    frames = np.arange(len(sc.R)) if frames is None else frames
    R_gt, t_gt = sc.R[frames], sc.t[frames]
    M = np.einsum("nba,nbc->ac", R_gt, R)
    U, _, Vt = np.linalg.svd(M)
    G = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    D = np.einsum("nab,bc,ndc->nad", R_gt, G, R)
    rot = np.degrees(np.arccos(np.clip(
        (np.trace(D, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)))
    c = -np.einsum("nba,nb->na", R, t)
    c_gt = -np.einsum("nba,nb->na", R_gt, t_gt)
    X, Y = c - c.mean(0), c_gt - c_gt.mean(0)
    U, S, Vt = np.linalg.svd(Y.T @ X / len(X))
    d = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    scale = np.trace(np.diag(S) @ d) / np.mean(np.sum(X * X, axis=1))
    err = np.linalg.norm(scale * X @ (U @ d @ Vt).T - Y, axis=1)
    return dict(rot_max=float(rot.max()), rot_mean=float(rot.mean()),
                centre_max=float(err.max()), centre_mean=float(err.mean()))


def tail_poses(blob: str):
    """``TAIL_D_POSES`` decoded: (N, 3, 3) rotations and (N, 3) centres."""
    import base64

    v = np.frombuffer(base64.b64decode("".join(blob.split())),
                      dtype=np.float32).astype(np.float64).reshape(2, -1, 3)
    return np.stack([_rotvec(w) for w in v[0]]), v[1]


@contextlib.contextmanager
def recorded_calls(module, name: str):
    """``module.name`` wrapped while open: yields the list of its calls'
    ``(args, kwargs)``, appended as they are made."""
    calls, orig = [], getattr(module, name)

    def recording(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


class _Recorder:
    """Records the layouts of ``Segments`` built in one module during the
    main path (the first of each layout name), so the kernel can be held on
    them afterwards: ``layouts[name] = (ids, S)``."""

    def __init__(self, module):
        self.module, self.layouts = module, {}
        self.orig = module.Segments

    def __enter__(self):
        rec, orig = self, self.orig

        class Recording(orig):
            def __init__(self, ids, num_segments, device, layout="unnamed"):
                rec.layouts.setdefault(layout, (np.array(ids, dtype=np.int64),
                                                int(num_segments)))
                super().__init__(ids, num_segments, device, layout)

        self.module.Segments = Recording
        return self

    def __exit__(self, *exc):
        self.module.Segments = self.orig


class _Planned:
    """Sorted segment ids on the card with their planned offsets, as an
    operator holds them (``SchurQ``'s ``f_f`` / ``bounds_f``), summed as
    ``Segments`` sums."""

    perm = None

    def __init__(self, ids, offsets):
        self.ids, self.offsets = ids, offsets

    def sum(self, vals):
        from xmtpu_torch.ops import segsum as ss

        return ss.sorted_segment_sum(vals, self.ids, len(self.offsets) - 1,
                                     offsets=self.offsets)


class _SchurQRecorder:
    """Records the frame ordering of every ``SchurQ`` built while it is
    open: ``built`` holds ``(f_f, bounds_f)``, the sorted ids and planned
    offsets the operator sums by frame."""

    def __enter__(self):
        from xmtpu_torch.ops.schurq import SchurQ

        self.cls, self.orig, self.built = SchurQ, SchurQ.__dict__["build"], []
        build, built = self.orig.__func__, self.built

        def recording(*a, **k):
            q = build(*a, **k)
            built.append((q.f_f, q.bounds_f))
            return q

        SchurQ.build = staticmethod(recording)
        return self

    def __exit__(self, *exc):
        self.cls.build = self.orig


def hold_tail_segsum(layouts, dev, reps: int = 50):
    """``sorted_segment_sum`` on real layouts through their planned
    offsets, named by layout: the CPU twin's bits, the same bits on a
    second launch, one launch a call, counted under the layout's name;
    timed a launch (``launch_ms``) beside ``index_add_`` on the same sorted
    rows, the byte bound and the chain floor (and, on the log line, the
    earlier design's time).  ``layouts``: ``(name, ids, S, D)``, f64 rows
    summed through ``Segments``, or ``(name, ids, S, D, dtype, seg)``, rows
    of ``dtype`` summed through ``seg`` (a :class:`_Planned`)."""
    import torch

    from xmtpu_torch.ops import segsum as ss

    gen = np.random.default_rng(1)
    cases = []
    for name, ids, S, D, *rest in layouts:
        dt, seg = rest or (torch.float64, ss.Segments(ids, S, dev, name))
        sfx = "f64" if dt == torch.float64 else "f32"
        item = 8 if dt == torch.float64 else 4
        tag = f"{name} D={D}" if item == 8 else f"{name} {sfx} D={D}"
        vals = gen.normal(size=(len(ids), D)).astype(
            np.float64 if item == 8 else np.float32)
        v = torch.as_tensor(vals, device=dev)
        n0 = ss.sorted_segment_sum.launches
        key = f"{name} {sfx} D={D}"
        k0 = ss.sorted_segment_sum.layouts.get(key, 0)
        a, b = seg.sum(v), seg.sum(v)
        torch.cuda.synchronize()
        calls = (ss.sorted_segment_sum.launches - n0,
                 ss.sorted_segment_sum.layouts.get(key, 0) - k0)
        want = ss.Segments(ids, S, "cpu").sum(torch.as_tensor(vals))
        if not (torch.equal(a, b) and torch.equal(a.cpu(), want)
                and calls == (2, 2)):
            raise AssertionError(f"segsum {tag}: repeatable "
                                 f"{torch.equal(a, b)}, the CPU twin's bits "
                                 f"{torch.equal(a.cpu(), want)}, launches "
                                 f"(all, {key}) of two calls {calls}")
        rows = v if seg.perm is None else v[seg.perm].contiguous()
        out = torch.zeros((S, D), dtype=dt, device=dev)
        plan = seg.offsets.csr_plan
        nbytes, ops = segsum_bytes_ops(len(ids), S, D, item, S + 1)
        cases.append(dict(
            tag=tag, layout=name, key=key, E=len(ids), S=S, D=D,
            dtype=sfx, longest=plan.longest, n_long=plan.n_long,
            ms=launch_ms(lambda: ss.sorted_segment_sum(
                rows, seg.ids, S, offsets=seg.offsets), reps),
            plain_ms=cuda_ms(lambda: ss.sorted_segment_sum_plain(
                rows, seg.ids, S), reps),
            library_ms=launch_ms(lambda: out.index_add_(0, seg.ids, rows),
                                 reps),
            bound=bound_ms(nbytes, ops, PEAK_F64 if item == 8 else PEAK_F32),
            chain_floor=chain_floor_ms(plan.longest, item),
            prev_ms=PREV_TAIL_MS.get(tag)))
    return cases


def tail_case_line(where: str, c: dict) -> str:
    return (f"[smoke] {where} segsum {c['tag']} (E={c['E']}, S={c['S']}, "
            f"longest {c['longest']}, {c['n_long']} long): {c['ms']:.4f} ms "
            f"plain {c['plain_ms']:.4f} ms index_add_ "
            f"{c['library_ms']:.4f} ms bound {c['bound'][0]:.5f} ms "
            f"({c['bound'][1]}, {c['bound'][2]}) chain floor "
            f"{c['chain_floor']:.5f} ms"
            + (f"; earlier design {c['prev_ms']} ms" if c["prev_ms"] else "")
            + "; the CPU twin's bits, twice, one launch a call")


def hold_assembly_sums(where: str, edges, runs, dev) -> list:
    """``sorted_segment_sum`` on the dense assembly's layouts of ``edges``
    (1-based ``[frame, landmark]``, as ``create_matrix_arrays`` takes
    them), as :func:`hold_tail_segsum` holds the tail's: by frame at D =
    13, by landmark at D = 1, by pair at D = 4 where a (frame, landmark)
    pair repeats.  Each case is logged under ``where`` and carries
    ``runs``, the main-path runs whose launches of its layout it reports."""
    edges = np.asarray(edges, dtype=np.int64)
    f, l = edges[:, 0] - 1, edges[:, 1] - 1
    N, M = int(f.max()) + 1, int(l.max()) + 1
    layouts = [("assembly frame", f, N, 13), ("assembly landmark", l, M, 1)]
    pairs, of_edge = np.unique(f * M + l, return_inverse=True)
    if len(pairs) < len(f):
        layouts.append(("assembly pair", of_edge.ravel(), len(pairs), 4))
    cases = hold_tail_segsum(layouts, dev, reps=20)
    for c in cases:
        c["runs"] = runs
        log(tail_case_line(where, c))
    return cases


def hold_schurq_frames(runs, counts, dev) -> list:
    """``sorted_segment_sum`` on each distinct frame ordering that phase 9's
    implicit runs built (``runs``: ``(tag, built)`` of a
    :class:`_SchurQRecorder`), through the operator's own planned offsets,
    at every type and width the run that built it summed under ``SchurQ
    frame``, as :func:`hold_tail_segsum` holds the tail's."""
    import torch

    frames = {}
    for tag, built in runs:
        keys = {k for k, v in counts[f"D {tag}"][
            "sorted_segment_sum layouts"].items()
            if k.startswith("SchurQ frame ") and v > 0}
        for f_f, off in built:
            ent = frames.setdefault(off.cpu().numpy().tobytes(),
                                    [f_f, off, set()])
            ent[2] |= keys
    layouts = []
    for f_f, off, keys in frames.values():
        if off.csr_plan.n_long == 0:
            raise AssertionError("scene D implicit: the frame ordering has "
                                 "no long segment")
        seg = _Planned(f_f, off)
        for key in sorted(keys, key=lambda k: (k.split()[-2],
                                               int(k.split("=")[-1]))):
            sfx, D = key.split()[-2], int(key.split("=")[-1])
            layouts.append(("SchurQ frame", f_f.cpu().numpy(), len(off) - 1,
                            D, torch.float64 if sfx == "f64"
                            else torch.float32, seg))
    return hold_tail_segsum(layouts, dev, reps=20)


def watch_scene_c(Q_C, scC, res_C, dev):
    """Scene C's certified point, checked twice: the certificate the solve
    ran on the implicit operator again (its deciding path, gap, lam_min and
    bound), and the port's dense certificate on scene C's exact dense f64
    cost (3n = 18,432; 2.7 GB), with the point's primal evaluated there.  A
    refutation there is a fault of the port.  Frees ``Q_C``."""
    import torch

    from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.solver.certificate import _min_eig_bound, certify

    n = scC.N
    R = torch.as_tensor(res_C.R, device=dev).reshape(n, 3, -1)
    sR = mf.flatten(mf.scale_blocks(R, torch.as_tensor(res_C.s_ex,
                                                       device=dev)))
    bound = _min_eig_bound(n)
    t0 = time.perf_counter()
    ci = certify(Q_C, sR, 0.0, res_C.primal, fast="auto", device=dev)
    torch.cuda.synchronize()
    t_cert = time.perf_counter() - t0
    log(f"[smoke] scene C certificate on SchurQ ({t_cert:.2f} s): "
        f"certified {ci.certified}, path {ci.info['path']}, gap "
        f"{ci.gap:.4e} (gap / primal {ci.gap / res_C.primal:.3e}), lam_min "
        f"{ci.lam_min:.4e}, bound {bound:g}, probe iterations "
        f"{ci.info['probe_iters']}")
    del Q_C
    t0 = time.perf_counter()
    C, _ = create_matrix_arrays(scC.weights, scC.edges, scC.landmarks,
                                device=dev)
    primal = float(torch.sum(sR * (C @ sR)))
    cd = certify(C, sR, 0.0, primal, device=dev)
    torch.cuda.synchronize()
    log(f"[smoke] scene C's certified point on the dense f64 cost "
        f"({C.shape[0]} x {C.shape[1]}, {time.perf_counter() - t0:.2f} s): "
        f"primal {primal!r} (the solve's {res_C.primal!r}, the JAX "
        f"package's {PRIMAL_C!r}); dense certificate certified "
        f"{cd.certified}, gap {cd.gap:.4e} (gap / primal "
        f"{cd.gap / primal:.3e}), lam_min {cd.lam_min:.4e}, bound {bound:g}")
    if not cd.certified:
        raise AssertionError("scene C: the dense certificate refutes the "
                             "port's certified point")
    # the two costs' f64 sums run in other orders (the dense assembly's
    # atomics, the Schur elimination): 1.1e-9 apart on the H100
    if abs(primal - res_C.primal) > 1e-8 * primal:
        raise AssertionError(f"scene C: the dense cost's primal {primal} vs "
                             f"the solve's {res_C.primal}")


def run_scene_d_tail(dev, counts) -> list:
    """Phase 10: scene D's mapper with stages 5-8 on, through
    ``__main__.main(["mapper", ..., "--skip_* 0"])`` on the card, held
    against the JAX package (counts, focal, poses) and ground truth; the
    segment-sum kernel on the tail's real layouts; a second
    ``global_positioning`` and positions-only ``bundle_adjustment`` call
    repeating their bits.  Returns the kernel's cases on the tail shapes."""
    import contextlib
    import io
    import re
    import tempfile

    import torch

    from xmtpu_torch.__main__ import main as cli
    from xmtpu_torch.pipeline import bundle_adjustment as ba
    from xmtpu_torch.pipeline import global_mapper as gm
    from xmtpu_torch.pipeline import global_positioning as gp
    from xmtpu_torch.pipeline import triangulation as tri
    from xmtpu_torch.utils.timer import PhaseTimer

    t0 = time.perf_counter()
    scD = make_scene_d(**SCENE_D)
    timer, result, gp_calls, ba_calls = PhaseTimer(), [], [], []
    solve, gp_fn, ba_fn = (gm.global_mapper_solve, gp.global_positioning,
                           ba.bundle_adjustment)

    def solving(*a, **k):
        result.append(solve(*a, timer=timer, **k))
        return result[-1]

    def positioning(*a, **k):
        out = gp_fn(*a, **k)
        if not gp_calls:
            gp_calls.append((a, k, out))
        return out

    def adjusting(*a, **k):
        out = ba_fn(*a, **k)
        opts = a[8] if len(a) > 8 else k.get("opts")
        if not ba_calls and not opts.optimize_rotations:
            ba_calls.append((a, k, out))
        return out

    adjusting.host_reads = 0   # the LM loops' reads land on the patched name
    flags = ["--skip_global_positioning", "0", "--skip_bundle_adjustment",
             "0", "--skip_retriangulation", "0", "--skip_pruning", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "database.db")
        write_scene_d(db, scD)
        t_set = time.perf_counter() - t0
        gm.global_mapper_solve, gp.global_positioning = solving, positioning
        ba.bundle_adjustment = adjusting
        text = io.StringIO()
        reset_counts()
        try:
            with _Recorder(gp) as r_gp, _Recorder(ba) as r_ba, \
                    _Recorder(tri) as r_tri, \
                    contextlib.redirect_stdout(text):
                t0 = time.perf_counter()
                rc = cli(["mapper", "--database_path", db, "--output_path",
                          os.path.join(tmp, "tempdata")] + flags, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            gm.global_mapper_solve, gp.global_positioning = solve, gp_fn
            ba.bundle_adjustment = ba_fn
        counts["D tail"] = read_counts()
    for line in text.getvalue().splitlines():
        log(f"[smoke]   {line}")
    if rc != 0:
        raise AssertionError(f"scene D tail: exit code {rc}")
    res = result[0]
    out = text.getvalue()

    def logged(pattern):
        return [int(x) for x in re.search(pattern, out).groups()]

    gp_obs, positioned = logged(r"global positioning: (\d+) observations, "
                                r"(\d+) tracks")
    ba_obs, = logged(r"bundle adjustment: (\d+) observations")
    tri_obs, = logged(r"retriangulation: (\d+) observations")
    clusters, registered = logged(r"pruning: (\d+) strong clusters, "
                                  r"(\d+) images")
    got = dict(gp_obs=gp_obs, positioned=positioned, ba_obs=ba_obs,
               tri_obs=tri_obs, clusters=clusters, registered=registered)
    shapes = counts["D tail"]["sorted_segment_sum shapes"]
    log(f"[smoke] scene D tail: set-up {t_set:.2f} s, mapper wall "
        f"{wall:.2f} s; stages (s): "
        f"{ {k: round(v, 3) for k, v in sorted(timer.totals.items())} }")
    log(f"[smoke] scene D tail counts {got} (JAX package {TAIL_D}); "
        f"sorted_segment_sum launches {counts['D tail']['sorted_segment_sum']}"
        f" by shape {shapes}; host reads of the BA LM loops "
        f"{adjusting.host_reads} ({adjusting.host_reads // 2} LM steps)")
    for k, want in TAIL_D.items():
        if abs(got[k] - want) > TAIL_D_TOL["count"] * want:
            raise AssertionError(f"scene D tail: {k} {got[k]} vs {want}")
    if len(res.obs_image) != tri_obs or int(res.registered.sum()) != (
            registered):
        raise AssertionError("scene D tail: the result disagrees with its "
                             "log")
    want_shapes = {f"f64 D={d}" for d in (1, 3, 6, 9, 12, 16, 36)}
    if not want_shapes <= {k for k, v in shapes.items() if v > 0}:
        raise AssertionError(f"scene D tail: a segment-sum shape never "
                             f"launched: {shapes}")
    launched_layouts(counts["D tail"], TAIL_LAYOUTS, "scene D tail")

    # the JAX package's focal and poses, and ground truth
    focal = float(res.focals[0])
    R_ref, c_ref = tail_poses(TAIL_D_POSES)
    c = -np.einsum("nba,nb->na", res.R_global, res.t_global)
    dR = float(np.abs(res.R_global - R_ref).max())
    dc = float(np.abs(c - c_ref).max())
    gt = tail_gt_errors(res.R_global, res.t_global, scD)
    log(f"[smoke] scene D tail: focal {focal!r} (JAX package "
        f"{TAIL_D_FOCAL!r}, true {SCENE_D_CAMERA['f']}); R_global "
        f"{dR:.2e} and centres {dc:.2e} from the JAX package's; against GT "
        f"{gt} (JAX package {TAIL_D_GT}); finite tracks "
        f"{int(np.isfinite(res.xyz).all(axis=1).sum())} of {res.n_tracks}")
    if abs(focal - TAIL_D_FOCAL) > TAIL_D_TOL["focal"] * TAIL_D_FOCAL:
        raise AssertionError(f"scene D tail: focal {focal}")
    if not (dR <= TAIL_D_TOL["R"] and dc <= TAIL_D_TOL["centre"]):
        raise AssertionError(f"scene D tail: poses {dR:.2e} / {dc:.2e} "
                             f"from the JAX package's")
    for k, v in gt.items():
        if not v <= ROT_SLACK * TAIL_D_GT[k]:
            raise AssertionError(f"scene D tail: GT {k} {v:.3e} beyond "
                                 f"{ROT_SLACK} x the JAX package's")

    # a second call of each compute stage on the same inputs, traced: the
    # same bits, and its launches, host reads and device busy time
    for tag, fn, (a, k, first) in (("global_positioning", gp_fn,
                                    gp_calls[0]),
                                   ("bundle_adjustment", ba_fn,
                                    ba_calls[0])):
        again = []
        t0 = time.perf_counter()
        work = device_work(lambda: again.append(fn(*a, **k)))
        wall_c = time.perf_counter() - t0
        again = again[-1]
        same = all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(
                       first.values() if isinstance(first, dict) else first,
                       again.values() if isinstance(again, dict) else again))
        log(f"[smoke] scene D tail: a second {tag} call, traced "
            f"({wall_c:.2f} s): the same bits {same}; {work['launches']} "
            f"kernel launches, {work['scalar_reads']} scalar reads, "
            f"{work['d2h_copies']} device-to-host copies, device busy "
            f"{work['busy_ms']:.1f} ms")
        if not same:
            raise AssertionError(f"scene D tail: two {tag} calls differ")
        # the host reads: BATA's final cost alone (its 64 x 12 loops read
        # nothing), and two a LM step in BA
        reads = 1 if tag == "global_positioning" else 2 * again.iterations
        if work["scalar_reads"] != reads:
            raise AssertionError(f"scene D tail: {tag} read "
                                 f"{work['scalar_reads']} scalars, expected "
                                 f"{reads}")

    # the kernel on the tail's real layouts
    seen = r_gp.layouts | r_ba.layouts | r_tri.layouts
    img, N = seen["BA image"]
    cams, C = seen["BA camera"]
    if not len(cams) == N < len(img):
        raise AssertionError("scene D tail: a camera sum ran over the edges")
    cases = hold_tail_segsum([(name, *seen[name], D) for name, Ds in
                              TAIL_LAYOUTS.items() for D in Ds], dev)
    for c in cases:
        log(tail_case_line("tail", c))
    return cases


def plant_outliers(landmarks, seed: int):
    """``examples/05_refine.py``'s outliers on lifted observations: a seeded
    ``len // REFINE_D_OUTLIERS["every"]`` rows moved by N(0, 1) *
    ``REFINE_D_OUTLIERS["sigma"]``.  Returns the moved copy and the rows'
    mask."""
    rng = np.random.default_rng(seed)
    E = len(landmarks)
    bad = rng.choice(E, size=E // REFINE_D_OUTLIERS["every"], replace=False)
    out = landmarks.copy()
    out[bad] += rng.normal(size=(len(bad), 3)) * REFINE_D_OUTLIERS["sigma"]
    planted = np.zeros(E, dtype=bool)
    planted[bad] = True
    return out, planted


def refine_frames(R_c2w_flat, centres, indices_all):
    """An ``XM2Result``'s or ``RefineResult``'s c2w blocks and camera
    centres (solved order) as cam_from_world ``(R, t)`` and the scene frame
    of each, through ``indices_all``."""
    N = centres.shape[1]
    R_w2c = R_c2w_flat.reshape(3, N, 3).transpose(1, 2, 0)
    t_w2c = -np.einsum("nab,bn->na", R_w2c, centres)
    live = np.flatnonzero(indices_all > -1)
    order = indices_all[live]
    return R_w2c[order], t_w2c[order], live


def mean_reprojection_error(edges, obs2d, R_c2w_flat, centres, p):
    """Mean distance of the normalized observations from the projections
    of (c2w blocks, camera centres, points (3, M)), as
    ``tests/test_refine.py`` measures it."""
    N = centres.shape[1]
    R_w2c = R_c2w_flat.reshape(3, N, 3).transpose(1, 2, 0)
    t_w2c = -np.einsum("nab,bn->na", R_w2c, centres)
    f, l = edges[:, 0] - 1, edges[:, 1] - 1
    x = np.einsum("eab,eb->ea", R_w2c[f], p.T[l]) + t_w2c[f]
    return float(np.mean(np.linalg.norm(x[:, :2] / x[:, 2:3] - obs2d,
                                        axis=1)))


def render_plane_scene(n_views: int = 8, size: int = 192, seed: int = 5):
    """Views of a textured 3-D plane with analytic depth and GT poses: a
    copy of ``examples/04_learned_depth.py:render_scene`` (numpy only)."""
    rng = np.random.default_rng(seed)
    f = 0.9 * size
    K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1.0]])
    tex = (rng.random((64, 64)) > 0.5).astype(np.float64)
    tex = np.kron(tex, np.ones((8, 8)))  # blocky texture, SIFT-friendly
    images, depths, R_gt, t_gt = [], [], [], []
    n_plane = np.array([0.0, 0.0, 1.0])
    for i in range(n_views):
        ang = 0.15 * (i - n_views / 2) / n_views
        ca, sa = np.cos(ang), np.sin(ang)
        R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        t = np.array([0.4 * i / n_views, 0.05 * np.sin(i), -2.5 - 0.1 * i])
        uu, vv = np.meshgrid(np.arange(size), np.arange(size))
        rays = np.linalg.inv(K) @ np.stack(
            [uu.ravel(), vv.ravel(), np.ones(size * size)])
        rays_w = R @ rays
        nc = n_plane @ rays_w
        d0 = n_plane @ (np.zeros(3) - t)
        z = np.where(np.abs(nc) > 1e-9, d0 / nc, 0.0)
        pw = t[:, None] + rays_w * z
        ok = (z.reshape(size, size) > 0)
        px = np.clip(((pw[0] + 3) * 80).astype(int) % 512, 0, 511)
        py = np.clip(((pw[1] + 3) * 80).astype(int) % 512, 0, 511)
        img = np.where(ok.ravel(),
                       tex[py % tex.shape[0], px % tex.shape[1]], 0.0)
        img8 = (img.reshape(size, size) * 255).astype(np.uint8)
        images.append(np.stack([img8] * 3, axis=-1))
        depth = z.reshape(size, size).copy()
        depth[~ok] = 0.0
        depths.append(depth)
        R_gt.append(R)
        t_gt.append(t)
    return images, depths, np.stack(R_gt), np.stack(t_gt), K


def depth_net_summary(depth, conf) -> list:
    """The numbers of one view that are held against the JAX package: the
    mean log-depth, then depth and confidence at ``DEPTH_NET_PIXELS``."""
    out = [float(np.mean(np.log(depth)))]
    for v, u in DEPTH_NET_PIXELS:
        out += [float(depth[v, u]), float(conf[v, u])]
    return out


def hold_depth_net(dev) -> dict:
    """The tiny monodepth net on the card: ``TinyMonoDepthModel`` on
    ``render_plane_scene``'s views against the port on the CPU (depth and
    confidence within ``DEPTH_NET_RTOL`` of the maps' maxima) and against
    the JAX package's recorded numbers (``DEPTH_NET``, within the same
    tolerance); its ms a view."""
    import torch

    from xmtpu_torch.pipeline.depth_net import TinyMonoDepthModel

    images = render_plane_scene(**DEPTH_NET_SCENE)[0]
    card, host = TinyMonoDepthModel(device=dev), TinyMonoDepthModel(
        device="cpu")
    worst = dict(cpu=0.0, jax=0.0)
    for k, im in enumerate(images):
        d, c = card.infer(im)
        d_h, c_h = host.infer(im)
        worst["cpu"] = max(worst["cpu"],
                           float(np.abs(d - d_h).max() / np.abs(d_h).max()),
                           float(np.abs(c - c_h).max() / np.abs(c_h).max()))
        got, want = np.array(depth_net_summary(d, c)), np.array(DEPTH_NET[k])
        worst["jax"] = max(worst["jax"], float(
            np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))))
    card.infer(images[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for im in images:
        card.infer(im)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(images) * 1e3
    log(f"[smoke] depth net on the card: {len(images)} views "
        f"{images[0].shape[:2]}, {ms:.2f} ms a view (host clock, maps back "
        f"on the host); the CPU port {worst['cpu']:.2e} and the JAX "
        f"package's numbers {worst['jax']:.2e} away at most")
    if not (worst["cpu"] <= DEPTH_NET_RTOL and worst["jax"] <= DEPTH_NET_RTOL):
        raise AssertionError(f"depth net: {worst} beyond {DEPTH_NET_RTOL}")
    return dict(ms=ms, **worst)


def hold_assembly_d(asm_in, timer, dev) -> list:
    """Scene D's dense XM^2 assemblies (phase 11): each pass's inputs
    (``asm_in``, recorded from its ``create_matrix_arrays`` calls)
    assembled twice more must give the same bits of C and Abar, the
    segment sums by frame and by landmark launched once each an assembly;
    the kernel held on each pass's layouts (:func:`hold_assembly_sums`);
    the first pass's assembly traced must show segment sums and no
    ``index_add_`` kernel.  Returns the kernel's cases."""
    import torch

    if len(asm_in) != 2:
        raise AssertionError(f"scene D refine: {len(asm_in)} dense "
                             f"assemblies, expected two passes")
    cases = []
    for p, (a, k) in enumerate(asm_in, 1):
        runs = [assemble(*a[:3], dev, k.get("precision", "f64"))
                for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(runs[0][:2],
                                                     runs[1][:2]))
        log(f"[smoke] scene D refine: XM^2 pass {p} assembly "
            f"({len(a[1])} observations; "
            f"{timer.totals[f'pass{p}_assemble']:.3f} s in the solve) twice: "
            f"{runs[0][2]:.3f} s, {runs[1][2]:.3f} s, sorted_segment_sum "
            f"launches {runs[0][3]}; C's and Abar's bits equal {same}")
        if not same:
            raise AssertionError(f"scene D refine: pass {p}'s assembly "
                                 f"does not repeat its bits")
        if sorted(runs[0][3].values()) != [1, 1] or not all(
                k.startswith(("assembly frame", "assembly landmark"))
                for k in runs[0][3]):
            raise AssertionError(f"scene D refine: pass {p}'s assembly "
                                 f"launched {runs[0][3]}")
        del runs
        cases += hold_assembly_sums(f"scene D refine XM^2 pass {p}", a[1],
                                    ("D refine XM^2",), dev)
    a, k = asm_in[0]
    work = device_work(lambda: assemble(*a[:3], dev,
                                        k.get("precision", "f64")))
    log(f"[smoke] scene D refine: XM^2 pass 1 assembly traced: "
        f"{work['launches']} kernels, {work['segsum']} segment sums, "
        f"{work['index_add']} index_add_ kernels, device busy "
        f"{work['busy_ms']:.3f} ms; top {work['top'][:4]}")
    if not work["segsum"] or work["index_add"]:
        raise AssertionError(f"scene D refine: the traced assembly shows "
                             f"{work['segsum']} segment sums and "
                             f"{work['index_add']} index_add_ kernels")
    return cases


def run_refine_d(dev, counts, scD, exp, lifted) -> list:
    """Phase 11: XM-SfM's last stage on scene D (``examples/05_refine.py``'s
    flow): planted outliers, ``relpose_filter`` with the relative poses of
    phase 9's export, ``xm2_solve`` at its defaults and ``refine_bundle``
    on the card, held against the JAX package and ground truth; the
    segment-sum kernel on the refine's two layouts; the tiny depth net; a
    second ``refine_bundle`` call repeating its bits and a short one traced.
    Returns the kernel's cases on the refine's layouts and on the XM^2
    passes' assembly layouts."""
    import torch

    from xmtpu_torch.pipeline import refine
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.relpose_filter import relpose_filter

    edges, weights, landmarks = lifted
    landmarks, planted = plant_outliers(landmarks, REFINE_D_OUTLIERS["seed"])
    rows = np.zeros((len(edges), 3))
    rows[:, 0] = np.arange(len(edges))          # rgbs carry the row ids
    t0 = time.perf_counter()
    e2, w2, l2, r2 = relpose_filter(edges, weights, landmarks, rows,
                                    exp.relposes, verbose=False)
    t_rf = time.perf_counter() - t0
    kept = np.zeros(len(edges), dtype=bool)
    kept[r2[:, 0].astype(np.int64)] = True
    got = dict(kept=int(kept.sum()), dropped=int((~kept).sum()))
    log(f"[smoke] scene D relpose_filter ({len(edges)} observations, "
        f"{int(planted.sum())} planted outliers, {len(exp.relposes)} "
        f"relative poses): {t_rf:.2f} s; {got} (JAX package "
        f"{ {k: REFINE_D[k] for k in got} }); planted removed "
        f"{(~kept & planted).sum() / planted.sum():.4f}, clean removed "
        f"{(~kept & ~planted).sum() / (~planted).sum():.4f}")
    for k, v in got.items():
        if abs(v - REFINE_D[k]) > REFINE_D_TOL["count"] * REFINE_D[k]:
            raise AssertionError(f"scene D relpose_filter: {k} {v} vs "
                                 f"{REFINE_D[k]}")

    # the dense assemblies' inputs are kept, to assemble again below
    reset_counts()
    with recorded_calls(xm2, "create_matrix_arrays") as asm_in:
        out, last, ranks, timer, wall = run_xm2_d(xm2, (e2, w2, l2), exp.N,
                                                  exp.M, dev)
    counts["D refine XM^2"] = read_counts()
    rot = rotation_error_stats(out.R_real, scD.R.transpose(0, 2, 1),
                               out.indices_all)
    log(f"[smoke] scene D refine: xm2_solve wall {wall:.2f} s, ranks "
        f"{ranks}, certified {last.certified} at rank {last.rank}, primal "
        f"{last.primal!r} ({float(last.primal).hex()}; JAX package "
        f"{REFINE_D['primal']!r}, rank "
        f"{REFINE_D['rank']}), lam {out.lam}, rotation errors {rot} "
        f"(JAX package {REFINE_D_XM2_ROT})")
    if not (last.certified and last.rank == REFINE_D["rank"]):
        raise AssertionError(f"scene D refine: XM^2 not certified at rank "
                             f"{REFINE_D['rank']}")
    if abs(last.primal - REFINE_D["primal"]) > (REFINE_D_TOL["primal"]
                                               * REFINE_D["primal"]):
        raise AssertionError(f"scene D refine: XM^2 primal {last.primal}")
    check_rotations("scene D refine XM^2", rot, REFINE_D_XM2_ROT)
    asm_cases = hold_assembly_d(asm_in, timer, dev)

    obs2d = out.landmarks[:, :2] / out.landmarks[:, 2:3]
    args = (out.edges, obs2d, out.R_real, out.t_est, out.p_est)
    reset_counts()
    refine.refine_bundle.host_reads = 0
    with _Recorder(refine) as rec:
        t0 = time.perf_counter()
        res = refine.refine_bundle(*args, device=dev)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
    counts["D refine"] = read_counts()
    reads = refine.refine_bundle.host_reads
    shapes = counts["D refine"]["sorted_segment_sum shapes"]
    log(f"[smoke] scene D refine_bundle ({len(out.edges)} observations, "
        f"{out.t_est.shape[1]} frames, {out.p_est.shape[1]} points): "
        f"{t_ref:.2f} s, {res.iterations} LM steps, final cost "
        f"{res.final_cost!r} ({float(res.final_cost).hex()}; JAX package "
        f"{REFINE_D['iterations']} steps, "
        f"{REFINE_D['final_cost']!r}); host reads {reads}; "
        f"sorted_segment_sum launches "
        f"{counts['D refine']['sorted_segment_sum']} by shape {shapes}")
    if reads != res.iterations:
        raise AssertionError(f"scene D refine: {reads} host reads over "
                             f"{res.iterations} LM steps")
    if not {"f64 D=6", "f64 D=3"} <= {k for k, v in shapes.items() if v > 0}:
        raise AssertionError(f"scene D refine: sums by {shapes}")
    launched_layouts(counts["D refine"], REFINE_LAYOUTS, "scene D refine")

    # the JAX package's run, and ground truth
    R_ref, c_ref = tail_poses(REFINE_D_POSES)
    N = res.t_est.shape[1]
    R_c2w = res.R_est.reshape(3, N, 3).transpose(1, 0, 2)
    dR = float(np.abs(R_c2w - R_ref).max())
    dc = float(np.abs(res.t_est.T - c_ref).max())
    dcost = abs(res.final_cost - REFINE_D["final_cost"]) / REFINE_D[
        "final_cost"]
    R, t, frames = refine_frames(res.R_est, res.t_est, out.indices_all)
    gt = tail_gt_errors(R, t, scD, frames)
    gt0 = tail_gt_errors(*refine_frames(out.R_real, out.t_est,
                                        out.indices_all)[:2], scD, frames)
    err0 = mean_reprojection_error(out.edges, obs2d, out.R_real, out.t_est,
                                   out.p_est)
    err1 = mean_reprojection_error(out.edges, obs2d, res.R_est, res.t_est,
                                   res.p_est)
    log(f"[smoke] scene D refine: final cost {dcost:.2e} relative, "
        f"rotations {dR:.2e} and centres {dc:.2e} from the JAX package's; "
        f"against GT {gt} (JAX package {REFINE_D_GT}; XM^2's output "
        f"{gt0}); mean reprojection error {err0:.6e} -> {err1:.6e}")
    if res.iterations != REFINE_D["iterations"] or dcost > REFINE_D_TOL[
            "cost"]:
        raise AssertionError(f"scene D refine: {res.iterations} LM steps, "
                             f"final cost {res.final_cost}")
    if not (dR <= REFINE_D_TOL["R"] and dc <= REFINE_D_TOL["centre"]):
        raise AssertionError(f"scene D refine: poses {dR:.2e} / {dc:.2e} "
                             f"from the JAX package's")
    for k, v in gt.items():
        if not v <= ROT_SLACK * REFINE_D_GT[k]:
            raise AssertionError(f"scene D refine: GT {k} {v:.3e} beyond "
                                 f"{ROT_SLACK} x the JAX package's")
    if not err1 < err0:
        raise AssertionError(f"scene D refine: reprojection error {err0} -> "
                             f"{err1}")
    log(f"[smoke] scene D refine steps (s): relpose_filter {t_rf:.2f}, "
        f"xm2_solve {wall:.2f}, refine_bundle {t_ref:.2f}")

    # the kernel on the refine's layouts: by frame (D = 6), by landmark
    cases = hold_tail_segsum([(name, *rec.layouts[name], D) for name, Ds
                              in REFINE_LAYOUTS.items() for D in Ds], dev)
    for c in cases:
        log(tail_case_line("refine", c))
    hold_depth_net(dev)

    # a second call on the same inputs gives the same bits
    t0 = time.perf_counter()
    again = refine.refine_bundle(*args, device=dev)
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(res, again))
    log(f"[smoke] scene D refine_bundle, a second call ({t_again:.2f} s): "
        f"the same bits {same}")
    if not same:
        raise AssertionError("scene D refine: two refine_bundle calls differ")

    # the card's work of one short call (REFINE_D_TRACED LM steps), traced
    # (tracing a whole call's ~170k launches took 34-43 s): its launches, no
    # scalar read, no copy to the host beyond one a LM step and the result,
    # no index_add_ kernel (the detector seen at work first), its device
    # busy time by kernel
    idx = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    ones = torch.ones(1 << 16, device=dev)
    probe = device_work(lambda: [torch.zeros(2, device=dev).index_add_(
        0, idx, ones).cpu() for _ in range(10)])
    if not probe["index_add"]:
        raise AssertionError("scene D refine: the trace shows no kernel of "
                             "a plain index_add_")
    short = []
    t0 = time.perf_counter()
    work = device_work(lambda: short.append(refine.refine_bundle(
        *args, max_iters=REFINE_D_TRACED, device=dev)))
    steps = short[-1].iterations
    log(f"[smoke] scene D refine_bundle, {steps} LM steps traced "
        f"({time.perf_counter() - t0:.2f} s): {work['launches']} kernel "
        f"launches, {work['scalar_reads']} scalar reads, "
        f"{work['d2h_copies']} device-to-host copies, {work['index_add']} "
        f"index_add_ kernels, device busy {work['busy_ms']:.1f} ms; by "
        f"kernel:")
    for name, n, ms in work["top"]:
        log(f"[smoke]   {ms:9.1f} ms {n:7d}  {name}")
    # the profiler may drop device events, never add them
    if (work["scalar_reads"] or work["d2h_copies"] > steps + 1
            or work["index_add"]):
        raise AssertionError(f"scene D refine: {work['scalar_reads']} scalar "
                             f"reads, {work['d2h_copies']} copies to the host "
                             f"over {steps} LM steps, {work['index_add']} "
                             f"index_add_ kernels")
    return cases, asm_cases


def traced_wall(fn):
    """``fn`` wrapped to record its own wall seconds (synchronised) in
    ``box["s"]``, for the idle share of a :func:`device_work` run."""
    import torch

    box = {}

    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        box["s"] = time.perf_counter() - t0

    return run, box


def busy_text(work, wall_s) -> str:
    return (f"device busy {work['busy_ms']:.1f} ms of {wall_s * 1e3:.1f} ms "
            f"traced (idle {1.0 - work['busy_ms'] / 1e3 / wall_s:.1%}), "
            f"{work['launches']} kernels")


def _parallel_rank(rank, port, qbin, dev_type, shape, backend, settings,
                   out_dir):
    """One rank of phase 12 (c): join the process group (``backend``, one
    slot on the card, ``cuda:rank`` under NCCL), load only this rank's rows
    of ``C`` from ``qbin`` through a memory map, run
    ``solve_arrays_distributed`` once timed and once traced (both ranks
    retry a trace the profiler dropped together, so their collectives stay
    in step), and write the result to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from xmtpu_torch.parallel import distributed as pd

    dev = torch.device(dev_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    pd.init_distributed(f"127.0.0.1:{port}", 2, rank,
                        initialization_timeout=120, device=dev,
                        backend=backend)
    mesh = pd.global_mesh(slots=1, device=dev)
    # the payload after the two-int header, read row by row
    rows = np.memmap(qbin, dtype=np.float64, mode="r", offset=8, shape=shape)
    comm = {"calls": 0, "s": 0.0}
    gather = dist.all_gather

    def timed_gather(*a, **k):
        t0 = time.perf_counter()
        out = gather(*a, **k)
        comm["calls"] += 1
        comm["s"] += time.perf_counter() - t0
        return out

    dist.all_gather = timed_gather

    def solve():
        return pd.solve_arrays_distributed(mesh, lambda a, b: rows[a:b],
                                           shape, **settings)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    reset_counts()
    sync()
    t0 = time.perf_counter()
    res = solve()
    sync()
    wall = time.perf_counter() - t0
    out = dict(rank=rank, backend=dist.get_backend(), device=str(dev),
               primal=res.primal, primal_hex=float(res.primal).hex(),
               certified=res.certified, o=res.rank, status=res.status,
               outer=res.outer_iters, inner=res.total_inner, wall_s=wall,
               gathers=comm["calls"], gather_s=comm["s"],
               launches=read_counts(),
               cert_path=res.stages[-1].get("cert_path"))
    if dev.type == "cuda":
        again, box = traced_wall(solve)
        for _ in range(3):
            try:
                work, ok = device_work(again, tries=1), 1
            except RuntimeError:
                work, ok = None, 0
            flag = torch.tensor([ok], device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            if int(flag.item()):
                break
        else:
            raise RuntimeError("phase 12 (c): the profiler recorded nothing "
                               "in three traced runs")
        out.update(busy_ms=work["busy_ms"], traced_s=box["s"],
                   traced_kernels=work["launches"],
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _nccl_refusal_rank(rank, port, out_dir):
    """One of two NCCL ranks on the one card (``device=None``: the card
    ``rank % 1``): ``init_distributed`` must raise ``ValueError`` once
    joined, on every rank, and leave the process group; the error is
    written to ``out_dir/rank<r>.json``."""
    import torch.distributed as dist

    from xmtpu_torch.parallel import distributed as pd

    try:
        pd.init_distributed(f"127.0.0.1:{port}", 2, rank,
                            initialization_timeout=60)
        error = ""
    except ValueError as e:
        error = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "error": error,
                   "initialized": dist.is_initialized()}, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def port_free() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(qbin, dev, shape, backend, out_dir) -> list:
    """Phase 12 (c)'s two solving ranks (:func:`spawn_ranks`)."""
    return spawn_ranks(_parallel_rank, (port_free(), qbin, dev.type, shape,
                                        backend, PAR_B, out_dir),
                       backend, out_dir)


def spawn_ranks(target, args, what, out_dir) -> list:
    """Two spawned processes ``target(rank, *args)``; each must exit 0
    within ``PAR_RANK_TIMEOUT`` (a rank still alive then is killed), and
    write ``out_dir/rank<r>.json``, which are returned."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r,) + tuple(args))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_RANK_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(c != 0 for c in codes):
        raise AssertionError(f"phase 12 (c) {what}: rank exit codes "
                             f"{codes}, {len(alive)} killed at the time limit")
    out = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def hold_step_on_cards(Q_C, dev) -> None:
    """``tcg_step`` at scene C's n (a cluster of ``MAX_CLUSTER`` blocks) on
    the f32 phase's first inputs: launched on the lead card ``dev``, then
    once on every other card with the lead current, each on a copy of the
    same inputs, and each giving the lead's bits."""
    import torch

    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.ops.qop import cast_qop

    n = Q_C.n_cameras
    inp = f32_phase_inputs(cast_qop(Q_C, torch.float32),
                           mf.identity_frames(n, 3, device=dev),
                           torch.ones((n,), dtype=torch.float64, device=dev))
    _, const, state, sc, cfgsc = step_inputs(inp)
    max_inner = int(inp["cfg"].max_inner)

    def launch_on(card):
        c = [v.to(card) for v in const.values()]
        st = [t.to(card) for t in state]
        sc_ = sc.to(card)
        with torch.cuda.device(dev):
            ft.tcg_step(*c, *st, sc_, cfgsc.to(card), max_inner)
        return [t.cpu() for t in (c[-1], *st, sc_)]

    lead = launch_on(dev)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
             if i != dev.index]
    for card in cards:
        got = launch_on(card)
        if not all(torch.equal(a, b) for a, b in zip(got, lead)):
            raise AssertionError(f"phase 12: tcg_step at n={n} on {card} "
                                 f"with {dev} current differs from {dev}'s")
    log(f"[smoke] parallel: tcg_step at n={n} "
        f"({geometry_text(*ft.step_geometry(n, 3))}) on "
        f"{[str(c) for c in cards]} with {dev} current: {dev}'s bits")


def run_parallel(dev, counts, card, primal_B, Q_C) -> dict:
    """Phase 12: the parallel paths.  (a) scene B's dense C row-sharded over
    a 4-slot mesh (four cards where there are four, else four slots on the
    card): one ``sharded_tr_step`` against the single-card outer step, then
    ``solve_arrays_sharded`` at phase 4's settings; (b) scene C's
    ``SchurQ`` sharded by ``shard_schurq`` over the same mesh and solved at
    phase 7's settings, with a traced window of the f32 phase; (c) scene B's
    ``C`` written as ``Q.bin`` and solved by two ranks on the card over
    gloo, each loading only its rows (and over NCCL, one rank a card, where
    there are two cards).  Returns (b)'s segment sums a slot and its
    per-slot counts, for the report."""
    import shutil
    import tempfile

    import torch

    from xmtpu_torch.io.bin_format import save_matrix_to_bin
    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.ops import segsum as ss
    from xmtpu_torch.ops.qop import DenseQ, cast_qop
    from xmtpu_torch.parallel import mesh as pm
    from xmtpu_torch.solver import trust_region as tr

    cards = torch.cuda.device_count()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if cards >= PAR_SLOTS:
        mesh = pm.Mesh([torch.device("cuda", i) for i in range(PAR_SLOTS)])
        mesh_tag = f"{PAR_SLOTS} cards"
    else:
        mesh = pm.Mesh([dev] * PAR_SLOTS)
        mesh_tag = (f"Mesh(({dev},) * {PAR_SLOTS}): {PAR_SLOTS} slots on one "
                    f"card")
    log(f"[smoke] parallel: {mesh_tag}; {card}")
    if cards > 1:
        hold_step_on_cards(Q_C, dev)
    else:
        log("[smoke] parallel: tcg_step on a second card: not run (1 card)")

    # ---- (a) scene B dense, row-sharded ----
    C_B = scene(SCENE_B, dev)[0]
    nB = C_B.shape[0] // 3
    R0 = mf.identity_frames(nB, 3, device=dev)
    s0 = torch.ones((nB,), dtype=torch.float64, device=dev)
    loss0 = float(mf.objective(DenseQ(C_B).apply, R0, s0, 0.0))
    Rd, sd, ld = pm._one_outer_step(DenseQ(C_B), R0, s0)
    t0 = time.perf_counter()
    Rs, s_s, ls = pm.sharded_tr_step(mesh, C_B, R0, s0)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    gaps = (float(torch.max(torch.abs(Rs - Rd))),
            float(torch.max(torch.abs(s_s - sd) / torch.abs(sd))),
            abs(float(ls) - float(ld)) / abs(float(ld)))
    log(f"[smoke] parallel (a) sharded_tr_step: loss {loss0!r} -> "
        f"{float(ls)!r} ({t_step:.3f} s); against the single-card outer "
        f"step: R' "
        f"{gaps[0]:.2e} (abs), s' {gaps[1]:.2e}, loss' {gaps[2]:.2e} (rel)")
    if not float(ls) < loss0:
        raise AssertionError("phase 12 (a): the sharded step did not lower "
                             "the loss")
    if not (torch.allclose(Rs, Rd, rtol=1e-9, atol=1e-12)
            and torch.allclose(s_s, sd, rtol=1e-9) and gaps[2] <= 1e-9):
        raise AssertionError(f"phase 12 (a): the sharded outer step is "
                             f"{gaps} from the single-card one")
    Cs = pm.shard_problem(mesh, C_B, R0, s0)[0]
    log(f"[smoke] parallel (a) slabs: rows "
        f"{[s.shape[0] for s in Cs.slabs]}, bytes {Cs.slab_bytes()}")
    del Cs, Rs, s_s, Rd, sd
    reset_counts()
    t0 = time.perf_counter()
    res_a = pm.solve_arrays_sharded(mesh, C_B, **PAR_B)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    counts["P dense"] = read_counts()
    again, box = traced_wall(lambda: pm.solve_arrays_sharded(mesh, C_B,
                                                             **PAR_B))
    work_a = device_work(again)
    path_a = res_a.stages[-1]["cert_path"]
    log(f"[smoke] parallel (a) solve_arrays_sharded scene B: rank "
        f"{res_a.rank} status {res_a.status} primal {res_a.primal!r} "
        f"({float(res_a.primal).hex()}; "
        f"{res_a.primal - primal_B:+.3e} from phase 4's single-card "
        f"{primal_B!r}; reference {PRIMAL_B!r}) outer {res_a.outer_iters} "
        f"inner {res_a.total_inner}; certificate: matvec flow, path "
        f"{path_a}; wall {wall_a:.2f} s; {busy_text(work_a, box['s'])}; "
        f"launches {counts['P dense']}; {card}")
    if not (res_a.certified and res_a.rank == 3 and res_a.status == 1
            and path_a != "dense"):
        raise AssertionError("phase 12 (a): not certified at rank 3 by the "
                             "matvec certificate")
    if abs(res_a.primal - PRIMAL_B) > RTOL_PRIMAL * PRIMAL_B:
        raise AssertionError(f"phase 12 (a) primal {res_a.primal} vs "
                             f"{PRIMAL_B}")
    if (counts["P dense"]["tcg_step"] <= 0
            or counts["P dense"]["tcg_step_dense"] != 0):
        raise AssertionError(f"phase 12 (a): expected tcg_step launches and "
                             f"no tcg_step_dense, got {counts['P dense']}")

    # ---- (b) scene C's SchurQ, sharded ----
    t0 = time.perf_counter()
    Qs = pm.shard_schurq(mesh, Q_C)
    torch.cuda.synchronize()
    t_shard = time.perf_counter() - t0
    log(f"[smoke] parallel (b) shard_schurq scene C ({t_shard:.2f} s): "
        f"cameras {[s.cams for s in Qs.slots]}, VT_inv panels "
        f"{[tuple(s.q.VT_inv.shape) for s in Qs.slots]}, edges a slot by "
        f"landmark {[s.q.l_l.shape[0] for s in Qs.slots]}, by frame "
        f"{[s.q.f_f.shape[0] for s in Qs.slots]}")
    reset_counts()
    t0 = time.perf_counter()
    res_b = pm.solve_arrays_sharded(mesh, Qs, **PAR_C)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    counts["P SchurQ"] = read_counts()
    st = {"slot_sums": list(Qs.stats["slot_sums"])}
    nC = Q_C.n_cameras
    q32 = cast_qop(Qs, torch.float32)
    R0c = mf.identity_frames(nC, 3, dtype=torch.float32, device=dev)
    s0c = torch.ones((nC,), dtype=torch.float32, device=dev)
    cfg = tr.TRConfig.for_dtype(torch.float32, max_outer=PAR_TRACED_OUTER,
                                max_inner=100)
    again, box = traced_wall(lambda: tr.trust_region_solve(
        q32, R0c, s0c, cfg=cfg, dtype=torch.float32, device=dev))
    work_b = device_work(again)
    del q32
    log(f"[smoke] parallel (b) solve_arrays_sharded scene C: rank "
        f"{res_b.rank} status {res_b.status} primal {res_b.primal!r} "
        f"({float(res_b.primal).hex()}; reference {PRIMAL_C!r}) outer "
        f"{res_b.outer_iters} inner "
        f"{res_b.total_inner}, certificate path "
        f"{res_b.stages[-1]['cert_path']}; wall {wall_b:.2f} s; segment "
        f"sums a slot {st['slot_sums']}, "
        f"by shape {counts['P SchurQ']['sorted_segment_sum shapes']}; "
        f"launches {counts['P SchurQ']}; the f32 phase's first "
        f"{PAR_TRACED_OUTER} outer iterations traced: "
        f"{busy_text(work_b, box['s'])}; top {work_b['top'][:4]}; {card}")
    if not (res_b.certified and res_b.rank == 3 and res_b.status == 1):
        raise AssertionError("phase 12 (b): not certified at rank 3")
    if abs(res_b.primal - PRIMAL_C) > RTOL_IMPLICIT * PRIMAL_C:
        raise AssertionError(f"phase 12 (b) primal {res_b.primal} vs "
                             f"{PRIMAL_C}")
    seg = counts["P SchurQ"]["sorted_segment_sum"]
    if min(st["slot_sums"]) <= 0 or seg != sum(st["slot_sums"]):
        raise AssertionError(f"phase 12 (b): {seg} segment-sum launches "
                             f"for {st} calls on the card")
    if counts["P SchurQ"]["tcg_step"] <= 0:
        raise AssertionError("phase 12 (b): tcg_step never launched")
    del Qs

    # ---- (c) two processes on the card ----
    tmp = tempfile.mkdtemp(prefix="xmtpu_smoke_")
    try:
        qbin = os.path.join(tmp, "Q.bin")
        t0 = time.perf_counter()
        # Q.bin stores column-major: C_B^T written so gives C_B's rows in
        # order after the header (C_B is symmetric up to its last bits)
        save_matrix_to_bin(qbin, C_B.T.cpu().numpy())
        log(f"[smoke] parallel (c) Q.bin: {os.path.getsize(qbin)} bytes "
            f"({time.perf_counter() - t0:.2f} s)")
        shape = tuple(C_B.shape)
        del C_B
        backends = ["gloo"] + (["nccl"] if cards >= 2 else [])
        for backend in backends:
            t0 = time.perf_counter()
            ranks = run_ranks(qbin, dev, shape, backend, tmp)
            wall_c = time.perf_counter() - t0
            for r in ranks:
                counts[f"P {backend} rank {r['rank']}"] = r["launches"]
                traced = (f"traced again: device busy {r['busy_ms']:.1f} ms "
                          f"of {r['traced_s'] * 1e3:.1f} ms (idle "
                          f"{1 - r['busy_ms'] / 1e3 / r['traced_s']:.1%}); "
                          f"device memory peak {r['peak_gib']:.3f} GiB"
                          if "busy_ms" in r else "not traced (host ranks)")
                log(f"[smoke] parallel (c) {backend} over "
                    f"{dev.type.upper()} tensors, rank {r['rank']} on "
                    f"{r['device']}: rank {r['o']} status "
                    f"{r['status']} primal {r['primal']!r} ({r['primal_hex']}"
                    f"; {r['primal'] / res_a.primal - 1:+.3e} from (a)) outer "
                    f"{r['outer']} inner {r['inner']}, certificate path "
                    f"{r['cert_path']}; solve wall {r['wall_s']:.2f} s, "
                    f"{r['gathers']} all_gather calls taking "
                    f"{r['gather_s']:.3f} s on the host; {traced}; launches "
                    f"{r['launches']}; {card}")
            log(f"[smoke] parallel (c) {backend}: two ranks, wall "
                f"{wall_c:.1f} s with start-up")
            if not all(r["certified"] and r["o"] == 3 and r["status"] == 1
                       and r["backend"] == backend for r in ranks):
                raise AssertionError(f"phase 12 (c) {backend}: not certified "
                                     f"at rank 3 on every rank")
            if ranks[0]["primal_hex"] != ranks[1]["primal_hex"]:
                raise AssertionError(f"phase 12 (c) {backend}: the ranks' "
                                     f"primals differ")
            if abs(ranks[0]["primal"] - PRIMAL_B) > RTOL_PRIMAL * PRIMAL_B:
                raise AssertionError(f"phase 12 (c) {backend} primal "
                                     f"{ranks[0]['primal']} vs {PRIMAL_B}")
            if min(r["launches"]["tcg_step"] for r in ranks) <= 0:
                raise AssertionError(f"phase 12 (c) {backend}: tcg_step "
                                     f"never launched on a rank")
        if cards < 2:
            log("[smoke] parallel (c) nccl: not run (1 card)")
            t0 = time.perf_counter()
            refusals = spawn_ranks(_nccl_refusal_rank, (port_free(), tmp),
                                   "nccl refusal", tmp)
            log(f"[smoke] parallel (c) two NCCL ranks on the one card: "
                f"refused on both ranks before a communicator "
                f"({time.perf_counter() - t0:.1f} s with start-up): "
                f"{refusals[0]['error']}")
            if not all("share the card" in r["error"]
                       and not r["initialized"] for r in refusals):
                raise AssertionError(f"phase 12 (c): two NCCL ranks on one "
                                     f"card were not refused: {refusals}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return st


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    return run(torch.device("cuda"), card_line())


def run(dev, card: str) -> int:
    import torch

    import xmtpu_torch  # noqa: F401  (sets the TF32 switches)
    from xmtpu_torch import _build
    from xmtpu_torch.ops import fused_tcg as ft
    from xmtpu_torch.ops import manifold as mf
    from xmtpu_torch.ops.qop import DenseQ, cast_qop
    from xmtpu_torch.solver import trust_region as tr
    from xmtpu_torch.ops.schurq import SchurQ
    from xmtpu_torch.pipeline import xm2
    from xmtpu_torch.pipeline.synthetic import make_scene_window
    from xmtpu_torch.solver.certificate import certify
    from xmtpu_torch.solver.staircase import solve_arrays
    from xmtpu_torch.utils.timer import PhaseTimer

    log(f"[smoke] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda} numpy {np.__version__}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build_all()
    log(f"[smoke] build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(report) or 'cached'})")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    fl = measure_floors(dev)
    log(f"[smoke] floors: dependent add {fl['t_add_ns'][4]:.3f} ns (f32), "
        f"{fl['t_add_ns'][8]:.3f} ns (f64); empty launch "
        f"{fl['launch_floor_ms']:.5f} ms")

    # ---- 2. kernels vs plain ---------------------------------------------
    lam = 0.0
    f32 = torch.float32
    C_A, gen_A, asm_A, lay_A, scA = scene(SCENE_A, dev)
    nA = C_A.shape[0] // 3
    qA, qA32 = DenseQ(C_A), DenseQ(C_A.to(f32))
    cases = []
    R3 = mf.identity_frames(nA, 3, device=dev)
    ones = torch.ones((nA,), dtype=torch.float64, device=dev)
    cases.append(("A o=3", qA, f32_phase_inputs(qA32, R3, ones), True))
    # later in the phase the Steihaug loop runs tens of iterations before
    # its superlinear stop (the first outer iteration stops at the boundary)
    cases.append((f"A o=3 outer {LONG_A}", qA,
                  f32_phase_inputs(qA32, R3, ones, LONG_A), True))
    # the rank-4 stage's start: rank-3 solution + escape linesearch
    r3 = solve_arrays(C_A, max_rank=3, tol=1e-6, precision="mixed",
                      inner_f32=True, verbose=False, device=dev)
    R3s = torch.as_tensor(r3.R, device=dev).reshape(nA, 3, 3)
    s3 = torch.as_tensor(r3.s_ex, device=dev)
    cert = certify(C_A, mf.flatten(mf.scale_blocks(R3s, s3)), lam, r3.primal,
                   device=dev)
    esc = (cert.v.reshape(nA, 3) / s3[:, None]).reshape(-1)
    R4 = torch.cat([R3s, torch.zeros((nA, 3, 1), dtype=torch.float64,
                                      device=dev)], dim=2)
    R4, _f, ok = tr._escape_linesearch(C_A, R4, s3, esc, 1.0, lam,
                                       tr.TRConfig())
    if not ok:
        raise AssertionError("scene A escape linesearch failed")
    cases.append(("A o=4", qA, f32_phase_inputs(qA32, R4, s3), True))
    del qA32
    C_512 = scene(SCENE_512, dev)[0]
    n512 = C_512.shape[0] // 3
    cases.append(("n512 o=3", DenseQ(C_512), f32_phase_inputs(
        DenseQ(C_512.to(f32)), mf.identity_frames(n512, 3, device=dev),
        torch.ones((n512,), dtype=torch.float64, device=dev)), True))
    del C_512
    C_B, gen_B, asm_B, _, scB = scene(SCENE_B, dev)
    nB = C_B.shape[0] // 3
    qB, qB32 = DenseQ(C_B), DenseQ(C_B.to(f32))
    RB = mf.identity_frames(nB, 3, device=dev)
    onesB = torch.ones((nB,), dtype=torch.float64, device=dev)
    cases.append(("B o=3", qB, f32_phase_inputs(qB32, RB, onesB), False))
    cases.append((f"B o=3 outer {LONG_B}", qB,
                  f32_phase_inputs(qB32, RB, onesB, LONG_B), False))
    del qB32

    held = {}
    for case in cases:
        held[case[0]] = hold_case(*case)
    del cases, qA, qB

    # ---- 3. scene A: the mixed certified staircase, twice -------------------
    log(f"[smoke] scene A: make_scene {gen_A:.2f} s, assembly {asm_A:.3f} s "
        f"(first CUDA use), sorted_segment_sum launches {lay_A}")
    fused_loop = ft.inner_tcg_fused

    def staircase_a(verbose):
        """Scene A assembled anew and its mixed staircase: ``(C, result,
        assembly seconds, its launches by layout, staircase wall, the fused
        loops' iterations)``.  Each fused loop enqueues FLAG_EVERY launches
        between reads of the done flag, so a loop that ran i iterations
        enqueued FLAG_EVERY * ceil(i / FLAG_EVERY)."""
        iters = []

        def counted_loop(*a, **k):
            r = fused_loop(*a, **k)
            iters.append(r[5])
            return r

        ft.inner_tcg_fused = counted_loop
        try:
            C, _, t_asm, lay = assemble(scA.weights, scA.edges,
                                        scA.landmarks, dev)
            t0 = time.perf_counter()
            res = solve_arrays(C, max_rank=6, tol=1e-6, precision="mixed",
                               inner_f32=True, verbose=verbose, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ft.inner_tcg_fused = fused_loop
        return C, res, t_asm, lay, wall, iters

    reset_counts()
    C_A1, res_A, asm_A1, lay_A1, wall_A, fused_iters = staircase_a(True)
    counts = {"A": read_counts()}
    launches_A = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    enqueued_A = sum(ft.FLAG_EVERY * max(1, -(-i // ft.FLAG_EVERY))
                     for i in fused_iters)
    log(f"[smoke] scene A: assembly {asm_A1:.3f} s, sorted_segment_sum "
        f"launches {lay_A1}; rank {res_A.rank} status {res_A.status} primal "
        f"{res_A.primal!r} ({float(res_A.primal).hex()}) gap "
        f"{res_A.gap:.3e} lam_min {res_A.lam_min:.3e} outer "
        f"{res_A.outer_iters} inner {res_A.total_inner} wall {wall_A:.2f} s "
        f"launches tcg_step/tcg_step_dense {launches_A}; {len(fused_iters)} "
        f"fused loops ran {sum(fused_iters)} inner iterations and enqueued "
        f"{enqueued_A}")
    for st in res_A.stages:
        log(f"[smoke] scene A stage {st}")
    if not (res_A.certified and res_A.rank == 4 and res_A.status == 1):
        raise AssertionError("scene A: not certified at rank 4")
    if abs(res_A.primal - PRIMAL_A) > RTOL_PRIMAL * PRIMAL_A:
        raise AssertionError(f"scene A primal {res_A.primal} vs {PRIMAL_A}")
    if launches_A != (0, enqueued_A) or enqueued_A <= 0:
        raise AssertionError(f"scene A: expected one tcg_step_dense launch "
                             f"for each of {enqueued_A} enqueued iterations "
                             f"and no tcg_step, got {launches_A}")
    if not (lay_A1.get("assembly frame f64 D=13") == 1
            and lay_A1.get("assembly landmark f64 D=1") == 1):
        raise AssertionError(f"scene A: the assembly's segment sums "
                             f"launched {lay_A1}")
    # the assembly and the staircase again: the same bits of C (also
    # phase 2's), the same primal bits, iterations and launches
    reset_counts()
    C_A2, res_A2, asm_A2, _, wall_A2, iters_A2 = staircase_a(False)
    counts_A2 = read_counts()
    same_C = torch.equal(C_A1, C_A2) and torch.equal(C_A1, C_A)
    same_run = (float(res_A2.primal).hex() == float(res_A.primal).hex()
                and (res_A2.rank, res_A2.outer_iters, res_A2.total_inner)
                == (res_A.rank, res_A.outer_iters, res_A.total_inner)
                and iters_A2 == fused_iters and counts_A2 == counts["A"])
    log(f"[smoke] scene A again: assembly {asm_A2:.3f} s, C's bits equal "
        f"{same_C}; staircase wall {wall_A2:.2f} s, primal "
        f"{float(res_A2.primal).hex()} outer {res_A2.outer_iters} inner "
        f"{res_A2.total_inner}, launches {counts_A2}: the same run {same_run}")
    if not (same_C and same_run):
        raise AssertionError("scene A: a second assembly and staircase do "
                             "not repeat the first's bits")
    del C_A1, C_A2
    asm_cases = hold_assembly_sums("scene A assembly", scA.edges, ("A",),
                                   dev)
    t0 = time.perf_counter()
    res_A_cpu = solve_arrays(C_A.cpu(), max_rank=6, tol=1e-6,
                             precision="mixed", inner_f32=True,
                             verbose=False, device="cpu")
    log(f"[smoke] scene A on the CPU, the card's C: rank {res_A_cpu.rank} "
        f"primal {res_A_cpu.primal!r} ({float(res_A_cpu.primal).hex()}) "
        f"outer {res_A_cpu.outer_iters} inner {res_A_cpu.total_inner} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not (res_A_cpu.certified and res_A_cpu.rank == res_A.rank):
        raise AssertionError("scene A: CUDA and CPU runs disagree")
    if abs(res_A_cpu.primal - res_A.primal) > 1e-5 * abs(res_A.primal):
        raise AssertionError("scene A: CUDA and CPU primals disagree")

    # ---- 4. scene B: the split variant -------------------------------------
    reset_counts()
    C_B1, _, asm_B1, lay_B1 = assemble(scB.weights, scB.edges, scB.landmarks,
                                       dev)
    t0 = time.perf_counter()
    res_B = solve_arrays(C_B1, max_rank=6, tol=1e-3, precision="mixed",
                         inner_f32=True, verbose=True, device=dev)
    torch.cuda.synchronize()
    wall_B = time.perf_counter() - t0
    counts["B"] = read_counts()
    launches_B = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    same_B = torch.equal(C_B1, C_B)
    log(f"[smoke] scene B: make_scene {gen_B:.2f} s, assembly {asm_B1:.3f} s "
        f"({asm_B:.3f} s in phase 2), sorted_segment_sum launches {lay_B1}; "
        f"C's bits equal phase 2's {same_B}")
    if not same_B:
        raise AssertionError("scene B: two assemblies give different bits")
    del C_B1
    asm_cases += hold_assembly_sums("scene B assembly", scB.edges, ("B",),
                                    dev)
    log(f"[smoke] scene B: rank {res_B.rank} status {res_B.status} primal "
        f"{res_B.primal!r} ({float(res_B.primal).hex()}) gap "
        f"{res_B.gap:.3e} lam_min {res_B.lam_min:.3e} outer "
        f"{res_B.outer_iters} inner {res_B.total_inner} wall "
        f"{wall_B:.2f} s launches tcg_step/tcg_step_dense {launches_B}")
    for st in res_B.stages:
        log(f"[smoke] scene B stage {st}")
    if not (res_B.certified and res_B.rank == 3 and res_B.status == 1):
        raise AssertionError("scene B: not certified at rank 3")
    if abs(res_B.primal - PRIMAL_B) > RTOL_PRIMAL * PRIMAL_B:
        raise AssertionError(f"scene B primal {res_B.primal} vs {PRIMAL_B}")
    if launches_B[0] <= 0 or launches_B[1] != 0:
        raise AssertionError(f"scene B: expected split-variant launches only, "
                             f"got tcg_step/tcg_step_dense {launches_B}")

    del C_A, C_B

    # ---- 5. scene C: the operator choice, and the segment-sum kernels -------
    t0 = time.perf_counter()
    scC = make_scene_window(**SCENE_C)
    gen_C = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Q_C, Abar_C, impl_C = xm2._assemble_operator(
        scC.weights, scC.edges, scC.landmarks, True, "auto", device=dev)
    torch.cuda.synchronize()
    asm_C = time.perf_counter() - t0
    log(f"[smoke] scene C: n={scC.N} m={scC.M} E={len(scC.edges)}; "
        f"make_scene_window {gen_C:.2f} s, SchurQ build {asm_C:.2f} s, "
        f"device memory peak of the build "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (impl_C and isinstance(Q_C, SchurQ) and Abar_C is None):
        raise AssertionError(f"scene C: the operator choice took "
                             f"{type(Q_C).__name__}, not SchurQ")
    seg_cases = hold_segsum(Q_C, dev)
    for c in seg_cases:
        log(f"[smoke] segsum {c['tag']}: err {c['max_abs_err']:.2e} "
            f"(rel {c['max_rel_err']:.1e}) {c['ms']:.4f} ms plain "
            f"{c['plain_ms']:.4f} ms index_add_ {c['library_ms']:.4f} ms "
            f"bound {c['bound'][0]:.5f} ms ({c['bound'][1]}, "
            f"{c['bound'][2]}) chain floor {c['chain_floor']:.5f} ms"
            + (f"; earlier design {c['prev_ms']:.4f} ms" if c["prev_ms"]
               else ""))
    # tcg_step at the implicit size: the split variant on the f32 cast of
    # Q_C, the f64 loop on Q_C itself
    nC = scC.N
    qC32 = cast_qop(Q_C, f32)
    RC = mf.identity_frames(nC, 3, device=dev)
    onesC = torch.ones((nC,), dtype=torch.float64, device=dev)
    for tag, outer in (("C o=3", 0), (f"C o=3 outer {LONG_C}", LONG_C)):
        held[tag] = hold_case(tag, Q_C, f32_phase_inputs(qC32, RC, onesC,
                                                         outer), False)
    if held[f"C o=3 outer {LONG_C}"]["loop"][1] < LONG_C_ITERS:
        raise AssertionError(f"scene C outer {LONG_C}: the Steihaug loop ran "
                             f"{held[f'C o=3 outer {LONG_C}']['loop']}, "
                             f"expected at least {LONG_C_ITERS} inner "
                             f"iterations")
    del qC32

    # ---- 6. scene B through the implicit operator ---------------------------
    carried = hold_carried_operator(scB, dev)
    log(f"[smoke] scene B SchurQ built on the host, moved to the card: "
        f"kernel launched, bits repeat; (card, host) relative distance from "
        f"the exact host apply {carried}")
    t0 = time.perf_counter()
    Q_B = SchurQ.build(scB.weights, scB.edges, scB.landmarks, device=dev)
    torch.cuda.synchronize()
    build_B = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res_Bi = solve_arrays(Q_B, max_rank=6, tol=1e-3, precision="mixed",
                          inner_f32=True, edge_tf=True, verbose=True,
                          device=dev)
    torch.cuda.synchronize()
    wall_Bi = time.perf_counter() - t0
    counts["B implicit"] = read_counts()
    log(f"[smoke] scene B implicit: build {build_B:.2f} s; rank {res_Bi.rank} "
        f"status {res_Bi.status} primal {res_Bi.primal!r} (reference "
        f"{PRIMAL_B_IMPLICIT!r}; {res_Bi.primal / DENSE_ANCHOR_B - 1:+.3e} "
        f"from the dense anchor) gap {res_Bi.gap:.3e} lam_min "
        f"{res_Bi.lam_min:.3e} outer {res_Bi.outer_iters} inner "
        f"{res_Bi.total_inner} wall {wall_Bi:.2f} s launches "
        f"{counts['B implicit']}")
    for st in res_Bi.stages:
        log(f"[smoke] scene B implicit stage {st}")
    if not (res_Bi.certified and res_Bi.rank == 3 and res_Bi.status == 1
            and res_Bi.stages[-1]["cert_path"] != "dense"):
        raise AssertionError("scene B implicit: not certified at rank 3 by "
                             "the matvec certificate")
    if abs(res_Bi.primal - PRIMAL_B_IMPLICIT) > (RTOL_IMPLICIT
                                                 * PRIMAL_B_IMPLICIT):
        raise AssertionError(f"scene B implicit primal {res_Bi.primal} vs "
                             f"{PRIMAL_B_IMPLICIT}")
    del Q_B

    # ---- 7. scene C: xm2's solve and recovery -------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res_C, rec_C = xm2._solve_recover(Q_C, None, True, 5, 1e-1, 0.0, 1000.0,
                                      True, "mixed", device=dev)
    torch.cuda.synchronize()
    wall_C = time.perf_counter() - t0
    counts["C"] = read_counts()
    rot_C = rotation_error_stats(rec_C[0], scC.R_gt)
    log(f"[smoke] scene C: rank {res_C.rank} status {res_C.status} primal "
        f"{res_C.primal!r} (reference {PRIMAL_C!r}) gap {res_C.gap:.3e} "
        f"lam_min {res_C.lam_min:.3e} outer {res_C.outer_iters} inner "
        f"{res_C.total_inner}; solve+recover wall {wall_C:.2f} s; rotation "
        f"errors {rot_C} (reference {ROT_C}); launches {counts['C']}; "
        f"device memory peak of the solve "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for st in res_C.stages:
        log(f"[smoke] scene C stage {st}")
    if not (res_C.certified and res_C.rank == 3 and res_C.status == 1):
        raise AssertionError("scene C: not certified at rank 3")
    if abs(res_C.primal - PRIMAL_C) > RTOL_IMPLICIT * PRIMAL_C:
        raise AssertionError(f"scene C primal {res_C.primal} vs {PRIMAL_C}")
    check_rotations("scene C", rot_C, ROT_C)
    if min(counts["C"][k] for k in ("sorted_segment_sum", "tcg_step",
                                     "schurq_product")) <= 0:
        raise AssertionError(f"scene C: a kernel never launched {counts['C']}")
    # tcg_step's device time inside the solve, where a SchurQ apply runs
    # between its launches (a second, traced solve; as chip_profile.py reads)
    step_in_C = kernel_mean_ms(lambda: xm2._solve_recover(
        Q_C, None, True, 5, 1e-1, 0.0, 1000.0, False, "mixed", device=dev),
        "tcg_step_kernel")
    log(f"[smoke] scene C traced solve: tcg_step {step_in_C[0]:.4f} ms a "
        f"launch over {step_in_C[1]} launches")
    watch_scene_c(Q_C, scC, res_C, dev)

    # ---- 8. xm2_solve(implicit=True) on scene B ----------------------------
    timer = PhaseTimer()
    reset_counts()
    t0 = time.perf_counter()
    res_X = xm2.xm2_solve(scB.edges.copy(), scB.weights.copy(),
                          scB.landmarks.copy(), scB.rgbs.copy(), scB.N,
                          scB.M, implicit=True, verbose=False, timer=timer,
                          device=dev)
    torch.cuda.synchronize()
    wall_X = time.perf_counter() - t0
    counts["xm2 B"] = read_counts()
    rot_X = rotation_error_stats(res_X.R_real, scB.R_gt, res_X.indices_all)
    log(f"[smoke] xm2_solve(implicit=True) scene B: wall {wall_X:.2f} s, lam "
        f"{res_X.lam}, rotation errors {rot_X} (reference {ROT_XM2_B}); "
        f"launches {counts['xm2 B']}; phases:")
    for line in timer.report().splitlines():
        log(f"[smoke]   {line}")
    check_rotations("xm2_solve scene B", rot_X, ROT_XM2_B)

    # ---- 9. scene D: database -> mapper -> lifting -> XM^2 ----------------
    # the phase's own peak: above what phases 1-8 still hold when it starts
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    scD, exp_D, lifted_D, frame_cases, asm_D = run_scene_d(dev, counts)
    asm_cases += asm_D
    log(f"[smoke] scene D: phase wall {time.perf_counter() - t0:.1f} s, "
        f"device memory peak "
        f"{(torch.cuda.max_memory_allocated() - held_before) / 2**30:.3f} "
        f"GiB above the {held_before / 2**30:.3f} GiB held when it started")

    # ---- 10. scene D: the mapper's tail stages 5-8 --------------------------
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tail_cases = run_scene_d_tail(dev, counts)
    log(f"[smoke] scene D tail: phase wall {time.perf_counter() - t0:.1f} s, "
        f"device memory peak "
        f"{(torch.cuda.max_memory_allocated() - held_before) / 2**30:.3f} "
        f"GiB above the {held_before / 2**30:.3f} GiB held when it started")

    # ---- 11. scene D: relpose filter, XM^2 and the LM refinement ------------
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    refine_cases, asm_D = run_refine_d(dev, counts, scD, exp_D, lifted_D)
    asm_cases += asm_D
    log(f"[smoke] scene D refine: phase wall {time.perf_counter() - t0:.1f} "
        f"s, device memory peak "
        f"{(torch.cuda.max_memory_allocated() - held_before) / 2**30:.3f} "
        f"GiB above the {held_before / 2**30:.3f} GiB held when it started")
    del scD, exp_D, lifted_D

    # ---- 12. the parallel paths: slots on the card, two processes ----------
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    slot_stats = run_parallel(dev, counts, card, res_B.primal, Q_C)
    log(f"[smoke] parallel: phase wall {time.perf_counter() - t0:.1f} s, "
        f"device memory peak "
        f"{(torch.cuda.max_memory_allocated() - held_before) / 2**30:.3f} "
        f"GiB above the {held_before / 2**30:.3f} GiB held when it started")
    del Q_C

    # ---- 13. report -----------------------------------------------------------
    a, b, c = held["A o=3"], held["B o=3"], held["C o=3"]
    dense_cases = [r for r in held.values() if "dense_ms" in r]
    step_err = worst([r[k] for r in held.values() if "dense_ms" not in r
                      for k in ("step_err", "loop_err")])
    dense_err = worst([r[k] for r in dense_cases
                       for k in ("cw_err", "step_err", "loop_err")])

    def total(name):
        return sum(run[name] for run in counts.values())

    shapes, layouts = {}, {}
    for run in counts.values():
        for tot, key in ((shapes, "shapes"), (layouts, "layouts")):
            for k, v in run[f"sorted_segment_sum {key}"].items():
                tot[k] = tot.get(k, 0) + v

    def seg_row(kind, name, replaces, D):
        mine = [c for c in seg_cases if c["kernel"] == kind]
        rep = next(c for c in mine if c["order"] == "l" and c["D"] == D
                   and c["dtype"] == "float32")
        return dict(
            name=name, route="cuda", source="xmtpu_torch/csrc/segsum.cu",
            replaces=replaces, launches=total(name),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            max_rel_err=max(c["max_rel_err"] for c in mine),
            ms=rep["ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound"][0], bound_by=rep["bound"][1],
            bound_basis=rep["bound"][2], chain_floor_ms=rep["chain_floor"],
            library_ms=rep["library_ms"],
            shape=f"scene C landmark ordering, E={rep_E}, S={n_land}, D={D} "
                  f"f32; all {len(mine)} cases on the [smoke] segsum lines")

    rep_E, n_land = len(scC.edges), scC.M
    d512 = held["n512 o=3"]
    csr_row = seg_row("csr", "sorted_segment_sum",
                      "xmtpu/ops/pallas_segsum.py:46", 3)
    csr_row["shapes"] = shapes
    csr_row["layouts"] = layouts
    # phase 12's runs (in the totals too): per run, and per slot on (b)
    sharded = {k: v for k, v in counts.items() if k.startswith("P ")}
    csr_row["sharded"] = {k: v["sorted_segment_sum"]
                          for k, v in sharded.items()} | {
        "slot_sums": slot_stats["slot_sums"]}
    csr_row["floors"] = FLOORS
    # launches: of the case's layout key in the main-path runs named (an
    # assembly case: in the runs of its scene, under "runs")
    for key, cs, runs in (
            ("tail", tail_cases, ("D tail",)),
            ("refine", refine_cases, ("D refine",)),
            ("schurq_frame", frame_cases,
             ("D implicit", "D implicit default tol")),
            ("assembly", asm_cases, None)):
        csr_row[key] = [{k: c[k] for k in ("tag", "E", "S", "D", "dtype",
                                           "longest", "n_long", "ms",
                                           "plain_ms", "library_ms")}
                        | {"bound_ms": c["bound"][0],
                           "bound_by": c["bound"][1],
                           "bound_basis": c["bound"][2],
                           "chain_floor_ms": c["chain_floor"],
                           "launches": sum(counts[r][
                               "sorted_segment_sum layouts"].get(c["key"], 0)
                               for r in runs or c["runs"])}
                        for c in cs]
    kernels = [
        dict(name="tcg_step", route="cuda",
             source="xmtpu_torch/csrc/fused_tcg.cu",
             replaces="xmtpu/ops/pallas_tcg.py:98",
             launches=total("tcg_step"),
             max_abs_err=step_err[0], max_rel_err=step_err[1],
             ms=c["step_ms"], enqueue_ms=c["step_enqueue_ms"],
             plain_ms=c["step_plain_ms"],
             bound_ms=c["step_bound"][0], bound_by=c["step_bound"][1],
             bound_basis=c["step_bound"][2],
             library_ms=None, solve_ms=step_in_C[0],
             sharded={k: v["tcg_step"] for k, v in sharded.items()},
             geometry=c["geometry"],
             shape=f"n={scC.N} o=3 (scene C, split variant on the f32 cast "
                   f"of SchurQ); solve_ms: mean over the {step_in_C[1]} "
                   f"launches of a traced scene C solve; scene B n={nB}: "
                   f"{b['step_ms']:.4f} ms, bound {b['step_bound'][0]:.5f}, "
                   f"{b['geometry']}; scene A n={nA}: {a['step_ms']:.4f} ms, "
                   f"bound {a['step_bound'][0]:.6f}, {a['step_geometry']}"),
        dict(name="tcg_step_dense", route="cuda",
             source="xmtpu_torch/csrc/fused_tcg.cu",
             replaces="xmtpu/ops/pallas_tcg.py:109",
             launches=total("tcg_step_dense"),
             max_abs_err=dense_err[0], max_rel_err=dense_err[1],
             ms=a["dense_ms"], enqueue_ms=a["dense_enqueue_ms"],
             plain_ms=a["dense_plain_ms"],
             bound_ms=a["dense_bound"][0], bound_by=a["dense_bound"][1],
             bound_basis=a["dense_bound"][2],
             library_ms=a["cw_library_ms"], geometry=a["geometry"],
             shape=f"n={nA} o=3 (scene A); library_ms: torch.matmul of the "
                   f"product alone on the same W; n=512: "
                   f"{d512['dense_ms']:.4f} ms, bound "
                   f"{d512['dense_bound'][0]:.5f}, matmul "
                   f"{d512['cw_library_ms']:.4f} ms, {d512['geometry']}"),
        csr_row,
        seg_row("blocked", "sorted_segment_sum_blocked",
                "xmtpu/ops/pallas_segsum.py:222", 6),
    ]
    log(f"[smoke] launches per main-path run: {counts}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
