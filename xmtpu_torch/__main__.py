"""Command-line interface of the PyTorch port, the same as ``python -m xmtpu``:

    python -m xmtpu_torch solve PATH [--max-rank 10] [--tol 1e-6] [--lam 0]
                                     [--max-time 1000] [--precision f64|mixed]
    python -m xmtpu_torch solve-rank3 PATH ...
    python -m xmtpu_torch recover PATH [--lam 0] [--ply PREFIX]
    python -m xmtpu_torch certify PATH [--lam 0]
    python -m xmtpu_torch info PATH            # .bin file header info
    python -m xmtpu_torch mapper --database_path DB --output_path DIR [...]

Every subcommand but ``info`` runs on the CUDA card and raises without one;
``main(argv, device="cpu")`` runs it on the host.  ``mapper`` runs the
glomap-mapper replacement (``global_mapper_solve``): stages 0-4, and stages
5-8 (global positioning, bundle adjustment, retriangulation, pruning) where
their ``--skip_*`` flags are 0.
"""

from __future__ import annotations

import argparse
import sys


def _bool(v: str) -> bool:
    """boost::program_options-style bool values (``--skip_pruning 1``)."""
    if str(v).lower() in ("1", "true", "yes", "on"):
        return True
    if str(v).lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


# The glomap mapper's namespaced option surface
# (deps/glomap/glomap/controllers/option_manager.cc:60-240), mapped onto the
# xmtpu option dataclasses: (flag, type, target dataclass, field).
_MAPPER_FLAGS = [
    ("skip_preprocessing", _bool, "mapper", "skip_preprocessing"),
    ("skip_view_graph_calibration", _bool, "mapper",
     "skip_view_graph_calibration"),
    ("skip_relative_pose_estimation", _bool, "mapper",
     "skip_relative_pose_estimation"),
    ("skip_rotation_averaging", _bool, "mapper", "skip_rotation_averaging"),
    ("skip_track_establishment", _bool, "mapper", "skip_track_establishment"),
    ("skip_global_positioning", _bool, "mapper", "skip_global_positioning"),
    ("skip_bundle_adjustment", _bool, "mapper", "skip_bundle_adjustment"),
    ("skip_retriangulation", _bool, "mapper", "skip_retriangulation"),
    ("skip_pruning", _bool, "mapper", "skip_pruning"),
    ("ba_iteration_num", int, "mapper", "num_iteration_bundle_adjustment"),
    ("retriangulation_iteration_num", int, "mapper",
     "num_iteration_retriangulation"),
    ("ViewGraphCalib.thres_lower_ratio", float, "calib",
     "thres_lower_ratio"),
    ("ViewGraphCalib.thres_higher_ratio", float, "calib",
     "thres_higher_ratio"),
    ("ViewGraphCalib.thres_two_view_error", float, "calib",
     "thres_two_view_error"),
    # the mapper decomposes database E matrices instead of re-running
    # poselib RANSAC, so the epipolar threshold maps to the inlier scorer
    ("RelPoseEstimation.max_epipolar_error", float, "thresholds",
     "max_epipolar_error_E"),
    ("TrackEstablishment.min_num_tracks_per_view", int, "mapper",
     "min_num_tracks_per_view"),
    ("TrackEstablishment.min_num_view_per_track", int, "mapper",
     "min_num_view_per_track"),
    ("TrackEstablishment.max_num_view_per_track", int, "mapper",
     "max_num_view_per_track"),
    ("TrackEstablishment.max_num_tracks", int, "mapper", "max_num_tracks"),
    ("GlobalPositioning.optimize_positions", _bool, "gp",
     "optimize_positions"),
    ("GlobalPositioning.optimize_points", _bool, "gp", "optimize_points"),
    ("GlobalPositioning.optimize_scales", _bool, "gp", "optimize_scales"),
    ("GlobalPositioning.thres_loss_function", float, "gp", "huber_delta"),
    ("GlobalPositioning.max_num_iterations", int, "gp", "outer_iters"),
    ("BundleAdjustment.optimize_rotations", _bool, "ba",
     "optimize_rotations"),
    ("BundleAdjustment.optimize_translation", _bool, "ba",
     "optimize_translation"),
    ("BundleAdjustment.optimize_intrinsics", _bool, "ba",
     "optimize_intrinsics"),
    ("BundleAdjustment.optimize_points", _bool, "ba", "optimize_points"),
    ("BundleAdjustment.thres_loss_function", float, "ba", "huber_threshold"),
    ("BundleAdjustment.max_num_iterations", int, "ba", "max_iterations"),
    ("Triangulation.complete_max_reproj_error", float, "tri",
     "tri_complete_max_reproj_error"),
    ("Triangulation.merge_max_reproj_error", float, "tri",
     "tri_merge_max_reproj_error"),
    ("Triangulation.min_angle", float, "tri", "tri_min_angle"),
    ("Triangulation.min_num_matches", int, "tri", "min_num_matches"),
    ("Thresholds.max_epipolar_error_E", float, "thresholds",
     "max_epipolar_error_E"),
    ("Thresholds.min_inlier_num", int, "thresholds", "min_inlier_num"),
    ("Thresholds.min_inlier_ratio", float, "thresholds", "min_inlier_ratio"),
    ("Thresholds.max_rotation_error", float, "mapper",
     "max_rotation_error_deg"),
]


def _mapper_options(args):
    """Assemble GlobalMapperOptions from the parsed namespaced flags."""
    from xmtpu_torch.pipeline.bundle_adjustment import BundleAdjusterOptions
    from xmtpu_torch.pipeline.calibration import CalibrationOptions
    from xmtpu_torch.pipeline.global_mapper import GlobalMapperOptions
    from xmtpu_torch.pipeline.global_positioning import PositionerOptions
    from xmtpu_torch.pipeline.triangulation import TriangulatorOptions
    from xmtpu_torch.pipeline.viewgraph import InlierThresholds

    groups = {"mapper": {}, "calib": {}, "gp": {}, "ba": {}, "tri": {},
              "thresholds": {}}
    for flag, _, target, field in _MAPPER_FLAGS:
        val = getattr(args, flag, None)
        if val is not None:
            groups[target][field] = val

    opts = GlobalMapperOptions(**groups["mapper"])
    if groups["calib"]:
        opts.calibration = CalibrationOptions(**groups["calib"])
    if groups["gp"]:
        opts.positioner = PositionerOptions(**groups["gp"])
    if groups["ba"]:
        opts.bundle = BundleAdjusterOptions(**groups["ba"])
    if groups["tri"]:
        opts.triangulator = TriangulatorOptions(**groups["tri"])
    if groups["thresholds"]:
        opts.inlier_thresholds = InlierThresholds(**groups["thresholds"])
    return opts


def _add_solver_args(p):
    p.add_argument("path", help="dataset directory containing Q.bin")
    p.add_argument("--max-rank", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--lam", type=float, default=0.0)
    p.add_argument("--max-time", type=float, default=1000.0)
    p.add_argument("--precision", choices=["f64", "mixed"], default="f64")


def main(argv=None, device=None):
    """Run one subcommand; ``device``: None = the CUDA card, ``"cpu"`` for
    the host.  Returns the exit code."""
    parser = argparse.ArgumentParser(prog="xmtpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    _add_solver_args(sub.add_parser("solve", help="certified staircase solve"))
    _add_solver_args(sub.add_parser("solve-rank3", help="rank-3 solve only"))

    p = sub.add_parser("recover", help="recover poses/points from R.bin/s.bin")
    p.add_argument("path")
    p.add_argument("--lam", type=float, default=0.0)
    p.add_argument("--ply", help="export PLY files with this prefix")

    p = sub.add_parser("certify", help="re-certify a solved factor")
    p.add_argument("path")
    p.add_argument("--lam", type=float, default=0.0)

    p = sub.add_parser("info", help="print .bin header")
    p.add_argument("file")

    p = sub.add_parser(
        "mapper", help="glomap-mapper replacement: COLMAP database.db -> "
        "view-graph stages 0-4 (optionally 5-8) -> tempdata export")
    p.add_argument("--database_path", required=True)
    p.add_argument("--output_path", required=True,
                   help="directory for output/filename/relative_pose.txt")
    p.add_argument("--image_path", default=None,
                   help="accepted for glomap-CLI compatibility (unused: the "
                   "database carries everything the mapper needs)")
    p.add_argument("--quiet", action="store_true")
    for flag, typ, _, _ in _MAPPER_FLAGS:
        p.add_argument("--" + flag, dest=flag, type=typ, default=None)
    # kebab-case aliases kept from the earlier CLI
    p.add_argument("--max-num-view-per-track", type=int, default=None,
                   dest="TrackEstablishment.max_num_view_per_track")
    p.add_argument("--min-num-view-per-track", type=int, default=None,
                   dest="TrackEstablishment.min_num_view_per_track")
    p.add_argument("--skip-view-graph-calibration", action="store_const",
                   const=True, default=None,
                   dest="skip_view_graph_calibration")

    args = parser.parse_args(argv)

    if args.cmd == "info":
        import numpy as np
        with open(args.file, "rb") as f:
            rows, cols = np.fromfile(f, dtype=np.int32, count=2)
        print(f"{args.file}: {rows} x {cols} float64 "
              f"({rows * cols * 8 / 1e6:.1f} MB payload)")
        return 0

    from xmtpu_torch._device import resolve_device

    dev = resolve_device(device)

    if args.cmd == "mapper":
        from xmtpu_torch.pipeline.colmap_db import (database_to_view_graph,
                                                    read_database)
        from xmtpu_torch.pipeline.global_mapper import (export_tempdata,
                                                        global_mapper_solve)
        opts = _mapper_options(args)
        vg = database_to_view_graph(read_database(args.database_path))
        res = global_mapper_solve(vg, opts, verbose=not args.quiet,
                                  device=dev)
        export_tempdata(res, vg, args.output_path)
        print(f"mapper: {int(res.registered.sum())} images, "
              f"{res.n_tracks} tracks, {len(res.obs_image)} observations "
              f"-> {args.output_path}")
        return 0

    import os

    import torch

    import xmtpu_torch

    def load(name):
        return xmtpu_torch.load_matrix_from_bin(
            os.path.join(args.path, name))[0]

    if args.cmd in ("solve", "solve-rank3"):
        from xmtpu_torch.solver.staircase import solve, solve_rank3
        fn = solve if args.cmd == "solve" else solve_rank3
        res = fn(args.path, args.max_rank, args.tol, args.lam, args.max_time,
                 device=dev)
        print(f"status={res.status} certified={res.certified} rank={res.rank} "
              f"primal={res.primal:.10e} gap={res.gap:.3e}")
        return 0 if res.status >= 0 else 1

    if args.cmd == "recover":
        from xmtpu_torch.pipeline.recover import recover_XM
        Q = torch.as_tensor(load("Q.bin"), device=dev)
        Abar = torch.as_tensor(load("Abar.bin"), device=dev)
        R_real, s_real, p_est, t_est = recover_XM(Q, load("R.bin"),
                                                  load("s.bin"), Abar,
                                                  args.lam)
        print(f"recovered {s_real.shape[0]} cameras, {p_est.shape[1]} points")
        if args.ply:
            import numpy as np

            from xmtpu_torch.pipeline.visualization import export_ply
            N = s_real.shape[0]
            exts = []
            for i in range(N):
                Rb = R_real[:, 3 * i:3 * i + 3]
                ext = np.eye(4)
                ext[:3, :3] = Rb.T
                ext[:3, 3] = -Rb.T @ t_est[:, i]
                exts.append(ext)
            export_ply(args.ply, exts, points=p_est.T)
            print(f"wrote {args.ply}_cameras.ply / _points.ply")
        return 0

    if args.cmd == "certify":
        from xmtpu_torch.ops import manifold as mf
        from xmtpu_torch.solver.certificate import certify
        Q = torch.as_tensor(load("Q.bin"), device=dev)
        R = torch.as_tensor(load("R.bin"), device=dev)
        s = torch.as_tensor(load("s.bin"), device=dev)
        n = s.shape[0]
        Rb = R.reshape(n, 3, R.shape[1])
        sR = mf.flatten(mf.scale_blocks(Rb, s.reshape(-1)))
        primal = float(torch.sum(sR * (Q @ sR)))
        cert = certify(Q, sR, args.lam, primal, verbose=True, device=dev)
        return 0 if bool(cert.certified) else 1

    return 2


if __name__ == "__main__":
    sys.exit(main())
