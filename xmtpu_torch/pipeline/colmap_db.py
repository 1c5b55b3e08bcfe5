"""COLMAP SQLite database ingestion (and export).

The reference consumes COLMAP's ``database.db`` through the vendored GLOMAP
binary (``ConvertDatabaseToGlomap``,
deps/glomap/glomap/io/colmap_converter.cc:178-310), which
links the full COLMAP C++ stack. Here the database is read directly with
stdlib ``sqlite3`` + numpy blob decoding — no pycolmap/colmap dependency —
and converted to the flat arrays the xmtpu pipeline uses (contiguous image
indices, (P,2) pair array, per-pair match arrays).

Schema facts (COLMAP `src/colmap/scene/database.cc`):
  cameras(camera_id, model, width, height, params BLOB f64, prior_focal_length)
  images(image_id, name, camera_id, ...)
  keypoints(image_id, rows, cols, data BLOB f32)   cols in {2, 4, 6}
  matches(pair_id, rows, cols, data BLOB u32)
  two_view_geometries(pair_id, rows, cols, data BLOB u32, config,
                      F BLOB f64 3x3, E, H, qvec f64 4, tvec f64 3)
  pair_id = 2147483647 * image_id1 + image_id2, image_id1 <= image_id2
  (matches ``ImagePair::ImagePairToPairId``, glomap/scene/image_pair.h:61-67).

The port's copy of ``xmtpu/pipeline/colmap_db.py`` (numpy; the port never
imports the JAX package, not even its numpy-only modules).
"""

from __future__ import annotations

import sqlite3
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from .manipulation import (CALIBRATED, DEGENERATE, MULTIPLE, PANORAMIC,
                           PLANAR, PLANAR_OR_PANORAMIC, UNCALIBRATED,
                           UNDEFINED, WATERMARK)
from .undistort import Camera

MAX_NUM_IMAGES = 2147483647

# colmap::CameraModelId -> model name (colmap/sensor/models.h); only the
# families xmtpu.pipeline.undistort implements.
CAMERA_MODEL_NAMES = {
    0: "SIMPLE_PINHOLE",
    1: "PINHOLE",
    2: "SIMPLE_RADIAL",
    3: "RADIAL",
    4: "OPENCV",
    5: "OPENCV_FISHEYE",
    6: "FULL_OPENCV",
}
CAMERA_MODEL_IDS = {v: k for k, v in CAMERA_MODEL_NAMES.items()}


def pair_id_from_images(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return MAX_NUM_IMAGES * image_id1 + image_id2


def images_from_pair_id(pair_id: int):
    image_id2 = pair_id % MAX_NUM_IMAGES
    return (pair_id - image_id2) // MAX_NUM_IMAGES, image_id2


def _blob(data, dtype, shape=None):
    if data is None:
        return None
    a = np.frombuffer(data, dtype=dtype)
    return a.reshape(shape) if shape is not None else a


@dataclass
class DatabaseImage:
    image_id: int
    name: str
    camera_id: int
    keypoints: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))


class DatabasePair(NamedTuple):
    image_id1: int
    image_id2: int
    matches: np.ndarray          # (K, 2) int
    config: int
    F: np.ndarray | None
    E: np.ndarray | None
    H: np.ndarray | None


@dataclass
class ColmapDatabase:
    cameras: dict            # camera_id -> undistort.Camera
    prior_focal: dict        # camera_id -> bool
    images: dict             # image_id -> DatabaseImage
    pairs: dict              # (id1, id2) -> DatabasePair


def read_database(path: str, use_two_view_geometries: bool = True
                  ) -> ColmapDatabase:
    """Load cameras, images, keypoints and matches from ``database.db``.

    ``use_two_view_geometries`` selects the verified-match table (what
    GLOMAP reads, colmap_converter.cc:246); fall back to raw ``matches``
    when the database has no geometric verification.
    """
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        cur = con.cursor()

        cameras, prior_focal = {}, {}
        for cid, model, w, h, params, prior in cur.execute(
                "SELECT camera_id, model, width, height, params, "
                "prior_focal_length FROM cameras"):
            name = CAMERA_MODEL_NAMES.get(int(model))
            if name is None:
                raise ValueError(f"unsupported COLMAP camera model {model}")
            cameras[int(cid)] = Camera(
                model=name, width=int(w), height=int(h),
                params=_blob(params, np.float64).tolist(),
                has_prior_focal_length=bool(prior))
            prior_focal[int(cid)] = bool(prior)

        images = {}
        for iid, name, cid in cur.execute(
                "SELECT image_id, name, camera_id FROM images"):
            images[int(iid)] = DatabaseImage(int(iid), name, int(cid))

        for iid, rows, cols, data in cur.execute(
                "SELECT image_id, rows, cols, data FROM keypoints"):
            if int(iid) not in images or rows == 0:
                continue
            kp = _blob(data, np.float32, (int(rows), int(cols)))
            images[int(iid)].keypoints = kp[:, :2].astype(np.float64)

        pairs = {}
        if use_two_view_geometries and _has_table(cur,
                                                  "two_view_geometries"):
            q = ("SELECT pair_id, rows, cols, data, config, F, E, H "
                 "FROM two_view_geometries")
            for pid, rows, cols, data, config, F, E, H in cur.execute(q):
                id1, id2 = images_from_pair_id(int(pid))
                m = (np.zeros((0, 2), dtype=np.int64) if rows == 0 or
                     data is None else
                     _blob(data, np.uint32,
                           (int(rows), int(cols))).astype(np.int64))
                pairs[(id1, id2)] = DatabasePair(
                    id1, id2, m, int(config),
                    _blob(F, np.float64, (3, 3)),
                    _blob(E, np.float64, (3, 3)),
                    _blob(H, np.float64, (3, 3)))
        else:
            for pid, rows, cols, data in cur.execute(
                    "SELECT pair_id, rows, cols, data FROM matches"):
                id1, id2 = images_from_pair_id(int(pid))
                m = (np.zeros((0, 2), dtype=np.int64) if rows == 0 or
                     data is None else
                     _blob(data, np.uint32,
                           (int(rows), int(cols))).astype(np.int64))
                pairs[(id1, id2)] = DatabasePair(id1, id2, m, UNDEFINED,
                                                 None, None, None)
        return ColmapDatabase(cameras, prior_focal, images, pairs)
    finally:
        con.close()


def _has_table(cur, name: str) -> bool:
    row = cur.execute(
        "SELECT count(*) FROM sqlite_master WHERE type='table' AND name=?",
        (name,)).fetchone()
    return row[0] > 0


class ViewGraphData(NamedTuple):
    """Flat-array view graph, index space (0..N-1) like the rest of xmtpu."""

    image_ids: np.ndarray        # (N,) original COLMAP image ids
    image_names: list            # N names
    camera_of_image: np.ndarray  # (N,) contiguous camera index
    cameras: list                # undistort.Camera per camera index
    has_prior_focal: np.ndarray  # (C,) bool
    keypoints: list              # N arrays (K_i, 2) pixel keypoints
    pairs: np.ndarray            # (P, 2) image indices
    matches: list                # P arrays (K_p, 2) keypoint indices
    config: np.ndarray           # (P,) two-view config codes
    valid: np.ndarray            # (P,) bool (invalid configs masked out)
    F: np.ndarray                # (P, 3, 3); zeros when absent
    E: np.ndarray                # (P, 3, 3)
    H: np.ndarray                # (P, 3, 3)


def database_to_view_graph(db: ColmapDatabase) -> ViewGraphData:
    """``ConvertDatabaseToGlomap`` (colmap_converter.cc:178-310) on arrays:
    re-index images/cameras contiguously, mask out UNDEFINED / DEGENERATE /
    WATERMARK / MULTIPLE pairs (cc:253-260), keep F/E/H per config
    (cc:262-280), and clamp matches to valid keypoint ranges (cc:289-303).
    """
    image_ids = np.array(sorted(db.images), dtype=np.int64)
    idx_of = {int(i): k for k, i in enumerate(image_ids)}
    cam_ids = sorted(db.cameras)
    cam_idx = {c: k for k, c in enumerate(cam_ids)}
    cameras = [db.cameras[c] for c in cam_ids]
    has_prior = np.array([db.prior_focal.get(c, False) for c in cam_ids],
                         dtype=bool)
    camera_of_image = np.array(
        [cam_idx[db.images[int(i)].camera_id] for i in image_ids],
        dtype=np.int64)
    names = [db.images[int(i)].name for i in image_ids]
    keypoints = [db.images[int(i)].keypoints for i in image_ids]

    bad = {UNDEFINED, DEGENERATE, WATERMARK, MULTIPLE}
    P = len(db.pairs)
    pair_arr = np.zeros((P, 2), dtype=np.int64)
    config = np.zeros(P, dtype=np.int64)
    valid = np.zeros(P, dtype=bool)
    F = np.zeros((P, 3, 3))
    E = np.zeros((P, 3, 3))
    H = np.zeros((P, 3, 3))
    matches = []
    for p, ((id1, id2), pr) in enumerate(sorted(db.pairs.items())):
        i1, i2 = idx_of[id1], idx_of[id2]
        pair_arr[p] = (i1, i2)
        config[p] = pr.config
        valid[p] = pr.config not in bad
        if pr.F is not None:
            F[p] = pr.F
        if pr.E is not None:
            E[p] = pr.E
        if pr.H is not None:
            H[p] = pr.H
        m = pr.matches
        k1 = len(keypoints[i1])
        k2 = len(keypoints[i2])
        ok = (m[:, 0] >= 0) & (m[:, 0] < k1) & (m[:, 1] >= 0) & (m[:, 1] < k2)
        matches.append(m[ok])
    return ViewGraphData(image_ids, names, camera_of_image, cameras,
                         has_prior, keypoints, pair_arr, matches, config,
                         valid, F, E, H)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def write_database(path: str, cameras: dict, images: dict,
                   keypoints: dict | None = None,
                   matches: dict | None = None,
                   two_view_geometries: dict | None = None,
                   prior_focal: dict | None = None) -> None:
    """Write a COLMAP-compatible ``database.db``.

    Args:
      cameras: camera_id -> :class:`xmtpu_torch.pipeline.undistort.Camera`.
      images: image_id -> (name, camera_id).
      keypoints: image_id -> (K, >=2) float array.
      matches: (id1, id2) -> (K, 2) int array (raw putative matches).
      two_view_geometries: (id1, id2) -> dict with keys ``matches``,
        ``config`` and optional ``F``/``E``/``H``.
    """
    con = sqlite3.connect(path)
    try:
        con.executescript(_SCHEMA)
        for cid, cam in cameras.items():
            con.execute(
                "INSERT OR REPLACE INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
                (int(cid), CAMERA_MODEL_IDS[cam.model], cam.width,
                 cam.height,
                 np.asarray(cam.params, dtype=np.float64).tobytes(),
                 int(bool((prior_focal or {}).get(cid, True)))))
        for iid, (name, cid) in images.items():
            con.execute("INSERT OR REPLACE INTO images VALUES (?, ?, ?)",
                        (int(iid), name, int(cid)))
        for iid, kp in (keypoints or {}).items():
            kp = np.asarray(kp, dtype=np.float32)
            if kp.ndim == 2 and kp.shape[1] == 2:
                # COLMAP keypoints carry affine shape; pad to x,y,scale,orient
                kp = np.concatenate(
                    [kp, np.ones((len(kp), 1), np.float32),
                     np.zeros((len(kp), 1), np.float32)], axis=1)
            con.execute("INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
                        (int(iid), kp.shape[0], kp.shape[1], kp.tobytes()))
        for (id1, id2), m in (matches or {}).items():
            m = np.asarray(m, dtype=np.uint32)
            if id1 > id2:                        # canonical order + swap cols
                id1, id2 = id2, id1
                m = m[:, ::-1]
            con.execute("INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
                        (pair_id_from_images(id1, id2), m.shape[0], 2,
                         np.ascontiguousarray(m).tobytes()))
        for (id1, id2), tv in (two_view_geometries or {}).items():
            m = np.asarray(tv["matches"], dtype=np.uint32)
            if id1 > id2:
                id1, id2 = id2, id1
                m = m[:, ::-1]

            def b(key):
                v = tv.get(key)
                return (None if v is None
                        else np.asarray(v, dtype=np.float64).tobytes())

            con.execute(
                "INSERT OR REPLACE INTO two_view_geometries "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (pair_id_from_images(id1, id2), m.shape[0], 2,
                 np.ascontiguousarray(m).tobytes(),
                 int(tv.get("config", CALIBRATED)),
                 b("F"), b("E"), b("H"), b("qvec"), b("tvec")))
        con.commit()
    finally:
        con.close()
