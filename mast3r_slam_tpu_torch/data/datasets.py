"""Dataset readers (host-side IO), counterpart of
``mast3r_slam_tpu/data/datasets.py``.

Every reader yields ``(timestamp, img)`` with ``img (H, W, 3) float32 RGB``
in [0, 1] at the source resolution, undistorted when its calibration is in
use; ``slam/pipeline.py::create_frame`` resizes to the model crop. Images
are read with ``data/imread.py`` as ``cv2.imread`` reads them (every PNG
and every 8-bit Huffman JPEG, told apart by their first bytes, EXIF
orientation applied; EuRoC's gray read as ``IMREAD_GRAYSCALE``) and
undistorted with ``data/undistort.py``: no OpenCV or PIL on the card
machine.

The port's modules take the config dict as an argument: the readers and
:class:`Intrinsics` read ``dataset.subsample``, ``dataset.img_size``,
``dataset.center_principle_point`` and ``use_calib`` from the ``cfg`` they
are given, where the JAX package reads its process-global config.

Video files (``.mp4``, ``.avi``, ``.mov``, ``.mkv``) are read by
``data/video.py`` as ``cv2.VideoCapture`` reads them (H.264, VP9, MPEG-4
Part 2 and Motion JPEG tracks; another codec raises ``ValueError`` naming its
fourcc).
The RealSense reader imports ``pyrealsense2`` when it is opened and raises
``RuntimeError`` without it, as the JAX one does. Not ported (ROADMAP): the
webcam reader, which needs a camera device (``cv2.VideoCapture`` on
V4L2): :func:`load_dataset` raises for it.
"""

from __future__ import annotations

import json
import os
import pathlib
import re

import numpy as np

from mast3r_slam_tpu_torch.data import undistort, video
from mast3r_slam_tpu_torch.data.image_ops import resize_img
from mast3r_slam_tpu_torch.data.imread import gray_to_rgb, read_gray, read_rgb


def natsorted(paths):
    """Natural-order sort (replacement for the natsort dependency)."""

    def key(p):
        s = str(p)
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(paths, key=key)


def _dataset_cfg(cfg):
    return (cfg or {}).get("dataset", {}) or {}


# ---------------------------------------------------------------------------
# Intrinsics
# ---------------------------------------------------------------------------

class Intrinsics:
    """Camera calibration: the undistortion and the intrinsics of the model
    crop.

    With distortion, ``K_undist`` is ``data/undistort.py``'s new camera
    matrix (alpha 0; its principal point moved to the image centre unless
    ``dataset.center_principle_point`` is false) and :meth:`remap`
    undistorts a frame onto it. ``K_frame`` maps ``K_undist`` through
    ``resize_img``'s resize and crop at ``dataset.img_size``. Where the
    JAX package skips undistortion when ``cv2`` is missing, the port
    always undistorts a calibration with distortion."""

    def __init__(self, W, H, fx, fy, cx, cy, distortion=None, cfg=None):
        self.W, self.H = int(W), int(H)
        self.cfg = cfg or {}
        self.K_orig = np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32
        )
        self.distortion = (
            np.zeros(5, np.float32) if distortion is None
            else np.asarray(distortion, np.float32)
        )
        self.has_distortion = bool(np.abs(self.distortion).sum() > 0)
        self.tables = None
        self.K_undist = self.K_orig.copy()
        if self.has_distortion:
            wh = (self.W, self.H)
            new_K = undistort.optimal_new_camera_matrix(
                self.K_orig, self.distortion, wh)
            if bool(_dataset_cfg(self.cfg).get("center_principle_point",
                                               True)):
                new_K[0, 2] = self.W / 2.0
                new_K[1, 2] = self.H / 2.0
            self.K_undist = new_K.astype(np.float32)
            mapx, mapy = undistort.undistort_rectify_map(
                self.K_orig, self.distortion, self.K_undist, wh)
            self.tables = undistort.RemapTables(mapx, mapy, (self.H, self.W))
        self.K_frame = self._rescale_to_crop(self.K_undist)

    def _rescale_to_crop(self, K):
        img_size = int(_dataset_cfg(self.cfg).get("img_size", 512))
        probe = np.zeros((self.H, self.W, 3), np.float32)
        _, (scale_w, scale_h, half_w, half_h) = resize_img(
            probe, img_size, return_transformation=True
        )
        K2 = K.copy().astype(np.float32)
        K2[0, 0] /= scale_w
        K2[1, 1] /= scale_h
        K2[0, 2] = K2[0, 2] / scale_w - half_w
        K2[1, 2] = K2[1, 2] / scale_h - half_h
        return K2

    def remap(self, img):
        if self.tables is None:
            return img
        return undistort.remap_bilinear(img, self.tables)


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------

class MonocularDataset:
    """Base reader: index → (timestamp, float32 RGB [0, 1])."""

    dtype = np.float32

    def __init__(self, cfg=None):
        self.cfg = cfg or {}
        self.timestamps: list | np.ndarray = []
        self.use_calibration = False
        self.camera_intrinsics: Intrinsics | None = None
        self.save_results = True
        self.subsample = int(_dataset_cfg(self.cfg).get("subsample", 1))

    def read_img(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError

    def read_frame(self, idx):
        """The frame as stored: gray ``(H, W)`` where the reader has it so,
        which is undistorted once and then repeated into RGB."""
        return self.read_img(idx)

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        img = self.read_frame(idx)
        if img.dtype == np.uint8:
            img = img.astype(self.dtype) / 255.0
        if self.use_calibration and self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        img = gray_to_rgb(img)
        ts = self.timestamps[idx] if idx < len(self.timestamps) else float(idx)
        return float(ts), img

    def get_img_shape(self, img_size: int = 0):
        """(display_shape, true_shape) of the model crop for frame 0."""
        if not img_size:
            img_size = int(_dataset_cfg(self.cfg).get("img_size", 512))
        _, img = self[0]
        res = resize_img(img, img_size)
        hw = tuple(int(v) for v in res["true_shape"][0])
        return hw, hw

    def set_calibration(self, intr: Intrinsics):
        self.camera_intrinsics = intr
        self.use_calibration = True

    def has_calib(self):
        return self.use_calibration and self.camera_intrinsics is not None

    def _intrinsics(self, *args):
        return Intrinsics(*args, cfg=self.cfg)

    def _use_calib(self):
        return bool(self.cfg.get("use_calib", False))


def _read_rgb_txt(path, subsample):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            rows.append((float(ts), rel))
    return rows[::subsample]


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------

# Standard TUM freiburg camera parameters (fx fy cx cy k1 k2 p1 p2 k3).
_TUM_CALIB = {
    "freiburg1": (517.3, 516.5, 318.6, 255.3,
                  (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)),
    "freiburg2": (520.9, 521.0, 325.1, 249.7,
                  (0.2312, -0.7849, -0.0033, -0.0001, 0.9172)),
    "freiburg3": (535.4, 539.2, 320.1, 247.6, None),
}


class TUMDataset(MonocularDataset):
    """TUM RGB sequences: ``rgb.txt`` index + per-freiburg fixed
    calibration."""

    def __init__(self, path, cfg=None):
        super().__init__(cfg)
        self.path = pathlib.Path(path)
        rows = _read_rgb_txt(self.path / "rgb.txt", self.subsample)
        self.timestamps = np.asarray([r[0] for r in rows], np.float64)
        self.files = [self.path / r[1] for r in rows]

        seq = str(self.path).lower()
        for token, (fx, fy, cx, cy, dist) in _TUM_CALIB.items():
            if token in seq:
                self.camera_intrinsics = self._intrinsics(640, 480, fx, fy,
                                                          cx, cy, dist)
                self.use_calibration = self._use_calib()
                break

    def __len__(self):
        return len(self.files)

    def read_img(self, idx):
        return read_rgb(self.files[idx])


# ---------------------------------------------------------------------------
# EuRoC MAV
# ---------------------------------------------------------------------------

class EurocDataset(MonocularDataset):
    """EuRoC cam0 grayscale stream, read as ``cv2.IMREAD_GRAYSCALE``
    reads it (gray → RGB); always undistorted."""

    def __init__(self, path, cfg=None):
        super().__init__(cfg)
        self.path = pathlib.Path(path)
        cam = self.path / "mav0" / "cam0"
        files = natsorted((cam / "data").glob("*.png"))
        files = files[:: self.subsample]
        self.files = files
        self.timestamps = np.asarray(
            [float(f.stem) * 1e-9 for f in files], np.float64
        )
        fx, fy, cx, cy, dist, (w, h) = self._read_sensor_yaml(
            cam / "sensor.yaml")
        self.camera_intrinsics = self._intrinsics(w, h, fx, fy, cx, cy, dist)
        self.use_calibration = True

    @staticmethod
    def _read_sensor_yaml(path):
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
        fx, fy, cx, cy = d["intrinsics"]
        k1, k2, p1, p2 = d["distortion_coefficients"]
        w, h = d["resolution"]
        return fx, fy, cx, cy, (k1, k2, p1, p2, 0.0), (w, h)

    def __len__(self):
        return len(self.files)

    def read_img(self, idx):
        return gray_to_rgb(read_gray(self.files[idx]))

    def read_frame(self, idx):
        return read_gray(self.files[idx])


# ---------------------------------------------------------------------------
# ETH3D
# ---------------------------------------------------------------------------

class ETH3DDataset(MonocularDataset):
    """ETH3D SLAM sequences: rgb.txt + calibration.txt."""

    def __init__(self, path, cfg=None):
        super().__init__(cfg)
        self.path = pathlib.Path(path)
        rows = _read_rgb_txt(self.path / "rgb.txt", self.subsample)
        self.timestamps = np.asarray([r[0] for r in rows], np.float64)
        self.files = [self.path / r[1] for r in rows]

        calib_file = self.path / "calibration.txt"
        if calib_file.exists():
            fx, fy, cx, cy = np.loadtxt(calib_file).reshape(-1)[:4]
            h, w = read_rgb(self.files[0]).shape[:2]
            self.camera_intrinsics = self._intrinsics(w, h, fx, fy, cx, cy,
                                                      None)
            self.use_calibration = self._use_calib()

    def __len__(self):
        return len(self.files)

    def read_img(self, idx):
        return read_rgb(self.files[idx])


# ---------------------------------------------------------------------------
# 7-Scenes
# ---------------------------------------------------------------------------

class SevenScenesDataset(MonocularDataset):
    """7-Scenes seq-01 color PNGs with the fixed 585/585/320/240
    intrinsics."""

    def __init__(self, path, cfg=None):
        super().__init__(cfg)
        self.path = pathlib.Path(path)
        seq = (self.path / "seq-01" if (self.path / "seq-01").exists()
               else self.path)
        self.files = natsorted(seq.glob("*.color.png"))[:: self.subsample]
        self.timestamps = np.arange(len(self.files), dtype=np.float64) / 30.0
        self.camera_intrinsics = self._intrinsics(640, 480, 585, 585, 320,
                                                  240, None)
        self.use_calibration = self._use_calib()

    def __len__(self):
        return len(self.files)

    def read_img(self, idx):
        return read_rgb(self.files[idx])


# ---------------------------------------------------------------------------
# Replica
# ---------------------------------------------------------------------------

class ReplicaDataset(MonocularDataset):
    """Replica renders: results/frame*.jpg (or .png) + cam_params.json in
    any of 3 layouts; JPEGs are read by ``data/jpeg.py``."""

    def __init__(self, path, cfg=None):
        super().__init__(cfg)
        self.path = pathlib.Path(path)
        frames_dir = self.path / "results"
        if not frames_dir.exists():
            frames_dir = self.path
        self.files = natsorted(
            list(frames_dir.glob("frame*.jpg"))
            + list(frames_dir.glob("frame*.png")))[:: self.subsample]
        self.timestamps = np.arange(len(self.files), dtype=np.float64) / 30.0
        cam = self._find_cam_params()
        if cam is not None:
            w, h, fx, fy, cx, cy = cam
            self.camera_intrinsics = self._intrinsics(w, h, fx, fy, cx, cy,
                                                      None)
            self.use_calibration = self._use_calib()

    def _find_cam_params(self):
        for cand in (
            self.path / "cam_params.json",
            self.path.parent / "cam_params.json",
            self.path.parent.parent / "cam_params.json",
        ):
            if cand.exists():
                with open(cand) as f:
                    d = json.load(f)
                cam = d.get("camera", d.get("params", d))
                try:
                    return (cam["w"], cam["h"], cam["fx"], cam["fy"],
                            cam["cx"], cam["cy"])
                except KeyError:
                    continue
        return None

    def __len__(self):
        return len(self.files)

    def read_img(self, idx):
        return read_rgb(self.files[idx])


# ---------------------------------------------------------------------------
# Video file
# ---------------------------------------------------------------------------

class MP4Dataset(MonocularDataset):
    """A video file, read by ``data/video.py`` as ``cv2.VideoCapture``
    reads it: every ``subsample``-th frame, timestamps at the file's frame
    rate (30.0 where it gives none). A file that cannot be opened (missing
    or unreadable) is what an unopened ``cv2.VideoCapture`` reports to the
    JAX reader: frame count and fps -1, no timestamps, and ``len`` raises
    ``ValueError``; a file whose layout or codec is not read raises
    ``ValueError`` naming it."""

    def __init__(self, path, cfg=None):
        super().__init__(cfg)
        self.path = str(path)
        try:
            self.reader = video.VideoReader(self.path)
        except OSError:
            self.reader = None
        if self.reader is None:
            self.fps, self.total_frames = -1.0, -1
        else:
            self.fps = self.reader.fps or 30.0
            self.total_frames = len(self.reader)
        self.stride = self.subsample
        self.timestamps = (
            np.arange(max(self.total_frames // self.stride, 0),
                      dtype=np.float64) * self.stride / self.fps)

    def __len__(self):
        return self.total_frames // self.stride

    def read_img(self, idx):
        target = idx * self.stride
        if self.reader is None:
            raise ValueError(f"failed to decode frame {target} of {self.path}")
        return self.reader.read(target)


# ---------------------------------------------------------------------------
# Image folder
# ---------------------------------------------------------------------------

class RGBFiles(MonocularDataset):
    """Folder of PNG frames at an assumed 30 FPS."""

    def __init__(self, path, cfg=None):
        super().__init__(cfg)
        self.path = pathlib.Path(path)
        self.files = natsorted(self.path.glob("*.png"))[:: self.subsample]
        self.timestamps = np.arange(len(self.files), dtype=np.float64) / 30.0

    def __len__(self):
        return len(self.files)

    def read_img(self, idx):
        return read_rgb(self.files[idx])


# ---------------------------------------------------------------------------
# RealSense
# ---------------------------------------------------------------------------

class RealsenseDataset(MonocularDataset):
    """Intel RealSense live colour stream (640x480 RGB at 30 FPS), gated
    on ``pyrealsense2``: the stream's intrinsics and distortion make the
    calibration, every frame is undistorted, timestamps count from the
    first frame."""

    def __init__(self, cfg=None):
        super().__init__(cfg)
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise RuntimeError(
                "pyrealsense2 is not installed; RealSense capture unavailable"
            ) from e
        self.pipeline = rs.pipeline()
        rs_cfg = rs.config()
        rs_cfg.enable_stream(rs.stream.color, 640, 480, rs.format.rgb8, 30)
        profile = self.pipeline.start(rs_cfg)
        intr = (profile.get_stream(rs.stream.color)
                .as_video_stream_profile().get_intrinsics())
        self.camera_intrinsics = self._intrinsics(
            intr.width, intr.height, intr.fx, intr.fy, intr.ppx, intr.ppy,
            tuple(intr.coeffs))
        self.use_calibration = True
        self.save_results = False
        self._t0 = None
        self.timestamps = []

    def __len__(self):
        return 999999999

    def read_img(self, idx):
        frames = self.pipeline.wait_for_frames()
        color = frames.get_color_frame()
        ts = color.get_timestamp() / 1000.0
        if self._t0 is None:
            self._t0 = ts
        self.timestamps.append(ts - self._t0)
        return np.asanyarray(color.get_data())

    def __getitem__(self, idx):
        img = self.read_img(idx).astype(self.dtype) / 255.0
        if self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return self.timestamps[-1], img


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def load_dataset(path: str, cfg=None) -> MonocularDataset:
    """Path-token dispatch, as the JAX ``load_dataset``."""
    p = str(path).lower()
    if p in ("realsense", "rs"):
        return RealsenseDataset(cfg)
    if p in ("webcam", "cam") or p.startswith("webcam:"):
        raise NotImplementedError(
            f"{path}: the webcam reader is not ported (ROADMAP): it needs a "
            "camera device (cv2.VideoCapture on V4L2) that the port "
            "does not have")
    if p.endswith((".mp4", ".avi", ".mov", ".mkv")):
        return MP4Dataset(path, cfg)
    if "tum" in p or "freiburg" in p:
        return TUMDataset(path, cfg)
    if "euroc" in p or os.path.exists(os.path.join(path, "mav0")):
        return EurocDataset(path, cfg)
    if "7-scenes" in p or "7scenes" in p:
        return SevenScenesDataset(path, cfg)
    if "eth3d" in p:
        return ETH3DDataset(path, cfg)
    if "replica" in p or os.path.exists(os.path.join(path, "results")):
        return ReplicaDataset(path, cfg)
    if os.path.isdir(path):
        if list(pathlib.Path(path).glob("*.color.png")):
            return SevenScenesDataset(path, cfg)
        if os.path.exists(os.path.join(path, "rgb.txt")):
            return TUMDataset(path, cfg)
        return RGBFiles(path, cfg)
    raise ValueError(f"unrecognized dataset path: {path}")
