"""The global TSDF's sparse voxel hash: a C++ open-addressing table bound
with ctypes, and its plain numpy version (counterpart of
``mast3r_slam_tpu/services/native_tsdf.py``).

The C++ source is the port's own copy, ``native/tsdf_hash.cpp`` beside
this package's modules. It is compiled with ``g++`` at first use into
``build/`` (git-ignored), keyed by a hash of the source. Unlike the JAX
package, :func:`make_voxel_hash` does not fall back to the numpy version
when the build fails: it raises. :class:`PyVoxelHash` is the plain version
the tests hold the native hash against.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from mast3r_slam_tpu_torch import _build

_F32 = np.float32
_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "tsdf_hash.cpp"
_BUILD = _PKG / "build"
_BUILD_LOCK = threading.Lock()
_lib = None


def load_library() -> ctypes.CDLL:
    """The compiled hash, built at first use; raises when it cannot be
    built."""
    global _lib
    with _BUILD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(
                _SRC, _BUILD, "native TSDF hash")))
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.tsdf_create.restype = ctypes.c_void_p
            lib.tsdf_create.argtypes = [ctypes.c_int64, ctypes.c_float,
                                        ctypes.c_float, ctypes.c_float]
            lib.tsdf_destroy.restype = None
            lib.tsdf_destroy.argtypes = [ctypes.c_void_p]
            lib.tsdf_clear.restype = None
            lib.tsdf_clear.argtypes = [ctypes.c_void_p]
            lib.tsdf_integrate.restype = ctypes.c_int64
            lib.tsdf_integrate.argtypes = [ctypes.c_void_p, f32p, f32p,
                                           ctypes.c_int64, f32p,
                                           ctypes.c_float]
            lib.tsdf_query.restype = ctypes.c_int64
            lib.tsdf_query.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64,
                                       f32p, f32p,
                                       ctypes.POINTER(ctypes.c_ubyte),
                                       ctypes.c_float]
            lib.tsdf_num_voxels.restype = ctypes.c_int64
            lib.tsdf_num_voxels.argtypes = [ctypes.c_void_p]
            lib.tsdf_stats.restype = None
            lib.tsdf_stats.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_double)]
            _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeVoxelHash:
    """C++ sparse TSDF volume (see ``native/tsdf_hash.cpp``)."""

    def __init__(self, capacity=1 << 20, voxel_size=0.03, trunc=0.12,
                 max_weight=100.0):
        self._lib = load_library()
        self.voxel_size = voxel_size
        self.trunc = trunc
        # the table rounds the capacity up to a power of two
        self._h = self._lib.tsdf_create(capacity, voxel_size, trunc,
                                        max_weight)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tsdf_destroy(self._h)
            self._h = None

    def integrate(self, points, conf, origin, min_conf=0.0) -> int:
        pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        cf = np.ascontiguousarray(conf, np.float32).reshape(-1)
        org = np.ascontiguousarray(origin, np.float32).reshape(3)
        if cf.shape[0] != pts.shape[0]:
            raise ValueError(f"{pts.shape[0]} points, {cf.shape[0]} "
                             "confidences")
        return int(self._lib.tsdf_integrate(
            self._h, _fptr(pts), _fptr(cf), pts.shape[0], _fptr(org),
            float(min_conf)))

    def query(self, points, min_weight=1e-3):
        pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        n = pts.shape[0]
        tsdf = np.empty(n, np.float32)
        grad = np.empty((n, 3), np.float32)
        valid = np.empty(n, np.uint8)
        self._lib.tsdf_query(
            self._h, _fptr(pts), n, _fptr(tsdf), _fptr(grad),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            float(min_weight))
        return tsdf, grad, valid.astype(bool)

    def clear(self):
        self._lib.tsdf_clear(self._h)

    def num_voxels(self) -> int:
        return int(self._lib.tsdf_num_voxels(self._h))

    def stats(self) -> dict:
        out = (ctypes.c_double * 4)()
        self._lib.tsdf_stats(self._h, out)
        return {"voxels": int(out[0]), "capacity": int(out[1]),
                "updates": float(out[2]), "failed_inserts": int(out[3])}


class PyVoxelHash:
    """The plain version of :class:`NativeVoxelHash`: a dict of voxels with
    the C++ table's float32 arithmetic, operation for operation (the
    samples vectorized per integrate call, the updates applied in the C++
    loop's order), its fixed capacity and its load cap."""

    def __init__(self, capacity=1 << 20, voxel_size=0.03, trunc=0.12,
                 max_weight=100.0):
        self.capacity = 1 << max(int(capacity) - 1, 0).bit_length()
        self.voxel_size = _F32(voxel_size)
        self.trunc = _F32(trunc)
        self.max_weight = _F32(max_weight)
        self.vox: dict[tuple, list] = {}
        self._updates = 0
        self._failed = 0

    def integrate(self, points, conf, origin, min_conf=0.0) -> int:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        cf = np.asarray(conf, np.float32).reshape(-1)
        org = np.asarray(origin, np.float32).reshape(3)
        vs, trunc = self.voxel_size, self.trunc
        step = _F32(0.5) * vs
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            d = pts - org
            ln = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                         + d[:, 2] * d[:, 2])
            keep = ((cf >= _F32(min_conf)) & np.isfinite(pts).all(1)
                    & (ln >= _F32(1e-6)) & (ln <= _F32(1000.0)))
            d, ln, cf = d[keep] / ln[keep, None], ln[keep], cf[keep]
            t0 = np.maximum(ln - trunc, _F32(0))
            n_steps = ((ln + trunc - t0) / step).astype(np.int64) + 1
        count = 0
        for i in range(ln.shape[0]):
            t = t0[i] + step * np.arange(n_steps[i], dtype=np.float32)
            ijk = np.floor((org + d[i] * t[:, None]) / vs).astype(np.int64)
            sdf = (ln[i] - t) / trunc
            w = cf[i] * np.exp(-np.abs(sdf))
            for key, s_, w_ in zip(map(tuple, ijk), sdf, w):
                if w_ <= 0:
                    continue
                cell = self.vox.get(key)
                if cell is None:
                    if len(self.vox) * 10 >= self.capacity * 9:
                        self._failed += 1
                        continue
                    cell = self.vox[key] = [_F32(0), _F32(0)]
                t_old, w_old = cell
                w_new = w_old + w_
                cell[0] = (t_old * w_old + s_ * w_) / w_new
                cell[1] = min(w_new, self.max_weight)
                count += 1
        self._updates += count
        return count

    def query(self, points, min_weight=1e-3):
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        n = pts.shape[0]
        tsdf = np.zeros(n, np.float32)
        grad = np.zeros((n, 3), np.float32)
        valid = np.zeros(n, bool)
        vs = self.voxel_size
        inv = _F32(1) / (_F32(2) * vs)
        with np.errstate(invalid="ignore"):
            cells = np.floor(pts / vs).astype(np.int64)
        for i, (ix, iy, iz) in enumerate(cells):
            def get(dx, dy, dz):
                c = self.vox.get((ix + dx, iy + dy, iz + dz))
                return None if c is None or c[1] < min_weight else c[0]

            c = get(0, 0, 0)
            nb = [get(1, 0, 0), get(-1, 0, 0), get(0, 1, 0), get(0, -1, 0),
                  get(0, 0, 1), get(0, 0, -1)]
            if c is None or any(v is None for v in nb):
                continue
            tsdf[i] = c
            grad[i] = [(nb[0] - nb[1]) * inv, (nb[2] - nb[3]) * inv,
                       (nb[4] - nb[5]) * inv]
            valid[i] = True
        return tsdf, grad, valid

    def clear(self):
        self.vox.clear()

    def num_voxels(self):
        return len(self.vox)

    def stats(self):
        return {"voxels": len(self.vox), "capacity": self.capacity,
                "updates": float(self._updates),
                "failed_inserts": self._failed}


def make_voxel_hash(capacity=1 << 20, voxel_size=0.03, trunc=0.12,
                    max_weight=100.0):
    """The native hash; raises when it cannot be built."""
    return NativeVoxelHash(capacity, voxel_size, trunc, max_weight)
