"""ctypes bridge to the native C++ BVH builder (native/bvh_builder.cpp).

Drop-in replacement for the Python SAH build + octant pack: one call
produces the PackedBVH tables (tests assert both paths agree).  The shared
library is compiled from source at first use into ``<checkout>/build/``
(listed in .gitignore), one file per source version; ``python -m
tpu_pt.bvh.native`` builds it ahead of time.  A failed build raises: the
pure-Python SAH path takes minutes at a million primitives, so it is never
taken silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from tpu_pt.bvh.packed import PackedBVH
from tpu_pt.bvh.sah import prim_bounds
from tpu_pt.scene.types import Scene

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_CHECKOUT, "native", "bvh_builder.cpp")
BUILD_DIR = os.path.join(_CHECKOUT, "build")
_lib = None


def lib_path() -> str:
    """Where the library for the current source lives (keyed by its hash)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libbvh-{digest}.so")


def build() -> str:
    """Compile native/bvh_builder.cpp unless this source version is built;
    return the library path.  Concurrent builders each write a private
    temporary file and rename it into place."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"native BVH builder failed to compile ({' '.join(cmd)}):\n"
                + res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.bvh_emit.restype = None
        lib.bvh_emit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.bvh_count_leaves.restype = ctypes.c_int
        lib.bvh_count_leaves.argtypes = [ctypes.c_void_p]
        lib.bvh_emit_leaves.restype = None
        lib.bvh_emit_leaves.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    return _lib


def build_leaves(scene: Scene, max_leaf: int):
    """Native SAH build -> (start, count, lo, hi, prim_perm) leaf arrays in
    DFS order (the cluster-BVH host build)."""
    lib = _load()
    lo, hi = prim_bounds(scene)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    n_nodes = ctypes.c_int(0)
    handle = lib.bvh_build(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, max_leaf, ctypes.byref(n_nodes),
    )
    n_leaves = lib.bvh_count_leaves(ctypes.c_void_p(handle))
    l_lo = np.empty((n_leaves, 3), np.float32)
    l_hi = np.empty((n_leaves, 3), np.float32)
    start = np.empty((n_leaves,), np.int32)
    count = np.empty((n_leaves,), np.int32)
    perm = np.empty((n,), np.int32)
    lib.bvh_emit_leaves(
        ctypes.c_void_p(handle),
        l_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        l_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        start.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        count.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return start, count, l_lo, l_hi, perm


def _prim_rows(scene: Scene, pid: np.ndarray) -> np.ndarray:
    """Packed 16-wide primitive rows in leaf order (same as packed.pack_bvh)."""
    v = np.asarray(scene.vertices)
    ti = np.asarray(scene.tri_idx)
    tm = np.asarray(scene.tri_mat)
    sc = np.asarray(scene.sph_center)
    sr = np.asarray(scene.sph_radius)
    sm = np.asarray(scene.sph_mat)
    n_tris = ti.shape[0]
    rows = np.zeros((len(pid), 16), np.float32)
    is_tri = pid < n_tris
    tg = pid[is_tri]
    v0 = v[ti[tg, 0]]
    rows[is_tri, 0:3] = v0
    rows[is_tri, 3:6] = v[ti[tg, 1]] - v0
    rows[is_tri, 6:9] = v[ti[tg, 2]] - v0
    rows[is_tri, 9] = tm[tg].astype(np.int32).view(np.float32)
    sg = pid[~is_tri] - n_tris
    rows[~is_tri, 0:3] = sc[sg]
    rows[~is_tri, 3] = sr[sg]
    rows[~is_tri, 9] = sm[sg].astype(np.int32).view(np.float32)
    rows[~is_tri, 10] = 1.0
    return rows


def build_packed(scene: Scene, max_leaf: int = 4) -> PackedBVH:
    """Native binned-SAH build → PackedBVH."""
    lib = _load()
    lo, hi = prim_bounds(scene)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    n_nodes = ctypes.c_int(0)
    handle = lib.bvh_build(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, max_leaf, ctypes.byref(n_nodes),
    )
    nodes = np.empty((8, n_nodes.value, 8), np.float32)
    perm = np.empty((n,), np.int32)
    lib.bvh_emit(
        ctypes.c_void_p(handle),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return PackedBVH.build(nodes=nodes, prims=_prim_rows(scene, perm),
                           prim_gid=perm, max_leaf=max_leaf)


if __name__ == "__main__":
    print(build())
