"""Mesh file loading (OBJ / STL) -> vertex clouds for GEOM_MESH geoms.

Pure numpy readers that extract the vertex cloud; faces are not needed,
because collision treats a mesh as a convex vertex set
(collision/narrowphase.py GEOM_MESH, collision/support.py).  The port's
own copy of the JAX package's model/mesh_loader.py.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def load_obj(path_or_text) -> np.ndarray:
    """Wavefront OBJ (a path, or the text itself) -> unique (V, 3)
    vertices (``v x y z`` lines only)."""
    if isinstance(path_or_text, (str, Path)) and "\n" not in str(path_or_text):
        text = Path(path_or_text).read_text()
    else:
        text = str(path_or_text)
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 4 and parts[0] == "v":
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if not verts:
        raise ValueError("OBJ contains no vertices")
    return np.unique(np.asarray(verts, dtype=np.float64), axis=0)


def load_stl(path) -> np.ndarray:
    """STL (binary or ASCII) -> unique (V, 3) vertices."""
    raw = Path(path).read_bytes()
    # ASCII STL starts with "solid" AND contains "facet" as text
    head = raw[:512].lower()
    if head.startswith(b"solid") and b"facet" in head:
        verts = []
        for line in raw.decode("ascii", errors="replace").splitlines():
            parts = line.split()
            if len(parts) == 4 and parts[0] == "vertex":
                verts.append([float(p) for p in parts[1:]])
        if not verts:
            raise ValueError("ASCII STL contains no vertices")
        return np.unique(np.asarray(verts, dtype=np.float64), axis=0)
    # binary: 80-byte header, uint32 triangle count, 50 bytes a triangle
    if len(raw) < 84:
        raise ValueError("binary STL truncated")
    (ntri,) = struct.unpack_from("<I", raw, 80)
    if len(raw) < 84 + 50 * ntri:
        raise ValueError("binary STL truncated")
    tris = np.frombuffer(raw, dtype=np.uint8, count=50 * ntri, offset=84)
    tris = tris.reshape(ntri, 50)[:, :48].copy().view("<f4").reshape(
        ntri, 4, 3)
    verts = tris[:, 1:, :].reshape(-1, 3).astype(np.float64)  # no normals
    return np.unique(verts, axis=0)


def load_mesh(path, scale=1.0) -> np.ndarray:
    """Dispatch by extension; returns scaled (V, 3) float64 vertices."""
    p = Path(path)
    ext = p.suffix.lower()
    if ext == ".obj":
        v = load_obj(p)
    elif ext == ".stl":
        v = load_stl(p)
    else:
        raise NotImplementedError(
            f"mesh format {ext!r}: OBJ and STL are supported (convert "
            "other formats offline)")
    return v * np.asarray(scale, dtype=np.float64)
