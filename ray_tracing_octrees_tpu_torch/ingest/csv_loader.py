"""Building-footprint CSV ingest (the Calgary digital-terrain format).

Counterpart of ``ray_tracing_octrees_tpu/ingest/csv_loader.py`` (plain
numpy, a copy kept by the port): ``loadCSVVertices`` / ``loadCSVFaces``
(BuildingLoader.cpp:35-129). DTVerts.csv rows are (mesh#, vertex#,
easting, northing, elevation, lat, lon, elevMin) and DTFaces.csv rows
are (mesh#, v1, v2, v3). Parsing trims tokens, skips short rows, and
recovers per line on malformed numbers, like the reference. Vertices are
keyed by (mesh#, vertex#) when assembling faces; faces referencing
missing vertices are dropped (BuildingLoader.cpp:236-245).
"""

from __future__ import annotations

import numpy as np


def _parse_csv(path_or_buf, min_tokens: int, n_numeric: int):
    """Tolerant CSV parse: skip header, trim tokens, recover per line."""
    if hasattr(path_or_buf, "read"):
        f = path_or_buf
        close = False
    else:
        f = open(path_or_buf, "r")
        close = True
    rows = []
    try:
        f.readline()  # header
        for line in f:
            line = line.strip()
            if not line:
                continue
            tokens = [t.strip() for t in line.split(",")]
            if len(tokens) < min_tokens:
                continue
            try:
                rows.append([float(tokens[i]) for i in range(n_numeric)])
            except ValueError:
                continue
    finally:
        if close:
            f.close()
    return np.asarray(rows, np.float64).reshape(-1, n_numeric)


def load_csv_vertices(path) -> np.ndarray:
    """float64[N, 8]: mesh#, vertex#, easting, northing, elevation, lat, lon, elevMin."""
    return _parse_csv(path, min_tokens=8, n_numeric=8)


def load_csv_faces(path) -> np.ndarray:
    """float64[M, 4]: mesh#, v1, v2, v3."""
    return _parse_csv(path, min_tokens=4, n_numeric=4)


def assemble_triangles(verts: np.ndarray, faces: np.ndarray):
    """Resolve (mesh#, vertex#) face references to triangle vertex positions.

    Returns (tri_verts float64[K, 3, 3] as (easting, northing, elevation),
    kept_mask bool[M]) with faces dropped when any reference is missing.
    """
    key = {}
    for i in range(verts.shape[0]):
        key[(int(verts[i, 0]), int(verts[i, 1]))] = i
    pos = verts[:, 2:5]
    out = []
    kept = np.zeros(faces.shape[0], bool)
    for j in range(faces.shape[0]):
        m = int(faces[j, 0])
        ids = [key.get((m, int(faces[j, 1 + k]))) for k in range(3)]
        if any(i is None for i in ids):
            continue
        out.append(pos[ids])
        kept[j] = True
    if out:
        return np.stack(out), kept
    return np.zeros((0, 3, 3), np.float64), kept
