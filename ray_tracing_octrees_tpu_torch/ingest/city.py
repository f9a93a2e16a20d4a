"""A seeded synthetic city in the Calgary digital-terrain CSV format.

The Calgary ``DT/DTVerts.csv`` and ``DT/DTFaces.csv`` are not in the
repository; this writes a city of the same format and size class for the
ingest path (``ingest/voxelize.load_csv_into_voxel_grid``), its tests
and ``chip_smoke.py``: box buildings over about 2 100 m x 1 200 m, 6 to
135 m tall, at UTM-sized coordinates, with malformed lines of every kind
the loader must skip. At 5 m voxels it gives a 432x252x30 grid
(Calgary's is 425x243x29).
"""

from __future__ import annotations

import os

import numpy as np

CITY_BUILDINGS = 2000
CITY_SEED = 20260


def write_city_csv(dirpath: str, seed: int = CITY_SEED,
                   n: int = CITY_BUILDINGS):
    """A seeded city of ``n`` box buildings (8 vertices, 12 triangles
    each) over ~2100 m x 1200 m, 6-135 m tall, written as DTVerts.csv
    (mesh#, vertex#, easting, northing, elevation, lat, lon, elevMin) and
    DTFaces.csv (mesh#, v1, v2, v3) with UTM-sized coordinates and some
    malformed lines: a garbage line, a bad number, short rows and faces
    naming a missing vertex. Returns (verts path, faces path, counts)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(12.0, 60.0, n)
    d = rng.uniform(12.0, 60.0, n)
    x0 = rng.uniform(0.0, 2100.0, n) - w / 2
    y0 = rng.uniform(0.0, 1200.0, n) - d / 2
    h = np.where(rng.random(n) < 0.03, rng.uniform(90.0, 135.0, n),
                 np.clip(6.0 + rng.gamma(1.6, 12.0, n), 6.0, 80.0))
    z0 = 1045.0 + rng.uniform(0.0, 3.0, n)
    east, north = 700000.0, 5655000.0
    vlines = ["mesh,vertex,easting,northing,elevation,lat,lon,elevmin"]
    flines = ["mesh,v1,v2,v3"]
    quad = lambda a, b, c, e: [(a, b, c), (a, c, e)]
    faces = (quad(0, 1, 2, 3) + quad(4, 5, 6, 7)
             + [t for i in range(4) for t in quad(i, (i + 1) % 4,
                                                 4 + (i + 1) % 4, 4 + i)])
    for m in range(n):
        cx = [x0[m], x0[m] + w[m], x0[m] + w[m], x0[m]]
        cy = [y0[m], y0[m], y0[m] + d[m], y0[m] + d[m]]
        for v in range(8):
            ex, ny = east + cx[v % 4], north + cy[v % 4]
            el = z0[m] + (h[m] if v >= 4 else 0.0)
            vlines.append(f"{m}, {v}, {ex:.3f}, {ny:.3f}, {el:.3f}, "
                          f"{51.0 + cy[v % 4] * 9e-6:.7f}, "
                          f"{-114.0 + cx[v % 4] * 1.4e-5:.7f}, {z0[m]:.3f}")
        for a, b, c in faces:
            flines.append(f"{m}, {a}, {b}, {c}")
        if m % 400 == 7:
            vlines.append("garbage line that should be skipped")
            vlines.append(f"{m}, 50, 1.0, 2.0, bad_number, 51.0, -114.0, 0.0")
            vlines.append(f"{m}, 51")
            flines.append(f"{m}, 0, 1, 99")
            flines.append("short,row")
    vp = os.path.join(dirpath, "DTVerts.csv")
    fp = os.path.join(dirpath, "DTFaces.csv")
    with open(vp, "w") as f:
        f.write("\n".join(vlines) + "\n")
    with open(fp, "w") as f:
        f.write("\n".join(flines) + "\n")
    return vp, fp, dict(buildings=n, vertex_lines=len(vlines) - 1,
                        face_lines=len(flines) - 1, faces=12 * n)
