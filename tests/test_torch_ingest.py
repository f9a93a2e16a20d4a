"""The port's building ingest against the JAX reference: the CSV parse
with its bad lines, the point-in-triangle test, the grid geometry, the
three voxelizers (numpy, dense tensors, the native library) and the
CSV -> grid pipeline, native and numpy, each against the reference
package's numpy voxelizer bit for bit. The native cases skip only where
the library cannot be built here; ``use_native=True`` never falls back.
"""

import io

import numpy as np
import pytest
import torch

from ray_tracing_octrees_tpu.ingest import csv_loader as jcsv
from ray_tracing_octrees_tpu.ingest import voxelize as jvox
from ray_tracing_octrees_tpu_torch.core import cache
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.ingest import csv_loader as tcsv
from ray_tracing_octrees_tpu_torch.ingest import voxelize as tvox
from ray_tracing_octrees_tpu_torch.native import runtime

torch.set_num_threads(2)

VERTS_CSV = """mesh,vertex,easting,northing,elevation,lat,lon,elevmin
0, 0, 0.0, 0.0, 0.0, 51.0, -114.0, 0.0
0, 1, 10.0, 0.0, 0.0, 51.0, -114.0, 0.0
0, 2, 0.0, 10.0, 0.0, 51.0, -114.0, 0.0
0, 3, 0.0, 0.0, 10.0, 51.0, -114.0, 0.0
1, 0, 20.0, 20.0, 5.0, 51.0, -114.0, 0.0
garbage line that should be skipped
1, 1, 30.0, 20.0, 5.0, 51.0, -114.0, bad_number
"""

FACES_CSV = """mesh,v1,v2,v3
0, 0, 1, 2
0, 0, 1, 3
1, 0, 1, 99
short,row
"""

@pytest.fixture
def native():
    """Skip where the native library cannot be built (decided when a test
    runs, not when the module is imported by every worker)."""
    if not runtime.available():
        pytest.skip("the native library cannot be built here")


def square_tris():
    return np.array(
        [[[0.0, 0.0, 5.0], [10.0, 0.0, 5.0], [0.0, 10.0, 5.0]],
         [[10.0, 0.0, 5.0], [10.0, 10.0, 5.0], [0.0, 10.0, 5.0]]])


def seeded_mesh(seed, k, span=40.0, size=12.0):
    rng = np.random.default_rng(seed)
    return rng.random((k, 1, 3)) * span + (rng.random((k, 3, 3)) - 0.5) * size


def box_city(seed, n):
    """``n`` seeded box buildings of 12 triangles (the synthetic city's
    shape, small)."""
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        x0, y0 = rng.random(2) * 300.0
        w, d, h = 8.0 + rng.random(3) * np.array([30.0, 30.0, 90.0])
        c = np.array([[x0, y0, 0], [x0 + w, y0, 0], [x0 + w, y0 + d, 0],
                      [x0, y0 + d, 0]])
        top = c + np.array([0, 0, h])
        q = lambda a, b, cc, dd: [[a, b, cc], [a, cc, dd]]
        quads = q(c[0], c[1], c[2], c[3]) + q(top[0], top[1], top[2], top[3])
        for i in range(4):
            j = (i + 1) % 4
            quads += q(c[i], c[j], top[j], top[i])
        tris += quads
    return np.asarray(tris, np.float64)


MESHES = {"square": (square_tris, 1.0), "seeded50": (
    lambda: seeded_mesh(1, 50), 1.0), "seeded300": (
    lambda: seeded_mesh(2, 300), 0.7), "city": (lambda: box_city(3, 40), 2.5)}


def _same_grid(ref, got: VoxelGrid):
    np.testing.assert_array_equal(np.asarray(ref.occ), got.occ.numpy())
    np.testing.assert_array_equal(np.asarray(ref.origin), got.origin.numpy())
    assert np.float32(ref.voxel_size) == got.voxel_size.numpy()


def test_csv_parsing_with_error_recovery():
    v = tcsv.load_csv_vertices(io.StringIO(VERTS_CSV))
    f = tcsv.load_csv_faces(io.StringIO(FACES_CSV))
    np.testing.assert_array_equal(v, jcsv.load_csv_vertices(
        io.StringIO(VERTS_CSV)))
    np.testing.assert_array_equal(f, jcsv.load_csv_faces(
        io.StringIO(FACES_CSV)))
    assert v.shape == (5, 8) and f.shape == (3, 4)
    tris, kept = tcsv.assemble_triangles(v, f)
    jt, jk = jcsv.assemble_triangles(v, f)
    np.testing.assert_array_equal(tris, jt)
    assert kept.tolist() == jk.tolist() == [True, True, False]


def test_point_in_triangle_equals_jax():
    a, b, c = (np.array(p) for p in ([0.0, 0, 0], [1.0, 0, 0], [0.0, 1, 0]))
    for p, want in (([0.25, 0.25, 0.0], True), ([0.9, 0.9, 0.0], False),
                    ([0.25, 0.25, 5.0], True)):
        got = tvox.point_in_triangle(np.array(p), a, b, c)
        assert bool(got) == want == bool(jvox.point_in_triangle(
            np.array(p), a, b, c))
    assert not bool(tvox.point_in_triangle(np.zeros(3), a, a, a))
    # f32 points against seeded triangles, and points on the diagonals of
    # axis-aligned faces: the reference's numpy form (u, v in float64)
    rng = np.random.default_rng(5)
    tri = rng.random((64, 1, 3, 3)).astype(np.float32)
    pts = rng.random((64, 256, 3)).astype(np.float32)
    s = np.linspace(-0.5, 1.5, 81, dtype=np.float32)
    quad = np.array([[0, 0, 5], [10, 0, 5], [10, 10, 5]], np.float32)
    diag = np.stack([s * 10, s * 10, np.full_like(s, 5)], -1)
    for p_, a_, b_, c_ in ((pts, tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]),
                           (diag, *quad), (diag + 0.5, *quad)):
        ref = jvox.point_in_triangle(p_, a_, b_, c_)
        got = tvox.point_in_triangle(p_, a_, b_, c_)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_grid_geometry_auto_coarsen():
    tris = np.array([[[0, 0, 0], [5000.0, 0, 0], [0, 5000.0, 0]]])
    ref = jvox.grid_geometry(tris, voxel_size=1.0, max_axis=1000)
    lo, hi, vs, dims = tvox.grid_geometry(tris, voxel_size=1.0, max_axis=1000)
    assert max(dims) <= 1001 and vs > 1.0
    assert (vs, dims) == (ref[2], ref[3])
    np.testing.assert_array_equal(lo, ref[0])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_numpy_voxelizer_equals_jax(mesh):
    make, vs = MESHES[mesh]
    tris = make()
    _same_grid(jvox.voxelize_triangles(tris, vs),
               tvox.voxelize_triangles(tris, vs, device="cpu"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dense_voxelizer_equals_jax(mesh, monkeypatch):
    make, vs = MESHES[mesh]
    tris = make()
    # small chunks: several chunks of unequal boxes
    monkeypatch.setattr(tvox, "_DENSE_CELLS", 4096)
    ref = jvox.voxelize_triangles(tris, vs)
    _same_grid(ref, tvox.voxelize_triangles_dense(tris, vs, device="cpu"))
    assert int(np.asarray(ref.occ).sum()) > 50


def test_dense_voxelizer_equals_jax_dense():
    tris = square_tris()
    ref = jvox.voxelize_triangles_dense(tris, voxel_size=1.0, face_chunk=2)
    _same_grid(ref, tvox.voxelize_triangles_dense(tris, 1.0, device="cpu"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_native_voxelizer_equals_jax(native, mesh):
    make, vs = MESHES[mesh]
    tris = make()
    _same_grid(jvox.voxelize_triangles(tris, vs),
               runtime.voxelize_triangles(tris, vs, device="cpu"))


def test_native_csv_matches_numpy(native, tmp_path, rng):
    """Native parse + assembly == the numpy loader, with its bad lines,
    duplicate keys (the later row wins) and missing references."""
    vp, fp = tmp_path / "verts.csv", tmp_path / "faces.csv"
    vp.write_text(VERTS_CSV)
    fp.write_text(FACES_CSV)
    rows = [f"{int(rng.integers(0, 20))}, {int(rng.integers(0, 40))}, "
            + ", ".join(f"{x:.6f}" for x in rng.random(3) * 100)
            + ", 51.0, -114.0, 0.0" for _ in range(500)]
    vp2, fp2 = tmp_path / "verts2.csv", tmp_path / "faces2.csv"
    vp2.write_text("h\n" + "\n".join(rows) + "\n")
    fp2.write_text("h\n" + "\n".join(
        f"{int(rng.integers(0, 22))}, " + ", ".join(
            str(int(rng.integers(0, 44))) for _ in range(3))
        for _ in range(300)) + "\n")
    for v_path, f_path in ((vp, fp), (vp2, fp2)):
        v_np = tcsv.load_csv_vertices(str(v_path))
        f_np = tcsv.load_csv_faces(str(f_path))
        v_nat = runtime.parse_csv_file(str(v_path), 8, 8)
        f_nat = runtime.parse_csv_file(str(f_path), 4, 4)
        np.testing.assert_array_equal(v_nat, v_np)
        np.testing.assert_array_equal(f_nat, f_np)
        np.testing.assert_array_equal(v_np, jcsv.load_csv_vertices(
            str(v_path)))
        tris_np, kept_np = tcsv.assemble_triangles(v_np, f_np)
        tris_nat, kept_nat = runtime.assemble_triangles_native(v_nat, f_nat)
        np.testing.assert_array_equal(kept_nat, kept_np)
        np.testing.assert_array_equal(tris_nat, tris_np.astype(np.float32))


def test_native_cache_round_trip(native, tmp_path, rng):
    """Native write <-> the port's core/cache.py read, and back, whole
    and as a Z-slab."""
    occ = (rng.random((6, 5, 4)) > 0.5).astype(np.uint8)
    g = VoxelGrid.create(occ, origin=(1.0, 2.0, 3.0), voxel_size=0.5,
                         device="cpu")
    p = str(tmp_path / "native.bin")
    assert runtime.save_grid(p, g)
    np.testing.assert_array_equal(cache.load_voxel_grid(
        p, device="cpu").occ.numpy(), occ)
    p2 = str(tmp_path / "py.bin")
    cache.save_voxel_grid(p2, g)
    np.testing.assert_array_equal(runtime.load_grid(
        p2, device="cpu").occ.numpy(), occ)
    g4 = runtime.load_grid(p2, start_layer=2, num_layers=3, device="cpu")
    np.testing.assert_array_equal(g4.occ.numpy(), occ[2:5])
    np.testing.assert_allclose(g4.origin.numpy(), [1.0, 2.0, 3.0 + 2 * 0.5])


@pytest.mark.parametrize("use_native", [True, False])
def test_load_csv_into_voxel_grid_equals_jax(request, tmp_path, use_native):
    """End-to-end CSV -> grid, native and numpy, against the reference's
    numpy pipeline: grid, origin and voxel size."""
    if use_native:
        request.getfixturevalue("native")
    vp, fp = tmp_path / "verts.csv", tmp_path / "faces.csv"
    vp.write_text(VERTS_CSV)
    fp.write_text(FACES_CSV)
    ref = jvox.load_csv_into_voxel_grid(str(vp), str(fp), voxel_size=1.0,
                                        use_native=False)
    got = tvox.load_csv_into_voxel_grid(str(vp), str(fp), voxel_size=1.0,
                                        use_native=use_native, device="cpu")
    _same_grid(ref, got)


def test_seeded_city_equals_jax(tmp_path):
    """The seeded city of ingest/city.py (2000 buildings, bad lines, UTM
    coordinates, voxel centres on faces' diagonals): the CSV pipeline,
    native and numpy, and the dense voxelizer give the reference
    package's numpy grid bit for bit."""
    from ray_tracing_octrees_tpu_torch.ingest.city import write_city_csv

    vp, fp, counts = write_city_csv(str(tmp_path))
    ref = jvox.load_csv_into_voxel_grid(vp, fp, voxel_size=5.0,
                                        use_native=False)
    assert tuple(np.asarray(ref.occ).shape) == (30, 252, 432)
    got = tvox.load_csv_into_voxel_grid(vp, fp, 5.0, use_native=False,
                                        device="cpu")
    _same_grid(ref, got)
    tris, kept = tcsv.assemble_triangles(tcsv.load_csv_vertices(vp),
                                         tcsv.load_csv_faces(fp))
    assert tris.shape[0] == counts["faces"] and (~kept).sum() == 5
    _same_grid(ref, tvox.voxelize_triangles_dense(tris, 5.0, device="cpu"))
    if runtime.available():
        _same_grid(ref, tvox.load_csv_into_voxel_grid(
            vp, fp, 5.0, use_native=True, device="cpu"))


def test_use_native_never_falls_back(tmp_path, monkeypatch):
    """A native build that cannot run raises with the reason; it does not
    drop to numpy."""
    vp, fp = tmp_path / "verts.csv", tmp_path / "faces.csv"
    vp.write_text(VERTS_CSV)
    fp.write_text(FACES_CSV)
    monkeypatch.setattr(runtime, "CXX_CANDIDATES",
                        (str(tmp_path / "missing" / "g++"),))
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    assert not runtime.available()
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        tvox.load_csv_into_voxel_grid(str(vp), str(fp), voxel_size=1.0,
                                      use_native=True, device="cpu")
    assert tvox.load_csv_into_voxel_grid(
        str(vp), str(fp), voxel_size=1.0, use_native=False,
        device="cpu") is not None
