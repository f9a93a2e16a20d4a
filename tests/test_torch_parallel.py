"""Port vs JAX reference: the multi-device paths (``parallel/mesh.py``,
``parallel/sharding.py``, ``parallel/distributed.py``).

JAX's functions run in this process on the 8-device virtual CPU mesh of
``tests/conftest.py``; the port's run in 8 gloo ranks on the CPU, spawned
once for the module with a ``file://`` store in the test's temporary
directory (parallel test workers never share a port). Each rank starts
its group through ``initialize_distributed``, calls every function with
the same full inputs (JAX's rays, JAX's 32^3 shadow volume and volume
textures) and saves what it returned; the rank function imports no JAX.

Bars, against JAX on the same inputs:
- ``trace_sharded`` / ``trace_shardmap`` (16^3 sphere, 16x16 rays,
  ``max_steps=128``): hit and t equal, normal within 1e-5;
  ``trace_segmented`` on (dp, tp) = (2, 4): hit and t equal, point and
  normal within 1e-5; ``render_image_sharded``, shadows on and off:
  within 1e-5;
- ``marching_cubes_halo`` on the 24^3 sphere over tp = 8: counts equal,
  the lattice keys of ``tests/test_parallel.py`` equal, vertices within
  1e-6; against the port's dense MC as multisets;
- ``sweep_frame_segmented`` (32^3 sphere, 64x64; with and without the
  shadow volume, and from the interior camera): bitwise the port's
  ``render_fast_frame(fused=False)``; against JAX's segmented frame the
  pipelined frames' bars (``tests/test_torch_pipeline.py``): equal hit
  masks, within 1e-5 on more than 98.5 % of pixels and 1.5/255 on all
  (the port's rays differ from JAX's by an ulp where XLA fuses them);
- ``volume_frame_segmented`` (32^3 sphere, 64x64): bitwise the port's
  ``render_volume_frame`` in colour, depth, normal and alpha; against
  JAX's segmented frame the bars of ``tests/test_torch_raymarch_sweep.py``
  (equal alpha masks, colour within 1e-4 on all but 0.5 % of pixels);
- every rank returns the same global result.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ray_tracing_octrees_tpu_torch.parallel import distributed as tdist
from ray_tracing_octrees_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

WORLD = 8
W = H = 64
FAST_POSES = {"shadow": (0.3, 0.7, 2.5, True),
              "no_shadow": (0.3, 0.7, 2.5, False),
              "interior": (0.05, 0.1, 0.02, True)}
VOLUME_POSE = (0.5, 0.8, 2.2)
TIME_VALUE = 0.25


def _cam(theta, phi, radius):
    from ray_tracing_octrees_tpu_torch.render.camera import Camera

    cam = Camera(theta=theta, phi=phi, radius=radius)
    return (np.asarray(cam.get_pos(), np.float32),
            np.asarray(cam.get_view(), np.float32))


def _rank_main(rank: int, store: str, inp_path: str, out_dir: str):
    """One gloo rank: every case, its outputs saved to rank<r>.pt."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tracing_octrees_tpu_torch import convert
    from ray_tracing_octrees_tpu_torch.parallel import sharding as sh
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ss

    started = tdist.initialize_distributed(f"file://{store}", WORLD, rank,
                                           device="cpu")
    inp = torch.load(inp_path, weights_only=False)
    s = tdist.local_slice(100)
    out = dict(started=started, local_slice=(s.start, s.stop))
    m8 = tmesh.make_mesh(device="cpu")
    m24 = tmesh.make_mesh(8, dp=2, tp=4, device="cpu")
    m18 = tmesh.make_mesh(8, dp=1, tp=8, device="cpu")
    m4 = tmesh.make_mesh(4, device="cpu")
    sp = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("sp",))
    out["mesh_shapes"] = [tuple(m.shape) for m in (m8, m24, m18, m4)]
    try:
        tmesh.make_mesh(2 * WORLD, device="cpu")
        out["sub_mesh_above_group"] = None
    except ValueError as e:
        out["sub_mesh_above_group"] = str(e)

    g16 = inp["g16"]
    rays = (g16["occ"], inp["o"], inp["d"], g16["origin"], g16["vs"])
    out["trace_sharded"] = sh.trace_sharded(m8, *rays, max_steps=128)
    out["trace_shardmap"] = sh.trace_shardmap(m8, *rays, max_steps=128)
    # ranks 4-7 lie outside m4: None there, and no collective joined
    out["sub_mesh_coordinate"] = m4.get_coordinate()
    out["sub_mesh_trace"] = sh.trace_sharded(m4, *rays, max_steps=128)
    out["trace_segmented"] = sh.trace_segmented(m24, *rays, max_steps=128)
    for shadows in (True, False):
        out[f"render_{shadows}"] = sh.render_image_sharded(
            m8, *rays, max_steps=128, shadows=shadows)

    g24 = inp["g24"]
    out["mc_halo"] = sh.marching_cubes_halo(
        m18, g24["occ"], g24["origin"], g24["vs"], inp["mc_cap"])

    g32 = inp["g32"]
    vol, sv = inp["vol32"], inp["sv32"]
    for name, (th, ph, rad, with_sv) in FAST_POSES.items():
        pos, view = _cam(th, ph, rad)
        args = (vol, sv if with_sv else None, g32["origin"], g32["vs"],
                pos, view, 45.0, 1.0, W, H)
        out[f"fast_{name}"] = sh.sweep_frame_segmented(sp, *args)
        if rank == 0:
            out[f"fast_{name}_single"] = ss.render_fast_frame(
                *args, device="cpu", fused=False)

    tex = convert.textures_from_numpy(inp["textures"], device="cpu")
    scene = rs.prepare_volume_scene(tex, float(g32["vs"]), device="cpu")
    pos, view = _cam(*VOLUME_POSE)
    args = (g32["origin"], pos, view, 45.0, 1.0, W, H)
    out["volume"] = sh.volume_frame_segmented(sp, scene, *args,
                                              time_value=TIME_VALUE)
    if rank == 0:
        out["volume_single"] = rs.render_volume_frame(
            scene, *args, time_value=TIME_VALUE, device="cpu")
    # several segments hold slabs: 96 slab rows over 8 ranks of 32 rows,
    # and 64 of the volume's
    g96 = inp["g96"]
    pos, view = _cam(0.9, 0.8, 2.0)
    args = (inp["vol96"], inp["sv96"], g96["origin"], g96["vs"], pos, view,
            45.0, 16 / 9, 96, 54)
    out["fast_96"] = sh.sweep_frame_segmented(sp, *args)
    tex = convert.textures_from_numpy(inp["textures64"], device="cpu")
    scene = rs.prepare_volume_scene(tex, float(inp["g64"]["vs"]),
                                    device="cpu")
    args64 = (inp["g64"]["origin"], pos, view, 45.0, 16 / 9, 96, 54)
    out["volume_64"] = sh.volume_frame_segmented(sp, scene, *args64)
    if rank == 0:
        out["fast_96_single"] = ss.render_fast_frame(*args, device="cpu",
                                                     fused=False)
        out["volume_64_single"] = rs.render_volume_frame(scene, *args64,
                                                         device="cpu")
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _np_grid(g):
    """A grid's arrays on the host (either package's grid)."""
    host = lambda x: x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return dict(occ=host(g.occ), origin=host(g.origin).astype(np.float32),
                vs=np.float32(host(g.voxel_size)))


def _port_inputs() -> dict:
    """The port's own 96^3 sphere with its shadow volume and 64^3 volume
    textures: scenes of several 32-slab segments."""
    from ray_tracing_octrees_tpu_torch import convert
    from ray_tracing_octrees_tpu_torch.core.grid import (
        make_sphere_grid as t_sphere,
    )
    from ray_tracing_octrees_tpu_torch.models.volume_raycaster import (
        VolumeRaycastRenderer,
    )
    from ray_tracing_octrees_tpu_torch.trace.slab_sweep import shadow_volume

    g96, g64 = t_sphere(96, device="cpu"), t_sphere(64, device="cpu")
    vol96 = (g96.occ > 0).to(torch.float32)
    r = VolumeRaycastRenderer(device="cpu").init(g64)
    return dict(g96=_np_grid(g96), vol96=vol96.numpy(),
                sv96=shadow_volume(vol96, (0.5, 0.9, 0.4),
                                   device="cpu").numpy(),
                g64=_np_grid(g64),
                textures64=convert.textures_to_numpy(r.textures))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each rank's outputs): the 8 ranks run while JAX's
    functions run here."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu.models.volume_raycaster import (
        VolumeRaycastRenderer,
    )
    from ray_tracing_octrees_tpu.ops.marching_cubes import count_mc_triangles
    from ray_tracing_octrees_tpu.parallel import sharding as jsh
    from ray_tracing_octrees_tpu.parallel.mesh import make_mesh
    from ray_tracing_octrees_tpu.render.camera import generate_rays
    from ray_tracing_octrees_tpu.trace.raymarch_sweep import (
        prepare_volume_scene,
    )
    from ray_tracing_octrees_tpu.trace.slab_sweep import shadow_volume
    from ray_tracing_octrees_tpu_torch import convert

    g16, g24, g32 = (make_sphere_grid(n) for n in (16, 24, 32))
    pos, view = _cam(0.3, 0.7, 2.0)
    o, d = generate_rays(16, 16, jnp.asarray(pos), jnp.asarray(view), 45.0,
                         1.0)
    vol = (jnp.asarray(g32.occ) > 0).astype(jnp.float32)
    sv = shadow_volume(vol, (-1.0, -1.0, -1.0))
    jr = VolumeRaycastRenderer().init(g32)
    cap = int(count_mc_triangles(g24))
    inp = dict(g16=_np_grid(g16), g24=_np_grid(g24), g32=_np_grid(g32),
               o=np.asarray(o), d=np.asarray(d), vol32=np.asarray(vol),
               sv32=np.asarray(sv), mc_cap=cap,
               textures=convert.textures_to_numpy(
                   convert.textures_from_numpy(jr.textures, device="cpu")))
    inp.update(_port_inputs())
    tmp = tmp_path_factory.mktemp("ranks")
    inp_path = str(tmp / "inputs.pt")
    torch.save(inp, inp_path)
    ctx = mp.spawn(_rank_main, args=(str(tmp / "store"), inp_path, str(tmp)),
                   nprocs=WORLD, join=False)

    rays = (g16.occ, o, d, g16.origin, g16.voxel_size)
    m8 = make_mesh(8)
    m24 = make_mesh(8, dp=2, tp=4)
    sp = Mesh(np.array(jax.devices()).reshape(8), ("sp",))
    np_dict = lambda r: {k: np.asarray(v) for k, v in r.items()}
    ref = dict(
        trace_sharded=np_dict(jsh.trace_sharded(m8, *rays, max_steps=128)),
        trace_shardmap=np_dict(jsh.trace_shardmap(m8, *rays, max_steps=128)),
        sub_mesh_trace=np_dict(jsh.trace_sharded(make_mesh(4), *rays,
                                                 max_steps=128)),
        trace_segmented=np_dict(jsh.trace_segmented(m24, *rays,
                                                    max_steps=128)),
        mc_halo=tuple(np.asarray(x) for x in jsh.marching_cubes_halo(
            make_mesh(8, dp=1, tp=8), g24.occ, g24.origin, g24.voxel_size,
            max_triangles_per_shard=cap)))
    for shadows in (True, False):
        ref[f"render_{shadows}"] = np.asarray(jsh.render_image_sharded(
            m8, *rays, max_steps=128, shadows=shadows))
    for name, (th, ph, rad, with_sv) in FAST_POSES.items():
        pos, view = _cam(th, ph, rad)
        ref[f"fast_{name}"] = np.asarray(jsh.sweep_frame_segmented(
            sp, vol, sv if with_sv else None, g32.origin, g32.voxel_size,
            pos, view, 45.0, 1.0, W, H))
    scene = prepare_volume_scene(jr.textures, float(g32.voxel_size))
    pos, view = _cam(*VOLUME_POSE)
    ref["volume"] = np_dict(jsh.volume_frame_segmented(
        sp, scene, g32.origin, pos, view, 45.0, 1.0, W, H,
        time_value=TIME_VALUE))
    ref["g24"] = g24

    while not ctx.join():
        pass
    outs = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return ref, outs


def _same(a, b) -> bool:
    """``a`` and ``b`` (tensors, or dicts / tuples of them) equal bitwise."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def test_every_rank_returns_the_global_result(runs):
    _, outs = runs
    for r, out in enumerate(outs[1:], 1):
        for k, v in out.items():
            if (k not in ("local_slice",) and not k.endswith("_single")
                    and not k.startswith("sub_mesh")):
                assert _same(v, outs[0][k]), (r, k)


def test_make_mesh_shapes(runs):
    _, outs = runs
    assert outs[0]["mesh_shapes"] == [(4, 2), (2, 4), (1, 8), (2, 2)]


def test_make_mesh_below_the_group(runs):
    """make_mesh(4) in the 8-rank group: a (2, 2) mesh over ranks 0-3,
    each of which gets JAX's make_mesh(4) trace (on its 8 virtual
    devices) from trace_sharded at the bars of the full mesh's (hit and t
    equal, normal within 1e-5); ranks 4-7 lie outside it and get None.
    A mesh above the group's size raises."""
    ref, outs = runs
    want = ref["sub_mesh_trace"]
    for r, out in enumerate(outs):
        got = out["sub_mesh_trace"]
        if r >= 4:
            assert got is None and out["sub_mesh_coordinate"] is None, r
            continue
        assert tuple(out["sub_mesh_coordinate"]) == (r // 2, r % 2), r
        np.testing.assert_array_equal(got["hit"].numpy(), want["hit"])
        np.testing.assert_array_equal(got["t"].numpy(), want["t"])
        np.testing.assert_allclose(got["normal"].numpy(), want["normal"],
                                   rtol=0, atol=1e-5)
        assert _same(got, outs[0]["sub_mesh_trace"]), r
    assert want["hit"].any() and not want["hit"].all()
    assert "n_devices=16 > the group's 8 ranks" in outs[0]["sub_mesh_above_group"]


def test_make_mesh_rejects_a_bad_split():
    with pytest.raises(ValueError, match="dp\\*tp=6"):
        tmesh.make_mesh(8, dp=3, tp=2, device="cpu")
    with pytest.raises(ValueError):
        tmesh.make_mesh(8, tp=3, device="cpu")


def test_initialize_distributed_single_process_noop():
    assert tdist.initialize_distributed(device="cpu") is False
    assert tdist.local_slice(100) == slice(0, 100)


def test_entry_points_need_a_device_named():
    """Without CUDA the mesh and the start-up raise unless the caller
    names the CPU; nothing falls back to it quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.initialize_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(8)


def test_local_slice_in_ranks(runs):
    """Each rank's slice is JAX's formula over 8 processes."""
    _, outs = runs
    per = (100 + WORLD - 1) // WORLD
    for r, out in enumerate(outs):
        assert out["started"] is True
        assert out["local_slice"] == (r * per, min(100, (r + 1) * per))


@pytest.mark.parametrize("name", ["trace_sharded", "trace_shardmap"])
def test_sharded_traces_match_jax(runs, name):
    ref, outs = runs
    got, want = outs[0][name], ref[name]
    np.testing.assert_array_equal(got["hit"].numpy(), want["hit"])
    np.testing.assert_array_equal(got["t"].numpy(), want["t"])
    np.testing.assert_allclose(got["normal"].numpy(), want["normal"],
                               rtol=0, atol=1e-5)
    assert want["hit"].any() and not want["hit"].all()


def test_segmented_trace_matches_jax(runs):
    ref, outs = runs
    got, want = outs[0]["trace_segmented"], ref["trace_segmented"]
    np.testing.assert_array_equal(got["hit"].numpy(), want["hit"])
    np.testing.assert_array_equal(got["t"].numpy(), want["t"])
    for k in ("point", "normal"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("shadows", [True, False])
def test_render_image_sharded_matches_jax(runs, shadows):
    ref, outs = runs
    got, want = outs[0][f"render_{shadows}"], ref[f"render_{shadows}"]
    assert got.shape == want.shape == (256, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _lattice_sorted(tris, nrms, vs):
    """Rows sorted by the exact vs/2 lattice keys of
    ``tests/test_parallel.py``: (verts, keys, normals)."""
    flat = tris.reshape(len(tris), -1)
    q = np.round(flat / (vs / 2)).astype(np.int64)
    order = np.lexsort(q.T)
    return flat[order], q[order], nrms[order]


def test_marching_cubes_halo_matches_jax_and_dense(runs):
    from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        marching_cubes_grid,
    )

    ref, outs = runs
    hv, hn, hc = (x.numpy() for x in outs[0]["mc_halo"])
    jv, jn, jc = ref["mc_halo"]
    np.testing.assert_array_equal(hc, jc)
    cap = hv.shape[0] // 8
    assert hv.shape == jv.shape and cap == jv.shape[0] // 8

    def parts(v, n, c):
        return (np.concatenate([v[s * cap:s * cap + c[s]] for s in range(8)]),
                np.concatenate([n[s * cap:s * cap + c[s]] for s in range(8)]))

    g24 = ref["g24"]
    vs = float(np.asarray(g24.voxel_size))
    h_v, h_k, h_n = _lattice_sorted(*parts(hv, hn, hc), vs)
    j_v, j_k, j_n = _lattice_sorted(*parts(jv, jn, jc), vs)
    np.testing.assert_array_equal(h_k, j_k)
    np.testing.assert_allclose(h_v, j_v, rtol=0, atol=1e-6)
    np.testing.assert_allclose(h_n, j_n, rtol=0, atol=1e-5)

    grid = VoxelGrid.create(np.asarray(g24.occ), np.asarray(g24.origin),
                            float(vs), device="cpu")
    dv, dn, dc = marching_cubes_grid(grid, max_triangles=cap + 8,
                                     device="cpu")
    dv, dn = dv[:int(dc)].numpy(), dn[:int(dc)].numpy()
    assert int(hc.sum()) == int(dc)
    d_v, d_k, d_n = _lattice_sorted(dv, dn, vs)
    np.testing.assert_array_equal(h_k, d_k)
    np.testing.assert_allclose(h_v, d_v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(h_n, d_n, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(FAST_POSES))
def test_sweep_frame_segmented(runs, name):
    ref, outs = runs
    got = outs[0][f"fast_{name}"]
    assert torch.equal(got, outs[0][f"fast_{name}_single"])
    got, want = got.numpy(), ref[f"fast_{name}"]
    lit = want[..., :3].max(-1) > 0
    np.testing.assert_array_equal(got[..., :3].max(-1) > 0, lit)
    diff = np.abs(got - want).max(-1)
    assert (diff <= 1e-5).mean() > 0.985
    assert diff.max() <= 1.5 / 255.0
    assert lit.any()


def test_volume_frame_segmented(runs):
    ref, outs = runs
    got, single = outs[0]["volume"], outs[0]["volume_single"]
    for k in ("color", "depth", "normal", "alpha"):
        assert torch.equal(got[k], single[k]), k
    want = ref["volume"]
    np.testing.assert_array_equal(got["alpha"].numpy() >= 0.1,
                                  want["alpha"] >= 0.1)
    diff = np.abs(got["color"].numpy() - want["color"]).max(-1)
    assert (diff > 1e-4).mean() <= 0.005
    assert want["color"][..., :3].max() > 0


@pytest.mark.parametrize("name", ["fast_96", "volume_64"])
def test_segmented_frames_over_several_segments(runs, name):
    """Scenes whose sweep spans several ranks' segments (96 and 64 of the
    8 x 32 rows): bitwise the single-device frame."""
    _, outs = runs
    got, single = outs[0][name], outs[0][f"{name}_single"]
    assert _same(got, single)
    img = got if torch.is_tensor(got) else got["color"]
    assert (img[..., :3].amax(-1) > 0).float().mean() > 0.1


def test_sweep_core_o_base_segments():
    """In one process: the segments' first_o, each swept with its own
    o_base, min-combine to the full sweep bitwise (the shadow sample
    picked from the winning segment), equal JAX's ``_sweep_core`` with the
    same o_base on a segment, and o_base=0 leaves the sweep as it was."""
    import jax.numpy as jnp

    from ray_tracing_octrees_tpu.trace import slab_sweep as jss
    from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ss

    g = make_sphere_grid(64, device="cpu")
    vol = (g.occ > 0).to(torch.float32)
    sv = ss.shadow_volume(vol, (0.5, 0.9, 0.4), device="cpu")
    pos, view = _cam(0.3, 0.7, 2.0)
    axis_world, flip, (S, A, B), window, scal_np, crop = ss._frame_geometry(
        vol.shape, g.origin.numpy(), float(g.voxel_size), pos, view, 45.0,
        1.0, (-0.5, -0.9, -0.4), (1.0, 0.8, 0.6), (0.1, 0.1, 0.1))
    scal = torch.as_tensor(scal_np)
    ih = iw = 128
    full_v = ss._layout_volume(vol, axis_world, flip, S, crop)
    full_s = ss._layout_volume(sv, axis_world, flip, S, crop)
    fo, shf = ss._sweep_core(full_v, scal, S, A, B, ih, iw, flip,
                             shadow_sw=full_s)
    fo0, shf0 = ss._sweep_core(full_v, scal, S, A, B, ih, iw, flip,
                               shadow_sw=full_s, o_base=0)
    assert torch.equal(fo, fo0) and torch.equal(shf, shf0)
    want_packed = jss._sweep_all(
        jnp.asarray(full_v.float().numpy(), jnp.bfloat16), jnp.asarray(scal_np),
        full_v.shape[0] // 32, S, A, B, ih, iw, flip,
        shadow_sw=jnp.asarray(full_s.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(
        ss._pack_first_o(fo0, shf0, S, flip, True).numpy().reshape(-1),
        np.asarray(want_packed).reshape(-1))

    n = 2
    segs = []
    for r in range(n):
        lo, rows = (r * 32, 32)
        v = ss._layout_rows(vol, axis_world, flip, S, crop, lo, rows)
        s_ = ss._layout_rows(sv, axis_world, flip, S, crop, lo, rows)
        assert torch.equal(v, full_v[lo:lo + rows])
        segs.append(ss._sweep_core(v, scal, S, A, B, ih, iw, flip,
                                   shadow_sw=s_, o_base=lo))
        j_fo, j_sh = jss._sweep_core(
            jnp.asarray(v.float().numpy(), jnp.bfloat16),
            jnp.asarray(scal_np), 1, S, A, B, ih, iw, flip,
            shadow_sw=jnp.asarray(s_.float().numpy(), jnp.bfloat16),
            o_base=lo)
        np.testing.assert_array_equal(segs[-1][0].numpy(), np.asarray(j_fo))
        np.testing.assert_array_equal(segs[-1][1].numpy(), np.asarray(j_sh))
    fos = torch.stack([f for f, _ in segs])
    comb = fos.amin(0)
    assert torch.equal(comb, fo)
    won = (fos == comb) & (comb < S)
    sh = torch.where(won, torch.stack([s for _, s in segs]), 0.0).sum(0)
    assert torch.equal(sh, shf)
    assert (fos[1] < S).any() and (fos[0] < S).any()
