"""The port's CUDA kernels on the card, against their plain versions:
``warp_frame`` (csrc/warp_frame.cu) in every instantiation and store
form, ``warp_lookup`` in both forms and ``warp_lookup_multi``
(csrc/warp_lookup.cu), and the warp experiments' four kernels
(csrc/exp_warp.cu), in every form, through every wrapper of
``ray_tracing_octrees_tpu_torch/tools``; and the exact tracers on the
card against the CPU (the DDA, the sweep-exact frame and its dead test
through ``warp_lookup``, ``OctreeRayTracer``'s four routes); and the
linear octree, the extraction pipelines (plain PyTorch), the linear
tree's branches, the MC mesh tracer and its frame (``warp_lookup`` on
its colours), the LBVH and the dense voxelizer on the card against the
CPU; and the rasterizer, the wireframe and the app's extraction frames
on the card against the CPU, the app's volume and ray-trace frames with
their kernels held, and the pipelined fast frames on two streams equal
to the per-pose loop; the entry step and two configs of the ladder.

Every test here is marked ``cuda`` and skips without a CUDA device (a
CUDA kernel has no CPU mode). The file imports nothing of JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.trace import slab_sweep, warp_kernel

pytestmark = pytest.mark.cuda

TO_LIGHT = (0.5, 0.9, 0.4)
W, H = 640, 360
POSES = {
    "exterior": dict(theta=0.9, phi=0.8, radius=0.75),
    "below": dict(theta=-0.9, phi=4.0, radius=2.0),
    "interior": dict(theta=0.05, phi=3.2, radius=0.05,
                     target=np.array([0.0, 0.0, -0.3], np.float32)),
}


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.set_num_threads(2)
    g = make_sphere_grid(64, device="cuda")
    vol = (g.occ > 0).to(torch.float32)
    sv = slab_sweep.shadow_volume(vol, TO_LIGHT, device="cuda")
    return g, vol, sv, slab_sweep.SweepLayouts(vol, sv)


def _camera(name):
    p = dict(POSES[name])
    target = p.pop("target", None)
    cam = Camera(**p)
    if target is not None:
        cam.set_target(target)
    return cam


def _table(scene, name):
    g, vol, sv, lay = scene
    cam = _camera(name)
    return slab_sweep._frame_table(
        vol, sv, g.origin.cpu().numpy(), float(g.voxel_size.cpu()),
        cam.get_pos(), cam.get_view(), 45.0, W / H,
        tuple(-c for c in TO_LIGHT), layouts=lay, device="cuda")


@pytest.mark.parametrize("name", list(POSES))
def test_warp_frame_kernel_matches_plain(scene, name):
    """Bitwise: the kernel and its plain version round every f32 op the
    same way (the kernel is built without FMA contraction)."""
    table, ks, aw, has_sh = _table(scene, name)
    before = warp_kernel.warp_frame.launches
    out = warp_kernel.warp_frame(table, ks, aw, W, H, has_sh)
    assert warp_kernel.warp_frame.launches == before + 1
    ref = warp_kernel.warp_frame_reference(table, ks, aw, W, H, has_sh)
    torch.cuda.synchronize()
    assert out.is_cuda and out.dtype == torch.int32 and out.shape == (H, W)
    assert torch.equal(out, ref)


@pytest.fixture(scope="module")
def exterior_table(scene):
    return _table(scene, "exterior")


@pytest.mark.parametrize("vox", ["power of two", "other"])
@pytest.mark.parametrize("size", [(W, H), (638, 359), (637, 361)])
@pytest.mark.parametrize("has_shadow", [False, True])
@pytest.mark.parametrize("axis_world", [0, 1, 2])
def test_warp_frame_instantiations_match_plain(exterior_table, axis_world,
                                               has_shadow, size, vox):
    """Every compile-time instantiation (sweep axis x shadow flag x vox's
    reciprocal exact or not) in both store forms (widths that are a
    multiple of 4, and not), bitwise, on a real table with the axis, the
    flag and vox forced: the plain version computes the same function for
    any of them."""
    table, ks, _, _ = exterior_table
    ks = ks.copy()
    if vox == "other":
        ks[10] *= np.float32(1.1)
    assert (warp_kernel.vox_reciprocal(ks[10]) != 0) == (vox != "other")
    w, h = size
    before = warp_kernel.warp_frame.launches
    out = warp_kernel.warp_frame(table, ks, axis_world, w, h, has_shadow)
    assert warp_kernel.warp_frame.launches == before + 1
    ref = warp_kernel.warp_frame_reference(table, ks, axis_world, w, h,
                                           has_shadow)
    torch.cuda.synchronize()
    assert out.shape == (h, w)
    assert torch.equal(out, ref)


def test_warp_frame_rejects_bf16_table(scene):
    table, ks, aw, has_sh = _table(scene, "exterior")
    with pytest.raises(TypeError):
        warp_kernel.warp_frame(table.to(torch.bfloat16), ks, aw, W, H, has_sh)


@pytest.mark.parametrize("name", list(POSES))
def test_frame_on_card_matches_cpu(scene, name):
    """The whole frame on the card against the same frame on the CPU: the
    sweep's bf16 products round once after f32 sums on both, so the
    tables agree; the 1.5/255 bar covers the rest."""
    g, vol, sv, lay = scene
    cam = _camera(name)
    args = (g.origin.cpu().numpy(), float(g.voxel_size.cpu()), cam.get_pos(),
            cam.get_view(), 45.0, W / H, W, H)
    kw = dict(light_dir=tuple(-c for c in TO_LIGHT))
    gpu = slab_sweep.render_fast_frame(vol, sv, *args, **kw, layouts=lay,
                                       device="cuda").cpu()
    vol_c, sv_c = vol.cpu(), sv.cpu()
    cpu = slab_sweep.render_fast_frame(vol_c, sv_c, *args, **kw, device="cpu")
    close = (gpu - cpu).abs().amax(-1) <= 1.5 / 255.0
    assert float(close.float().mean()) > 0.995


# --------------------------------------------------------------------------
# the lookup kernels (csrc/warp_lookup.cu)
# --------------------------------------------------------------------------

def _recorded(monkeypatch, module, name):
    """Wrap ``module.name`` so each call's arguments are kept."""
    calls = []
    real = getattr(module, name)

    def rec(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(module, name, rec)
    return calls


@pytest.mark.parametrize("name", list(POSES))
def test_warp_lookup_kernel_matches_plain(scene, monkeypatch, name):
    """sweep_first_hit's table and lin at 640x360: bitwise (a gather)."""
    g, vol, sv, lay = scene
    cam = _camera(name)
    calls = _recorded(monkeypatch, slab_sweep, "warp_lookup")
    before = warp_kernel.warp_lookup.launches
    hit, t, _, _ = slab_sweep.sweep_first_hit(
        vol, g.origin.cpu().numpy(), float(g.voxel_size.cpu()),
        cam.get_pos(), cam.get_view(), 45.0, W / H, W, H, layouts=lay,
        device="cuda")
    assert warp_kernel.warp_lookup.launches == before + 1
    (table, lin), = calls
    assert table.is_cuda and lin.shape == (H, W)
    out = warp_kernel.warp_lookup(table, lin)
    ref = warp_kernel.warp_lookup_reference(table, lin)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert hit.any() and bool(torch.isfinite(t).all())


@pytest.mark.parametrize("theta,phi", [(0.9, 0.8), (-0.9, 0.8 + np.pi)])
def test_warp_lookup_multi_kernel_matches_plain(scene, monkeypatch, theta,
                                                phi):
    """The exact frame's three planes at 640x360 (flip True and False)."""
    from ray_tracing_octrees_tpu_torch.trace import fast_exact

    g, vol, sv, lay = scene
    cam = Camera(theta=theta, phi=phi, radius=2.0)
    calls = _recorded(monkeypatch, fast_exact, "warp_lookup_multi")
    before = warp_kernel.warp_lookup_multi.launches
    img, stats = fast_exact.render_fast_exact_frame(
        vol, sv, g.origin.cpu().numpy(), float(g.voxel_size.cpu()),
        cam.get_pos(), cam.get_view(), 45.0, W / H, W, H,
        light_dir=tuple(-c for c in TO_LIGHT), with_stats=True, layouts=lay,
        device="cuda")
    assert warp_kernel.warp_lookup_multi.launches == before + 1
    assert stats["overflow"] == 0 and stats["unresolved"] == 0
    (planes, lin), = calls
    assert planes.shape[0] == 3 and lin.shape == (H, W)
    out = warp_kernel.warp_lookup_multi(planes, lin)
    ref = warp_kernel.warp_lookup_multi_reference(planes, lin)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert (img[..., :3].amax(-1) > 0).any()


@pytest.mark.parametrize("which", ["narrow", "all_miss", "no_miss"])
def test_lookup_kernels_edge_cases(scene, which):
    """A table narrower than 1024 columns, and lin fields with every pixel
    a miss or none: both kernels bitwise equal to their plain versions."""
    gen = torch.Generator().manual_seed(3)
    th, tw = (300, 700) if which == "narrow" else (256, 1024)
    tables = torch.rand((3, th, tw), generator=gen).cuda()
    iu = torch.randint(0, th, (H, W), generator=gen, dtype=torch.int32)
    iv = torch.randint(0, tw, (H, W), generator=gen, dtype=torch.int32)
    lin = (iu << 10) | iv
    if which == "narrow":
        lin[::7] = -1
    elif which == "all_miss":
        lin = torch.full((H, W), -1, dtype=torch.int32)
    lin = lin.cuda()
    one = warp_kernel.warp_lookup(tables[0], lin)
    multi = warp_kernel.warp_lookup_multi(tables, lin)
    torch.cuda.synchronize()
    assert torch.equal(one, warp_kernel.warp_lookup_reference(tables[0], lin))
    assert torch.equal(multi,
                       warp_kernel.warp_lookup_multi_reference(tables, lin))
    if which == "all_miss":
        assert bool((one == -1).all()) and bool((multi[1:] == 0).all())
    if which == "no_miss":
        assert bool((one >= 0).all())


def _lookup_field(which):
    """(table, lin, the launches by form warp_lookup should make) for the
    form tests: a lin view at a 4-byte storage offset, a pixel count that
    is not a multiple of 4, every pixel a miss, none."""
    gen = torch.Generator().manual_seed(5)
    th, tw = 512, 1024
    table = torch.rand((th, tw), generator=gen).cuda()
    n = H * W
    iu = torch.randint(0, th, (n + 1,), generator=gen, dtype=torch.int32)
    iv = torch.randint(0, tw, (n + 1,), generator=gen, dtype=torch.int32)
    lin = ((iu << 10) | iv).cuda()
    lin[::5] = -1
    if which == "offset":
        return table, lin[1:].view(H, W), {"general": 1}
    if which == "ragged":
        return table, lin[:n - 3].clone(), {"vector": 1, "general": 1}
    if which == "all_miss":
        return table, torch.full((H, W), -1, dtype=torch.int32,
                                 device="cuda"), {"vector": 1}
    return table, lin[:n].clamp(min=0).view(H, W), {"vector": 1}


@pytest.mark.parametrize("which", ["offset", "ragged", "all_miss", "no_miss"])
def test_warp_lookup_forms_match_plain(scene, which):
    """warp_lookup in the forms lookup_forms chooses, counted in
    LOOKUP_FORM_LAUNCHES, bitwise equal to its plain version."""
    table, lin, want = _lookup_field(which)
    assert [f for f, _ in warp_kernel.lookup_forms(lin)] == list(want)
    before = dict(warp_kernel.LOOKUP_FORM_LAUNCHES)
    n_before = warp_kernel.warp_lookup.launches
    out = warp_kernel.warp_lookup(table, lin)
    got = {k: v - before[k]
           for k, v in warp_kernel.LOOKUP_FORM_LAUNCHES.items()
           if v != before[k]}
    assert got == want
    assert warp_kernel.warp_lookup.launches == n_before + sum(want.values())
    ref = warp_kernel.warp_lookup_reference(table, lin)
    torch.cuda.synchronize()
    assert out.shape == lin.shape and torch.equal(out, ref)
    if which == "all_miss":
        assert bool((out == -1).all())
    if which == "no_miss":
        assert bool((out >= 0).all())


# --------------------------------------------------------------------------
# the warp experiments' kernels (csrc/exp_warp.cu)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exp_edge():
    """The seeded edge sets of tools/cases.py on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ray_tracing_octrees_tpu_torch.tools import cases

    return cases.edge_inputs("cuda")


def _hold_cases(case_list, rows):
    """Every case of ``rows``: one launch counted, bitwise equal to the
    plain version; returns how many ran."""
    from ray_tracing_octrees_tpu_torch.tools import cases

    n = 0
    for row, name, fn, plain, args in case_list:
        if row not in rows:
            continue
        before = fn.launches
        out = fn(*args)
        assert fn.launches == before + 1, name
        ref = plain(*args)
        torch.cuda.synchronize()
        assert out.is_cuda and out.dtype == torch.float32, name
        assert cases.bits_equal_share(out, ref) == 1.0, name
        n += 1
    return n


@pytest.mark.parametrize("row", [4, 5, 6, 7, 8, 9])
def test_exp_warp_kernels_match_plain_on_edge_fields(exp_edge, row):
    """Windows that clamp, indices past the table, all-invalid tiles,
    -0.0 texels, H % 128 != 0 and H % 128 == 0 for the two-pass warp,
    index fields at a storage offset, a tile count of 45 and a tile of no
    instantiation: every set of tools/cases.py's edge_inputs."""
    from ray_tracing_octrees_tpu_torch.tools import cases, exp_warp2pass

    assert sum(_hold_cases(cases.kernel_cases(**kw), {row})
               for kw in exp_edge.values()) > 0
    if row == 9:
        for e in exp_edge.values():
            if "t9" not in e:
                continue
            out = exp_warp2pass.warp_two_pass(e["t9"], e["iustar"], e["iv9"])
            ref = exp_warp2pass.warp_two_pass_reference(e["t9"], e["iustar"],
                                                        e["iv9"])
            torch.cuda.synchronize()
            assert cases.bits_equal_share(out, ref) == 1.0
            assert bool((ref != 0).any())


# the form each edge set's one-hot cases (kernel 1), warp_pallas /
# warp_pass1 cases (kernel 3) and warp_pass2 cases (kernel 4) launch: the
# tile's own instantiation unless the tile has none or the index fields
# are not 16-byte aligned
EDGE_FORMS = {"edge fields": "vector", "offset views": "general",
              "72x640": "vector", "invalid 32x128 tiles": "vector",
              "256x520 unpadded": "vector"}


@pytest.mark.parametrize("label", list(EDGE_FORMS))
def test_exp_warp_forms_on_edge_fields(exp_edge, label):
    """Each case launches the form the wrapper should choose, counted in
    trace/exp_warp.FORM_LAUNCHES, and equals its plain version."""
    from ray_tracing_octrees_tpu_torch.tools import cases
    from ray_tracing_octrees_tpu_torch.trace import exp_warp

    for row, name, fn, plain, args in cases.kernel_cases(**exp_edge[label]):
        if row not in (4, 6, 7, 8, 9):
            continue
        kernel = ("col_window" if name == "warp_pass2" else "row_window"
                  if row in (6, 9) else "onehot_window")
        want = EDGE_FORMS[label]
        if row == 7 and "(8,64)" in name:
            want = "general"
        before = dict(exp_warp.FORM_LAUNCHES)
        out = fn(*args)
        got = {k: v - before[k] for k, v in exp_warp.FORM_LAUNCHES.items()
               if v != before[k]}
        assert got == {f"{kernel} {want}": 1}, (name, got)
        torch.cuda.synchronize()
        assert cases.bits_equal_share(out, plain(*args)) == 1.0, name


def test_col_window_vector_form_refuses_unaligned_iv(exp_edge):
    """Kernel 4's C entry refuses its vector form on an index field that
    is not 16-byte aligned: the launch raises, nothing runs."""
    from ray_tracing_octrees_tpu_torch.tools import cases, exp_warp2pass
    from ray_tracing_octrees_tpu_torch.trace import exp_warp

    e = exp_edge["edge fields"]
    m = exp_warp2pass.warp_pass1_reference(e["t9"], e["iustar"])
    iv = cases._offset_view(e["iv9"])
    h, w = iv.shape
    with pytest.raises(RuntimeError, match="col_window_launch failed"):
        exp_warp._launch_form("col_window", "col_window_launch", "vector",
                              iv, (h, w), m, m.shape[1], iv, None, h, w,
                              exp_warp2pass.WIN2)


def test_exp_warp_general_form_rejects_large_tiles(exp_edge):
    """The general instantiation holds at most 4096 pixels a tile."""
    from ray_tracing_octrees_tpu_torch.tools import exp_warp_tune

    e = exp_edge["edge fields"]
    with pytest.raises(ValueError):
        exp_warp_tune.warp(e["t_hl"], e["lin"], 64, 128, 64)


DRIVERS = {"exp_onehot_warp": (4, dict(dim=64, width=256, height=128)),
           "exp_warp_ablate": (5, dict(width=256, height=128)),
           "exp_warp_kernel": (6, dict(dim=64, width=256, height=128)),
           "exp_warp_tune": (7, dict(width=256, height=128)),
           "exp_warp_tune2": (8, dict(width=256, height=128)),
           "exp_warp2pass": (9, dict(dim=64, width=256, height=136))}


@pytest.mark.parametrize("module", list(DRIVERS))
def test_exp_warp_driver_on_card(module):
    """Each driver's run("cuda") at a small size launches its kernels and
    times them; every kernel equals its plain version on its inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import importlib

    from ray_tracing_octrees_tpu_torch.tools import cases

    mod = importlib.import_module(
        f"ray_tracing_octrees_tpu_torch.tools.{module}")
    row, kw = DRIVERS[module]
    wrappers = cases.wrappers()
    before = {n: fn.launches for n, (_, fn) in wrappers.items()}
    res = mod.run("cuda", **kw)
    torch.cuda.synchronize()
    launched = {n for n, (r, fn) in wrappers.items()
                if r == row and fn.launches > before[n]}
    assert launched, module
    assert res["ms"] and all(v > 0 for v in res["ms"].values())
    inp = res["inputs"]
    if row in (4, 5, 7, 8):
        t_hl = inp["t_hl"][0] if row == 4 else inp["t_hl"]
        kc = cases.kernel_cases(t_hl=t_hl, lin=inp["lins"][0])
    elif row == 6:
        kc = cases.kernel_cases(table=inp["table"], iu=inp["iu"],
                                iv=inp["iv"])
    else:
        kc = cases.kernel_cases(t9=inp["table"], iustar=inp["iustar"],
                                iv9=inp["iv"])
    assert _hold_cases(kc, {4, 5, 6, 7, 8, 9}) > 0


def test_exp_warp_wrappers_raise_for_mixed_devices(exp_edge):
    from ray_tracing_octrees_tpu_torch.tools import exp_onehot_warp

    e = exp_edge["edge fields"]
    with pytest.raises(ValueError):
        exp_onehot_warp.onehot_warp(e["t_hl"].cpu(), e["lin"], 64)


# --------------------------------------------------------------------------
# the exact tracers on the card
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The 32^3 sphere on the card and on the CPU, with its leaf volume."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ray_tracing_octrees_tpu_torch.core import octree

    g = make_sphere_grid(32, device="cpu")
    lv = octree.build_leaf_volume(octree.build_pyramid(g.occ))
    return g, lv


def test_dda_trace_on_card_matches_cpu(small):
    """generate_rays and trace_octree_fast on the card: the rays, hit
    masks, t, steps, points and normals equal the CPU's bit for bit."""
    from ray_tracing_octrees_tpu_torch.render.camera import generate_rays
    from ray_tracing_octrees_tpu_torch.trace.octree_trace import (
        trace_octree_fast,
    )

    g, lv = small
    cam = Camera(theta=0.4, phi=0.8, radius=2.2)
    ray_args = (96, 64, cam.get_pos(), cam.get_view(), 45.0, 1.5)
    o, d = generate_rays(*ray_args, device="cpu")
    o_g, d_g = generate_rays(*ray_args, device="cuda")
    assert torch.equal(o_g.cpu(), o) and torch.equal(d_g.cpu(), d)
    args = (g.origin, g.voxel_size)
    cpu = trace_octree_fast(lv, o, d, *args, ball_skip=True)
    gpu = trace_octree_fast(lv.cuda(), o_g, d_g, *args, ball_skip=True)
    for k in ("hit", "t", "steps", "point", "normal"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


def test_sweep_exact_on_card_matches_cpu(small, monkeypatch):
    """The sweep-exact primary and frame on the card: equal hits and t,
    the dead test launched through warp_lookup and bitwise against its
    plain version, the frame within 1e-5 of the CPU's."""
    from ray_tracing_octrees_tpu_torch.trace import sweep_exact

    g, lv = small
    vol = (g.occ > 0).to(torch.float32)
    cam = Camera(theta=0.9, phi=0.8, radius=2.0)
    args = (g.origin.numpy(), float(g.voxel_size), cam.get_pos(),
            cam.get_view(), 128, 72, 45.0, 128 / 72)
    cpu = sweep_exact.trace_pixels_sweep_exact(vol, lv, *args, device="cpu")
    calls = _recorded(monkeypatch, sweep_exact, "warp_lookup")
    before = warp_kernel.warp_lookup.launches
    gpu = sweep_exact.trace_pixels_sweep_exact(vol.cuda(), lv, *args,
                                               device="cuda")
    assert warp_kernel.warp_lookup.launches > before and len(calls) == 1
    table, lin = calls[0]
    assert torch.equal(warp_kernel.warp_lookup(table, lin),
                       warp_kernel.warp_lookup_reference(table, lin))
    assert torch.equal(gpu["hit"].cpu(), cpu["hit"])
    assert torch.equal(gpu["t"].cpu(), cpu["t"])
    light = tuple(-c for c in TO_LIGHT)
    img_c, st_c = sweep_exact.render_exact_frame(vol, lv, *args,
                                                 light_dir=light,
                                                 device="cpu")
    img_g, st_g = sweep_exact.render_exact_frame(vol.cuda(), lv, *args,
                                                 light_dir=light,
                                                 device="cuda")
    assert st_g["unresolved"] == 0 and st_g["s_unresolved"] == 0
    assert (st_g["rounds"], st_g["s_rounds"]) == (st_c["rounds"],
                                                  st_c["s_rounds"])
    assert float((img_g.cpu() - img_c).abs().max()) <= 1e-5


def test_octree_raytracer_routes_on_card(small):
    """OctreeRayTracer on the card: each route launches its kernel and
    agrees with the same route on the CPU."""
    import dataclasses

    from ray_tracing_octrees_tpu_torch.config import EngineConfig
    from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
        OctreeRayTracer,
    )

    g, _ = small
    cfg = EngineConfig()
    rt_cfg = cfg.raytrace
    settings = {
        "sweep_exact": (cfg, {}, "warp_lookup"),
        "dda": (dataclasses.replace(cfg, raytrace=dataclasses.replace(
            rt_cfg, use_sweep_exact=False)), {}, None),
        "fast_exact": (dataclasses.replace(cfg, raytrace=dataclasses.replace(
            rt_cfg, use_fast_exact=True)), {}, "warp_lookup_multi"),
        "fast": (cfg, dict(fast=True), "warp_frame"),
    }
    cam = Camera(theta=0.9, phi=0.8, radius=2.0)
    for path, (c, kw, kernel) in settings.items():
        out = {}
        for dev in ("cpu", "cuda"):
            tracer = OctreeRayTracer(config=c, device=dev)
            tracer.set_octree(g)
            before = getattr(warp_kernel, kernel).launches if kernel else 0
            out[dev] = tracer.render(cam, 128, 72, 128 / 72, shadows=True,
                                     **kw).cpu()
            assert tracer.last_path == path, (dev, tracer.last_path)
            if kernel and dev == "cuda":
                assert getattr(warp_kernel, kernel).launches > before, path
        hits = [x[..., :3].amax(-1) > 0 for x in out.values()]
        assert float((hits[0] == hits[1]).float().mean()) > 0.999, path
        close = (out["cuda"] - out["cpu"]).abs().amax(-1) <= 1.5 / 255.0
        assert float(close.float().mean()) > 0.995, path


def test_unfused_fast_frame_on_card(scene):
    g, vol, sv, lay = scene
    cam = _camera("exterior")
    args = (g.origin.cpu().numpy(), float(g.voxel_size.cpu()), cam.get_pos(),
            cam.get_view(), 45.0, W / H, W, H)
    kw = dict(light_dir=tuple(-c for c in TO_LIGHT), layouts=lay,
              device="cuda")
    before = warp_kernel.warp_lookup.launches
    split = slab_sweep.render_fast_frame(vol, sv, *args, **kw, fused=False)
    assert warp_kernel.warp_lookup.launches > before
    fused = slab_sweep.render_fast_frame(vol, sv, *args, **kw)
    splitq = torch.round(split.clamp(0.0, 1.0) * 255.0) / 255.0
    close = (splitq - fused).abs().amax(-1) <= 1.5 / 255.0
    assert float(close.float().mean()) > 0.995


# -- the volume renderer: its frame's gather on warp_lookup_multi ---------

@pytest.fixture(scope="module")
def volume_pair():
    """The volume renderer on the 32^3 sphere on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ray_tracing_octrees_tpu_torch.models.volume_raycaster import (
        VolumeRaycastRenderer,
    )

    torch.set_num_threads(2)
    g = make_sphere_grid(32, device="cpu")
    return {dev: VolumeRaycastRenderer(device=dev).init(g)
            for dev in ("cpu", "cuda")}


@pytest.mark.parametrize("pose", [dict(theta=0.5, phi=0.8, radius=2.2),
                                  dict(theta=-0.4, phi=2.5, radius=1.6)])
def test_volume_frame_gather_held_on_card(volume_pair, pose):
    """draw_fast on the card launches warp_lookup_multi once, bitwise
    against its plain version on its own inputs; the image is within 1e-4
    of the CPU's on all but 0.5% of pixels."""
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep

    cam = Camera(**pose)
    kept = []
    real = raymarch_sweep.warp_lookup_multi

    def keep(tables, lin):
        out = real(tables, lin)
        kept.append((tables, lin, out.clone()))
        return out

    raymarch_sweep.warp_lookup_multi = keep
    try:
        before = warp_kernel.warp_lookup_multi.launches
        gpu = volume_pair["cuda"].draw_fast(cam, 160, 120, 160 / 120)
        assert warp_kernel.warp_lookup_multi.launches == before + 1
    finally:
        raymarch_sweep.warp_lookup_multi = real
    (tables, lin, out), = kept
    assert torch.equal(out, warp_kernel.warp_lookup_multi_reference(tables,
                                                                    lin))
    cpu = volume_pair["cpu"].draw_fast(cam, 160, 120, 160 / 120)
    diff = (gpu["color"].cpu() - cpu["color"]).abs().amax(-1)
    assert float((diff > 1e-4).float().mean()) <= 0.005


def test_volume_sweep_tables_card_vs_cpu(volume_pair):
    """_volume_sweep's packed table and four field channels: equal bits on
    the card and the CPU from the same inputs."""
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs

    scene = volume_pair["cpu"].sweep_scene()
    cam = Camera(theta=1.2, phi=4.0, radius=2.0)
    det, cats, scal, m = rs._volume_frame_inputs(
        scene, scene.box_min, cam.get_pos(), cam.get_view(), 45.0, 1.0)
    targs = (m["S"], m["A"], m["B"], m["inter_h"], m["inter_w"], m["flip"],
             m["nf"])
    pc, vc = rs._volume_sweep(det, cats, torch.as_tensor(scal), *targs)
    pg, vg = rs._volume_sweep(det.cuda(), [c.cuda() for c in cats],
                              torch.as_tensor(scal, device="cuda"), *targs)
    assert torch.equal(pg.cpu(), pc)
    for a, b in zip(vg, vc):
        assert torch.equal(a.cpu(), b)


def test_volume_oracle_card_vs_cpu(volume_pair):
    """The per-ray oracle on the card: the CPU's hit mask on >= 99% of
    pixels, the same iterations."""
    cam = Camera(theta=0.4, phi=0.8, radius=2.0)
    out = {dev: r.draw(cam, 48, 48, 1.0) for dev, r in volume_pair.items()}
    hits = [out[d]["alpha"].cpu() >= 0.1 for d in ("cpu", "cuda")]
    assert float((hits[0] == hits[1]).float().mean()) >= 0.99
    assert out["cuda"]["iters"] == out["cpu"]["iters"]


# -- the linear octree and extraction: plain PyTorch, card against CPU ----

@pytest.fixture(scope="module")
def extraction_pair():
    """The 32^3 sphere and its linear octree on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree

    torch.set_num_threads(2)
    g = make_sphere_grid(32, device="cpu")
    return {dev: (g.to(dev), build_linear_octree(g.occ, device=dev))
            for dev in ("cpu", "cuda")}


# a margin and a pose that cull part of the 32^3 sphere's tree (the CPU
# tests' margin; the config's margins keep every node at this scale)
CULL_MARGIN = 0.05


def _cull_vp(aspect):
    cam = Camera(theta=0.9, phi=0.8, radius=0.6)
    return (cam.get_proj(aspect) @ cam.get_view()).astype(np.float32)


def test_linear_octree_card_vs_cpu(extraction_pair):
    """The build, the node-id volume and both lookups: equal on the card
    and the CPU."""
    import dataclasses

    from ray_tracing_octrees_tpu_torch.core.octree import (
        build_node_id_volume, find_node_vol,
    )

    (_, tc), (_, tg) = extraction_pair["cpu"], extraction_pair["cuda"]
    assert tg.device.type == "cuda"
    for f in dataclasses.fields(tc):
        assert torch.equal(getattr(tg, f.name).cpu(), getattr(tc, f.name))
    vc, vg = build_node_id_volume(tc), build_node_id_volume(tg)
    assert torch.equal(vg.cpu(), vc)
    q = torch.tensor(np.random.default_rng(453).integers(-4, 36, (3, 5000)))
    assert torch.equal(find_node_vol(tg, vg, *q.cuda()).cpu(),
                       find_node_vol(tc, vc, *q))
    assert torch.equal(tg.find_node(*q.cuda()).cpu(), tc.find_node(*q))


def test_mc_and_blocks_card_vs_cpu(extraction_pair):
    """MarchingCubesRenderer and VoxelBlockRenderer, unculled and culled:
    bitwise equal on the card and the CPU."""
    from ray_tracing_octrees_tpu_torch.config import EngineConfig
    from ray_tracing_octrees_tpu_torch.models.extraction import (
        MarchingCubesRenderer, VoxelBlockRenderer,
    )

    cfg = EngineConfig().replace(extraction_frustum_margin=CULL_MARGIN,
                                 max_triangles=20000)
    vp = _cull_vp(16 / 9)
    outs = {}
    for dev, (g, tree) in extraction_pair.items():
        mc = MarchingCubesRenderer(cfg, device=dev)
        vb = VoxelBlockRenderer(cfg, device=dev)
        outs[dev] = [mc.render(g), mc.render(g, vp), vb.render(g, tree),
                     vb.render(g, tree, vp)]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)


def test_dual_contouring_card_vs_cpu(extraction_pair):
    """Adaptive DC (through the node-id volume, device rows; unculled,
    culled by a node mask that drops part of the tree, and with
    non-default QEF and DC toggles) and uniform DC on the card: the CPU's
    counts, vertices and normals within the CPU tests' bars (2e-6, 2e-4);
    the node masks equal."""
    from ray_tracing_octrees_tpu_torch.config import DCConfig, QEFConfig
    from ray_tracing_octrees_tpu_torch.core.octree import build_node_id_volume
    from ray_tracing_octrees_tpu_torch.ops import dual_contouring as dc
    from ray_tracing_octrees_tpu_torch.render.frustum import visible_node_mask

    outs, masks = {}, {}
    for dev, (g, tree) in extraction_pair.items():
        masks[dev] = visible_node_mask(tree, g.origin, g.voxel_size,
                                       _cull_vp(16 / 9), CULL_MARGIN)
        adaptive = lambda **kw: dc.adaptive_dual_contouring(
            g, tree, node_id_vol=build_node_id_volume(tree),
            tree_meta=dc.tree_host_meta(tree), device_out=True, device=dev,
            **kw)
        outs[dev] = [adaptive(), adaptive(node_mask=masks[dev]),
                     adaptive(qef_cfg=QEFConfig(regularization=0.05,
                                                masspoint_mix=0.5),
                              dc_cfg=DCConfig(max_size_ratio=4,
                                              face_fan_divisions=1)),
                     dc.dual_contour_uniform(g, 8192, 40000, device=dev)]
    assert torch.equal(masks["cuda"].cpu(), masks["cpu"])
    assert 0 < int(masks["cpu"].sum()) < masks["cpu"].numel()
    for (gv, gn, gc), (cv, cn, cc) in zip(outs["cuda"], outs["cpu"]):
        assert int(gc) == int(cc) > 100
        c = int(cc)
        assert float((gv[:c].cpu() - cv[:c]).abs().max()) <= 2e-6
        assert float((gn[:c].cpu() - cn[:c]).abs().max()) <= 2e-4
    assert int(outs["cpu"][1][2]) < int(outs["cpu"][0][2])


def test_linear_tree_branches_on_card(extraction_pair):
    """OctreeRayTracer with a bound tree (update_frustum's compaction
    equal to the CPU's) and draw_fast after update_frustum_culling(tree=
    ...), its warp_lookup_multi launched and bitwise against its plain
    version."""
    import dataclasses

    from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
        OctreeRayTracer,
    )
    from ray_tracing_octrees_tpu_torch.config import EngineConfig
    from ray_tracing_octrees_tpu_torch.models import volume_raycaster
    from ray_tracing_octrees_tpu_torch.models.volume_raycaster import (
        VolumeRaycastRenderer,
    )
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep

    cam = Camera(theta=0.4, phi=1.1, radius=0.5)
    vp = (cam.get_proj(1.3) @ cam.get_view()).astype(np.float32)
    cull = EngineConfig()
    cull = cull.replace(raytrace=dataclasses.replace(
        cull.raytrace, frustum_margin=CULL_MARGIN))
    for cfg, view_proj in ((EngineConfig(), vp), (cull, _cull_vp(1.3))):
        tracers = {}
        for dev, (g, tree) in extraction_pair.items():
            rt = OctreeRayTracer(config=cfg, device=dev)
            rt.set_octree(g, tree=tree)
            rt.update_frustum(view_proj)
            tracers[dev] = rt
        assert tracers["cuda"].visible_count == tracers["cpu"].visible_count
        for f in dataclasses.fields(tracers["cpu"].visible_tree):
            assert torch.equal(getattr(tracers["cuda"].visible_tree,
                                       f.name).cpu(),
                               getattr(tracers["cpu"].visible_tree, f.name))
    # the last pair culls part of the tree
    assert tracers["cpu"].visible_count < extraction_pair["cpu"][1].num_nodes
    g, tree = extraction_pair["cuda"]
    r = VolumeRaycastRenderer(device="cuda").init(g)
    r.update_frustum_culling(cam, 1.3, tree=tree)
    cpu_g, cpu_tree = extraction_pair["cpu"]
    rc = VolumeRaycastRenderer(device="cpu").init(cpu_g)
    rc.update_frustum_culling(cam, 1.3, tree=cpu_tree)
    assert torch.equal(r.textures.working.cpu(), rc.textures.working)
    # the exact working volume at a margin that culls part of the tree
    wv = {dev: volume_raycaster._working_volume_octree(
        gd.occ, td, gd.origin, gd.voxel_size, _cull_vp(1.3), CULL_MARGIN)
        for dev, (gd, td) in extraction_pair.items()}
    assert torch.equal(wv["cuda"].cpu(), wv["cpu"])
    assert 0 < int((wv["cpu"] > 0).sum()) < int((cpu_g.occ > 0).sum())
    kept, real = [], raymarch_sweep.warp_lookup_multi

    def keep(tables, lin):
        out = real(tables, lin)
        kept.append((tables, lin, out.clone()))
        return out

    raymarch_sweep.warp_lookup_multi = keep
    try:
        before = warp_kernel.warp_lookup_multi.launches
        r.draw_fast(Camera(theta=0.5, phi=0.8, radius=2.2), 160, 120,
                    160 / 120)
        assert warp_kernel.warp_lookup_multi.launches == before + 1
    finally:
        raymarch_sweep.warp_lookup_multi = real
    (tables, lin, out), = kept
    assert torch.equal(out, warp_kernel.warp_lookup_multi_reference(tables,
                                                                    lin))


# -- the MC mesh frame, the LBVH oracle and ingest on the card ------------

@pytest.fixture(scope="module")
def mesh_pair():
    """The 32^3 sphere's MC scene and MC triangles on the card and the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        count_mc_triangles, marching_cubes_grid,
    )
    from ray_tracing_octrees_tpu_torch.trace import mesh_grid

    torch.set_num_threads(2)
    g = make_sphere_grid(32, device="cpu")
    verts, _, count = marching_cubes_grid(g, int(count_mc_triangles(g)),
                                          device="cpu")
    return {dev: (mesh_grid.prepare_mc_scene(g.occ, g.origin, g.voxel_size,
                                             to_light=TO_LIGHT, device=dev),
                  verts[: int(count)].to(dev))
            for dev in ("cpu", "cuda")}


@pytest.mark.parametrize("pose", [(0.5, 0.3), (1.4, 0.55), (2.3, 0.8)])
def test_mesh_texel_trace_card_vs_cpu(mesh_pair, pose):
    """trace_mc_mesh_texels at 128^2 (the second pose with the 2x2
    footprint): hit, case, triangle, t, normal and shadow bitwise."""
    from ray_tracing_octrees_tpu_torch.trace import mesh_grid

    cam = Camera(theta=pose[0], phi=pose[1], radius=1.4)
    res = {dev: mesh_grid.trace_mc_mesh_texels(
        scene, cam.get_pos(), cam.get_view(), 45.0, 1.0, 128, 128,
        max_rounds=24, device=dev) for dev, (scene, _) in mesh_pair.items()}
    assert res["cuda"]["rounds"] == res["cpu"]["rounds"]
    for f in ("hit", "case", "tri", "t", "normal", "shadow"):
        assert torch.equal(res["cuda"][f].cpu(), res["cpu"][f]), f


def test_lbvh_card_vs_cpu(mesh_pair):
    """build_lbvh's arrays and trace_lbvh's hit, triangle and t bitwise."""
    import dataclasses

    from ray_tracing_octrees_tpu_torch.trace import lbvh

    bvh = {dev: lbvh.build_lbvh(tris, device=dev)
           for dev, (_, tris) in mesh_pair.items()}
    for f in dataclasses.fields(lbvh.LBVH):
        assert torch.equal(getattr(bvh["cuda"], f.name).cpu(),
                           getattr(bvh["cpu"], f.name)), f.name
    rng = np.random.default_rng(29)
    o = torch.as_tensor((rng.random((4000, 3)) - 0.5).astype(np.float32) * 4)
    d = torch.as_tensor((rng.random((4000, 3)) - 0.5).astype(np.float32)) - o
    d = d / d.norm(dim=-1, keepdim=True)
    rc = lbvh.trace_lbvh(bvh["cpu"], o, d, 4096)
    rg = lbvh.trace_lbvh(bvh["cuda"], o.cuda(), d.cuda(), 4096)
    for f in ("hit", "tri", "t"):
        assert torch.equal(rg[f].cpu(), rc[f]), f


def test_mesh_frame_lookup_held_on_card(mesh_pair):
    """render_mc_mesh_frame launches warp_lookup on its packed colours,
    each call bitwise its plain version, and its image equals the CPU's."""
    from ray_tracing_octrees_tpu_torch.trace import mesh_grid

    cam = Camera(theta=0.7, phi=0.5, radius=1.3)
    kept, real = [], slab_sweep.warp_lookup

    def keep(table, lin):
        out = real(table, lin)
        kept.append((table, lin, out.clone()))
        return out

    imgs = {}
    slab_sweep.warp_lookup = keep
    try:
        for dev, (scene, _) in mesh_pair.items():
            before = warp_kernel.warp_lookup.launches
            imgs[dev] = mesh_grid.render_mc_mesh_frame(
                scene, cam.get_pos(), cam.get_view(), 45.0, 16 / 9, 320, 180,
                light_dir=tuple(-c for c in TO_LIGHT), inter_h=256,
                inter_w=256, device=dev)
            launched = warp_kernel.warp_lookup.launches - before
            assert launched == (1 if dev == "cuda" else 0)
    finally:
        slab_sweep.warp_lookup = real
    table, lin, out = kept[-1]
    assert table.is_cuda
    assert torch.equal(out, warp_kernel.warp_lookup_reference(table, lin))
    assert torch.equal(imgs["cuda"].cpu(), imgs["cpu"])


def test_dense_voxelizer_on_card_equals_native():
    """The city-shaped seeded mesh: the dense voxelizer on the card equals
    the native library's grid and the numpy one's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tracing_octrees_tpu_torch.ingest import voxelize
    from ray_tracing_octrees_tpu_torch.native import runtime

    rng = np.random.default_rng(31)
    tris = (rng.random((400, 1, 3)) * 200
            + (rng.random((400, 3, 3)) - 0.5) * 30)
    dense = voxelize.voxelize_triangles_dense(tris, 2.5, device="cuda")
    host = voxelize.voxelize_triangles(tris, 2.5, device="cpu")
    assert torch.equal(dense.occ.cpu(), host.occ)
    assert torch.equal(dense.origin.cpu(), host.origin)
    nat = runtime.voxelize_triangles(tris, 2.5, device="cpu")
    assert torch.equal(dense.occ.cpu(), nat.occ)


# -- the app shell, the rasterizer, the wireframe, the pipeline ------------

@pytest.fixture(scope="module")
def app_pair(tmp_path_factory):
    """Application on the card and on the CPU over the 32^3 sphere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ray_tracing_octrees_tpu_torch.config import EngineConfig
    from ray_tracing_octrees_tpu_torch.render.app import Application

    apps = {}
    for dev in ("cpu", "cuda"):
        a = Application(config=EngineConfig(use_buildings=False,
                                            sphere_dim=32), device=dev)
        a.setup(grid=make_sphere_grid(32, device=dev))
        a.tri_cache.directory = str(tmp_path_factory.mktemp(f"tc_{dev}"))
        apps[dev] = a
    return apps


def test_raster_and_wireframe_card_vs_cpu():
    """rasterize_triangles' image and z-buffer, octree_wireframe's
    segments and rasterize_lines over them: the same bits on the card as
    on the CPU (min and max scatters are order-free, every sum of
    products is rounded in one form on both)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        marching_cubes_grid,
    )
    from ray_tracing_octrees_tpu_torch.render import raster
    from ray_tracing_octrees_tpu_torch.render.wireframe import (
        octree_wireframe,
    )

    cam = Camera(theta=0.6, phi=0.4, radius=1.6)
    vp = (cam.get_proj(1.0) @ cam.get_view()).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        g = make_sphere_grid(32, device=dev)
        v, n, c = marching_cubes_grid(g, max_triangles=40000, device=dev)
        c = int(c)
        img, zb = raster.rasterize_triangles(
            v[:c], n[:c], torch.full((c, 3), 0.8, device=dev), vp, 128, 128,
            cam_pos=cam.get_pos(), chunk=4096)
        segs, nl = octree_wireframe(build_linear_octree(g.occ, device=dev),
                                    g.origin, g.voxel_size, vp, 50.0)
        lines = raster.rasterize_lines(img, zb, segs[:int(nl)], vp, 128, 128)
        outs[dev] = [t.cpu() for t in (img, zb, segs, lines)]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(a, b)
    assert bool((outs["cpu"][1] < 2.0).any())


def test_app_extraction_frames_card_vs_cpu(app_pair):
    from ray_tracing_octrees_tpu_torch.render.app import RenderMode

    for mode in (RenderMode.MARCHING_CUBES, RenderMode.BLOCKS,
                 RenderMode.DUAL_CONTOURING):
        outs = {}
        for dev, a in app_pair.items():
            a.mode = mode
            a._cached_mesh = None
            outs[dev] = a.frame(128, 96)
        np.testing.assert_array_equal(outs["cuda"]["color"],
                                      outs["cpu"]["color"])
        np.testing.assert_array_equal(outs["cuda"]["mesh"]["verts"],
                                      outs["cpu"]["mesh"]["verts"])


def test_app_ray_modes_hold_their_kernels_on_card(app_pair):
    """The app's volume frame launches warp_lookup_multi and its ray
    trace at the exact radius (sweep-exact) warp_lookup; every call equals
    the plain version on its own inputs."""
    from ray_tracing_octrees_tpu_torch.render.app import RenderMode
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep
    from ray_tracing_octrees_tpu_torch.trace import sweep_exact

    a = app_pair["cuda"]
    for mode, module, name in (
            (RenderMode.VOLUME_RAYCAST, raymarch_sweep, "warp_lookup_multi"),
            (RenderMode.OCTREE_RAYTRACE, sweep_exact, "warp_lookup")):
        kept = []
        real = getattr(module, name)

        def keep(*args, _real=real):
            out = _real(*args)
            kept.append((args, out.clone()))
            return out

        a.mode = mode
        a._cached_frames.clear()
        a.camera.theta, a.camera.phi, a.camera.radius = 0.9, 0.8, 2.0
        counter = getattr(warp_kernel, name)
        before = counter.launches
        setattr(module, name, keep)
        try:
            a.frame(160, 90)
        finally:
            setattr(module, name, real)
        assert counter.launches > before and kept
        ref = getattr(warp_kernel, f"{name}_reference")
        for args, out in kept:
            assert torch.equal(out, ref(*args))
    assert a.raytracer.last_path == "sweep_exact"


def test_pipelined_two_streams_equal_the_loop(scene):
    """The sweep and the finish on two streams: every frame equals
    render_fast_frame(fused=False) at its pose, and each launches
    warp_lookup."""
    from ray_tracing_octrees_tpu_torch.parallel import (
        render_fast_frames_pipelined,
    )

    g, vol, sv, lay = scene
    poses = []
    for i in range(6):
        cam = Camera(theta=0.4 + 0.1 * i, phi=0.7 + 0.9 * i, radius=2.0)
        poses.append((cam.get_pos(), cam.get_view()))
    kw = dict(light_dir=tuple(-c for c in TO_LIGHT), inter_h=512,
              inter_w=512, layouts=lay, device="cuda")
    origin, vox = g.origin.cpu().numpy(), float(g.voxel_size.cpu())
    before = warp_kernel.warp_lookup.launches
    frames = render_fast_frames_pipelined(vol, sv, origin, vox, poses, 45.0,
                                          W / H, W, H, **kw)
    assert warp_kernel.warp_lookup.launches == before + len(poses)
    for (p, v), f in zip(poses, frames):
        ref = slab_sweep.render_fast_frame(vol, sv, origin, vox, p, v, 45.0,
                                           W / H, W, H, fused=False, **kw)
        assert torch.equal(f, ref)


@pytest.fixture(scope="module")
def nccl_world_1(tmp_path_factory):
    """A world-1 NCCL group (a file:// store in a temporary directory) and
    a one-axis ("sp",) mesh on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tracing_octrees_tpu_torch.parallel import initialize_distributed

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels have no CPU "
                    "mode")
    store = tmp_path_factory.mktemp("nccl") / "store"
    assert initialize_distributed(f"file://{store}", 1, 0)
    assert dist.get_backend() == "nccl"
    yield init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
    dist.destroy_process_group()


@pytest.mark.parametrize("pose", ["exterior", "below", "interior"])
def test_sweep_frame_segmented_nccl_world_1(scene, nccl_world_1, pose):
    """The slab-segmented fast frame on a world-1 NCCL group equals
    render_fast_frame(fused=False) bitwise, through warp_lookup."""
    from ray_tracing_octrees_tpu_torch.parallel.sharding import (
        sweep_frame_segmented,
    )

    g, vol, sv, lay = scene
    cam = _camera(pose)
    origin, vox = g.origin.cpu().numpy(), float(g.voxel_size.cpu())
    args = (vol, sv, origin, vox, cam.get_pos(), cam.get_view(), 45.0,
            W / H, W, H)
    before = warp_kernel.warp_lookup.launches
    got = sweep_frame_segmented(nccl_world_1, *args,
                                light_dir=tuple(-c for c in TO_LIGHT),
                                layouts=lay)
    assert warp_kernel.warp_lookup.launches == before + 1
    ref = slab_sweep.render_fast_frame(*args,
                                       light_dir=tuple(-c for c in TO_LIGHT),
                                       layouts=lay, fused=False)
    assert torch.equal(got, ref)


def test_volume_frame_segmented_nccl_world_1(volume_pair, nccl_world_1):
    """The slab-segmented volume frame on a world-1 NCCL group equals
    render_volume_frame bitwise, through warp_lookup_multi."""
    from ray_tracing_octrees_tpu_torch.parallel.sharding import (
        volume_frame_segmented,
    )
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs

    scene = volume_pair["cuda"].sweep_scene()
    g = make_sphere_grid(32, device="cpu")
    cam = Camera(theta=0.5, phi=0.8, radius=2.2)
    args = (g.origin.numpy(), cam.get_pos(), cam.get_view(), 45.0, W / H, W,
            H)
    before = warp_kernel.warp_lookup_multi.launches
    got = volume_frame_segmented(nccl_world_1, scene, *args, time_value=0.25)
    assert warp_kernel.warp_lookup_multi.launches == before + 1
    ref = rs.render_volume_frame(scene, *args, time_value=0.25)
    for k in ("color", "depth", "normal", "alpha"):
        assert torch.equal(got[k], ref[k]), k


def test_entry_step_card_equals_cpu():
    """graft_entry.entry()'s step on the card against the same step on
    the CPU, bitwise: the rays, the DDA's normals and the shading are
    elementwise f32 ops with host-side view constants on both."""
    from ray_tracing_octrees_tpu_torch import graft_entry

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn, args = graft_entry.entry()
    assert args[1].is_cuda
    got = fn(*args)
    fn_c, args_c = graft_entry.entry(device="cpu")
    want = fn_c(*args_c)
    assert torch.equal(got.cpu(), want)
    assert bool((want[..., :3].amax(-1) > 0).any())


def test_ladder_configs_on_the_card():
    """Configs 1 and 5 of the ladder on the card: config 1 gives the CPU's
    (and JAX's) counts; config 5 at a small frame launches warp_frame once
    a frame, warm-ups included."""
    from ray_tracing_octrees_tpu_torch import benchmarks

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (row,) = benchmarks.config1()
    assert (row["triangles"], row["octree_nodes"]) == (30952, 23561)
    before = warp_kernel.warp_frame.launches
    rows = benchmarks.config5(n=64, size=(640, 360), reps=2, scene_path="")
    assert [r["config"] for r in rows] == ["calgary_4k_flythrough_exterior",
                                           "calgary_4k_flythrough_interior"]
    assert warp_kernel.warp_frame.launches - before == 3 * (4 + 2)
