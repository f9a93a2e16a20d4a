"""The port's CUDA kernels on the card, against their plain versions:
``warp_frame`` (csrc/warp_frame.cu) in every instantiation and store
form, ``warp_lookup`` in both forms and ``warp_lookup_multi``
(csrc/warp_lookup.cu), and the warp experiments' four kernels
(csrc/exp_warp.cu), in every form, through every wrapper of
``ray_tracing_octrees_tpu_torch/tools``; and the exact tracers on the
card against the CPU (the DDA, the sweep-exact frame and its dead test
through ``warp_lookup``, ``OctreeRayTracer``'s four routes).

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
    """trace_octree_fast on the card: equal hit masks, t and steps."""
    from ray_tracing_octrees_tpu_torch.render.camera import generate_rays
    from ray_tracing_octrees_tpu_torch.trace.octree_trace import (
        trace_octree_fast,
    )

    g, lv = small
    cam = Camera(theta=0.4, phi=0.8, radius=2.2)
    o, d = generate_rays(96, 64, cam.get_pos(), cam.get_view(), 45.0, 1.5,
                         device="cpu")
    args = (g.origin, g.voxel_size)
    cpu = trace_octree_fast(lv, o, d, *args, ball_skip=True)
    gpu = trace_octree_fast(lv.cuda(), o.cuda(), d.cuda(), *args,
                            ball_skip=True)
    for k in ("hit", "t", "steps"):
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
