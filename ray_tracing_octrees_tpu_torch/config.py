"""Typed configuration for the whole engine.

Counterpart of ``ray_tracing_octrees_tpu/config.py``, kept as its own
copy (field for field, with the same defaults, file format and override
syntax) so the port never imports the JAX package. The reference's
knobs, scattered across compile-time constants, member flags and magic
numbers, sit in one frozen dataclass so that scenes, pipelines and
benchmarks are reproducible from one object; the provenance of each
default (file:line into the reference C++) is listed in the JAX copy's
docstring.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class QEFConfig:
    """Quadric-error-function solve knobs (AdaptiveDualContouringRenderer.cpp:84-161)."""

    regularization: float = 0.3
    relaxation: float = 0.7
    masspoint_mix: float = 0.2          # mix(solution, masspoint, 0.2)
    constrained_masspoint_mix: float = 0.1  # final mix in generateDualVertex
    min_points_for_solve: int = 3        # numPoints <= 2 -> masspoint
    snap_normal_threshold: float = 0.85  # architectural axis snapping
    plane_alignment_threshold: float = 0.7
    bounds_inset_factor: float = 0.001   # inset = cellSize * 0.001


@dataclasses.dataclass(frozen=True)
class DCConfig:
    """Adaptive dual contouring knobs."""

    qef: QEFConfig = QEFConfig()
    max_size_ratio: int = 2              # neighbor-leaf LOD constraint
    degenerate_area_eps: float = 1e-6
    stride_large_cell: int = 2           # hermite scan stride when size > 8
    stride_switch_size: int = 8
    always_fine_size: int = 4            # size <= 4 -> stride 1
    face_fan_divisions: int = 2          # boundary face-fan subdivision


@dataclasses.dataclass(frozen=True)
class RayTraceConfig:
    """Octree ray-trace pipeline (RayTracerBVH.cpp)."""

    max_traversal_steps: int = 512
    frustum_margin: float = 150.0
    frame_interval: int = 6              # re-render every Nth frame
    light_dir: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    base_color: Tuple[float, float, float] = (1.0, 0.8, 0.6)
    ambient: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    # exact-tracer accelerations (outputs unchanged up to the documented
    # nudge-epsilon grazing class; see trace/octree_trace.py)
    # wavefront compaction ladder; no effect in the port, whose DDA
    # compacts to the live rays (kept so configs match field for field)
    exact_ladder: bool = True
    exact_seed: bool = True              # conservative sweep seeds
    # sweep-exact tracer (trace/sweep_exact.py): reference-semantics
    # first-hit at MXU rates; used automatically when the pose is inside
    # its exactness envelope, with the DDA ladder as the fallback
    use_sweep_exact: bool = True
    # fast-exact cube tracer (trace/fast_exact.py): the same exact
    # primary hit/t ~3x faster (137 vs 46 Mrays/s at 1080p on chip), but
    # with the FAST frame's shading conventions: shadow term from the
    # directional shadow volume (the reference's own shadow is an 8-step
    # march approximation, raycastFS.glsl:223-272) and normals at voxel
    # granularity (normalize(p - center), RayTracerBVH.cpp:283-287, per
    # voxel rather than per leaf node). Off by default so the app's
    # OCTREE_RAYTRACE keeps sweep-exact's per-hit shadow rays and
    # leaf-node normals; turn on for interactive-rate exact visibility.
    use_fast_exact: bool = False
    exact_ball_skip: bool = False        # Chebyshev empty-ball skipping
    # light-occludability shadow prune: pays only for elevated lights /
    # sparse scenes (Calgary + the default shallow light legitimately
    # flags ~99% of voxels "maybe occluded" — zero rays pruned)
    exact_shadow_prune: bool = False


@dataclasses.dataclass(frozen=True)
class RaymarchConfig:
    """Volume raymarch pipeline (VolumeRaycastRenderer + raycastFS.glsl)."""

    max_steps: int = 800
    distance_step_scale: float = 350.0   # maxSteps - ceil(dist*350)
    alpha_cutoff: float = 0.95
    base_step_divisor_near: float = 2048.0
    base_step_divisor_far: float = 1024.0
    shadow_steps: int = 8
    edge_refine_iters: int = 6
    indirect_light_radius: int = 6
    frame_interval: int = 7
    skip_mip_levels: int = 4             # mip-pyramid empty-space skipping
    skip_tex_downsample: int = 8         # low-res skip texture factor
    carve_radius_clamp: float = 6.0
    carve_batch: int = 4
    carve_default_radius: float = 0.5
    frustum_fov_narrow_deg: float = 42.0
    frustum_margin_scale: float = 0.8
    pick_max_steps: int = 8000
    taa_jitter: bool = True
    use_sweep: bool = True               # sweep-space fast path in the app
    octree_skip_probe: int = 7           # 7x7 central ray grid
    octree_skip_percentile: float = 0.15
    octree_skip_safety: float = 0.75
    octree_skip_blend: float = 0.4


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Orbital camera (Camera.cpp)."""

    fov_deg: float = 45.0
    near: float = 0.1
    far: float = 5000.0
    min_radius: float = 0.1
    orbit_rate: float = 0.01             # dt / 100
    pan_rate: float = 0.001              # radius * 0.001


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """CSV voxelization (BuildingLoader.cpp)."""

    max_grid_axis: int = 1000            # auto-coarsen voxelSize above this
    padding_voxels: int = 1              # AABB pad in voxels


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine configuration."""

    # Scene (main.cpp:1022-1025)
    use_buildings: bool = True           # "useGDB": CSV/cache scene vs sphere
    sphere_dim: int = 256
    voxel_size: float = 10.0
    cache_filename: str = "sceneCache.bin"

    # Window / framebuffer (main.cpp:990)
    width: int = 1300
    height: int = 1300

    # Frustum culling margin for mesh extraction (main.cpp:101)
    extraction_frustum_margin: float = 50.0

    # Extracted-mesh raster base color (the app uploads per-vertex colors;
    # a single neutral base is used headless, shaded by test.frag Phong)
    mesh_base_color: Tuple[float, float, float] = (0.8, 0.8, 0.85)

    camera: CameraConfig = CameraConfig()
    ingest: IngestConfig = IngestConfig()
    dc: DCConfig = DCConfig()
    raytrace: RayTraceConfig = RayTraceConfig()
    raymarch: RaymarchConfig = RaymarchConfig()

    # Capacity bounds for static-shape outputs (XLA has no push_back; every
    # dynamic emission is prefix-sum compaction into a bounded buffer).
    max_triangles: int = 4_000_000
    max_octree_nodes: int = 2_000_000
    max_hermite_points: int = 10_000_000  # AdaptiveDualContouringRenderer.cpp:321

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig()


# --------------------------------------------------------------------------
# File + CLI override surface (SURVEY §5: "CLI + file overridable").
#
# A config file is JSON (or TOML on 3.11+) whose structure mirrors the
# dataclass nesting:  {"voxel_size": 5, "dc": {"qef": {"relaxation": 0.5}}}.
# CLI overrides are dotted assignments:  dc.qef.relaxation=0.5
# --------------------------------------------------------------------------


def _field_default(f):
    """Resolve a dataclass field's default, honoring default_factory."""
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    raise TypeError(f"config field {f.name!r} has no default")


def _convert_scalar(name, default, val):
    """Convert a JSON/TOML value to the field's type, rejecting lossy casts."""
    if isinstance(default, bool):
        if isinstance(val, bool):
            return val
        raise TypeError(f"config field {name!r} expects a bool, got {val!r}")
    if isinstance(default, int):
        out = int(val)
        if out != val:  # e.g. 1.9 for an int field: error, don't truncate
            raise ValueError(
                f"config field {name!r} expects an integer, got {val!r}")
        return out
    return type(default)(val)


def _from_dict(cls, data: dict):
    """Recursively build a (frozen) config dataclass from a nested dict."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for key, val in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        default = _field_default(fields[key])
        if dataclasses.is_dataclass(default) and isinstance(val, dict):
            kw[key] = _from_dict(type(default), val)
        elif isinstance(default, tuple) and isinstance(val, (list, tuple)):
            kw[key] = tuple(
                _convert_scalar(key, default[0], v) for v in val)
        else:
            kw[key] = _convert_scalar(key, default, val)
    return cls(**kw)


def config_from_dict(data: dict) -> EngineConfig:
    return _from_dict(EngineConfig, data)


def load_config(path: str) -> EngineConfig:
    """Load an EngineConfig from a JSON or TOML file."""
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return config_from_dict(tomllib.load(f))
    with open(path) as f:
        return config_from_dict(json.load(f))


def _coerce(old: Any, raw: str) -> Any:
    if isinstance(old, bool):
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"bad bool literal {raw!r}")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, tuple):
        parts = [p for p in raw.replace("(", "").replace(")", "").split(",") if p]
        return tuple(type(old[0])(p) for p in parts)
    return raw


def apply_overrides(cfg: EngineConfig, assignments: Iterable[str]) -> EngineConfig:
    """Apply dotted-path CLI overrides, e.g. ["dc.qef.relaxation=0.5"]."""
    for item in assignments:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form path=value")
        path, raw = item.split("=", 1)
        keys = path.strip().split(".")

        def rebuild(node, keys):
            key = keys[0]
            if not hasattr(node, key):
                raise KeyError(
                    f"unknown config key {key!r} on {type(node).__name__}")
            old = getattr(node, key)
            if len(keys) == 1:
                new = _coerce(old, raw.strip())
            else:
                new = rebuild(old, keys[1:])
            return dataclasses.replace(node, **{key: new})

        cfg = rebuild(cfg, keys)
    return cfg


def add_config_args(parser) -> None:
    """Attach the standard --config / --set flags to an argparse parser."""
    parser.add_argument("--config", default=None,
                        help="JSON/TOML EngineConfig file")
    parser.add_argument("--set", dest="overrides", action="append", default=[],
                        metavar="PATH=VALUE",
                        help="dotted config override, e.g. raymarch.max_steps=400")


def config_from_args(args) -> EngineConfig:
    cfg = load_config(args.config) if getattr(args, "config", None) \
        else DEFAULT_CONFIG
    return apply_overrides(cfg, getattr(args, "overrides", []) or [])
