"""Port vs JAX reference: the engine configuration (``config.py``).

The port keeps its own copy of ``ray_tracing_octrees_tpu/config.py``;
every dataclass must equal the JAX one field for field (names, order and
defaults), and the file and override surface must build equal configs.
Mirrors tests/test_config.py.
"""

import dataclasses
import json

import pytest
import torch

from ray_tracing_octrees_tpu import config as jc
from ray_tracing_octrees_tpu_torch import config as tc
from ray_tracing_octrees_tpu_torch.render import camera as tcam

torch.set_num_threads(2)

CLASSES = ["QEFConfig", "DCConfig", "RayTraceConfig", "RaymarchConfig",
           "CameraConfig", "IngestConfig", "EngineConfig"]


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_equal_jax(name):
    j, t = getattr(jc, name), getattr(tc, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert jf == tf
    assert _as_dict(j()) == _as_dict(t())
    assert t.__dataclass_params__.frozen


def test_defaults_capture_reference_constants():
    c = tc.DEFAULT_CONFIG
    assert c.sphere_dim == 256 and c.voxel_size == 10.0
    assert c.raytrace.max_traversal_steps == 512
    assert c.raytrace.use_sweep_exact and not c.raytrace.use_fast_exact
    assert c.raymarch.max_steps == 800
    assert c.dc.qef.regularization == pytest.approx(0.3)
    # the camera's config is this module's class
    assert tcam.CameraConfig is tc.CameraConfig
    assert isinstance(c.camera, tcam.CameraConfig)


CASES = [
    {"voxel_size": 5, "dc": {"qef": {"relaxation": 0.5}}},
    {"width": 640, "raytrace": {"frame_interval": 3,
                                "light_dir": [1, 0, 0]}},
    {"raytrace": {"use_sweep_exact": False, "exact_ball_skip": True}},
]


@pytest.mark.parametrize("data", CASES)
def test_config_from_dict_and_load_agree(tmp_path, data):
    assert _as_dict(tc.config_from_dict(data)) == _as_dict(
        jc.config_from_dict(data))
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(data))
    assert _as_dict(tc.load_config(str(p))) == _as_dict(
        jc.load_config(str(p)))


OVERRIDES = [
    ["dc.qef.relaxation=0.5", "raymarch.max_steps=400",
     "use_buildings=false", "raytrace.light_dir=1,0,0"],
    ["raytrace.use_fast_exact=on", "camera.fov_deg=60"],
]


@pytest.mark.parametrize("items", OVERRIDES)
def test_apply_overrides_agree(items):
    t = tc.apply_overrides(tc.DEFAULT_CONFIG, items)
    assert isinstance(t, tc.EngineConfig)
    assert _as_dict(t) == _as_dict(jc.apply_overrides(jc.DEFAULT_CONFIG,
                                                      items))


@pytest.mark.parametrize("bad, exc", [
    (lambda m: m.config_from_dict({"not_a_knob": 1}), KeyError),
    (lambda m: m.config_from_dict({"width": 1.5}), ValueError),
    (lambda m: m.apply_overrides(m.DEFAULT_CONFIG, ["dc.nope=1"]), KeyError),
    (lambda m: m.apply_overrides(m.DEFAULT_CONFIG, ["dc.qef.relaxation"]),
     ValueError),
])
def test_bad_input_raises_alike(bad, exc):
    for m in (jc, tc):
        with pytest.raises(exc):
            bad(m)


def test_config_args_parse():
    import argparse

    p = argparse.ArgumentParser()
    tc.add_config_args(p)
    args = p.parse_args(["--set", "voxel_size=2.5"])
    assert tc.config_from_args(args).voxel_size == 2.5
