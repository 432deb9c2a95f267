"""Port parity, scene layer: config, materials, transforms, camera, transfer
function, ingest.  Inputs are made with numpy and passed to both packages."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.scene import camera as jcamera
from volumerenderingproject_tpu.scene import materials as jmaterials
from volumerenderingproject_tpu.scene import transfer_function as jtfm

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ingest import synthetic as psynthetic
from volumerenderingproject_tpu_torch.scene import camera as pcamera
from volumerenderingproject_tpu_torch.scene import materials as pmaterials
from volumerenderingproject_tpu_torch.scene import transfer_function as ptfm

CAM_FIELDS = ("position", "front", "right", "up", "top_left")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_tf(jtf):
    return interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors", "hg_g")),
        device="cpu")


def _assert_camera_ulp(pc, jc, maxulp=1):
    """Each vector within ``maxulp`` units in the last place of its largest
    component: a component that cancels to near 0 (cross products) is held
    to the vector's scale, not its own."""
    for k in CAM_FIELDS:
        got, want = _np(getattr(pc, k)), np.asarray(getattr(jc, k))
        ulp = np.spacing(np.abs(want).max())
        assert np.abs(got - want).max() <= maxulp * ulp, (k, got, want)


def test_config_json_round_trip_between_packages():
    cfg = J.RenderConfig(width=64, height=48, samples_per_ray=33, conic=True,
                         density_scale=0.5, early_termination=1e-3,
                         background=(0.1, 0.2, 0.3, 1.0))
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    assert pcfg.to_json() == cfg.to_json()
    assert J.RenderConfig.from_json(pcfg.to_json()) == cfg
    assert pcfg.sample_distance == cfg.sample_distance
    assert pcfg.real_screen_height == cfg.real_screen_height


def test_materials_equal():
    for mid in list(jmaterials.MaterialId) + [99, "bone", "nothing"]:
        jm = jmaterials.get_material(mid)
        pm = pmaterials.get_material(mid)
        assert (pm.name, pm.rgba, pm.hg_g) == (jm.name, jm.rgba, jm.hg_g)


@pytest.mark.parametrize("position", [(0.0, 0.0, 1.0), (0.35, 0.45, 0.85),
                                      (1.5, 0.4, 0.0), (-0.7, 1.2, -0.3)])
def test_camera_initial_within_one_ulp(position):
    jc = J.Camera.initial(position=position, screen_w=1.7, screen_h=1.3)
    pc = P.Camera.initial(position=position, screen_w=1.7, screen_h=1.3,
                          device="cpu")
    _assert_camera_ulp(pc, jc)


@pytest.mark.parametrize("yaw,pitch,zoom", [(0.3, 0.0, 0.0), (0.0, -0.2, 0.0),
                                            (0.25, 0.1, 0.05)])
def test_camera_orbit_within_one_ulp(yaw, pitch, zoom):
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    jo = jc.orbit(yaw, pitch, zoom)
    po = pc.orbit(yaw, pitch, zoom)
    _assert_camera_ulp(po, jo)


def test_camera_presets_and_save_load(tmp_path):
    _assert_camera_ulp(P.reset_preset(device="cpu"), J.reset_preset(), maxulp=0)
    _assert_camera_ulp(P.default_camera(device="cpu"), J.default_camera())
    path = os.path.join(tmp_path, "cam.json")
    jcamera.save_preset(J.reset_preset(), path)
    _assert_camera_ulp(pcamera.load_preset(path, device="cpu"),
                       jcamera.load_preset(path), maxulp=0)


def _tf_probe_values(jtf, rng):
    bounds = np.concatenate([np.asarray(jtf.lower), np.asarray(jtf.upper)])
    edges = np.concatenate([bounds, np.nextafter(bounds, 2.0, dtype=np.float32),
                            np.nextafter(bounds, -1.0, dtype=np.float32)])
    vals = rng.uniform(-0.2, 1.2, 4000).astype(np.float32)
    return np.concatenate([edges.astype(np.float32), vals, np.float32([0, 1])])


@pytest.mark.parametrize("which", ["default", "overlapping"])
def test_classify_exactly_equal(which):
    rng = np.random.default_rng(5)
    if which == "default":
        jtf = J.default_transfer_function()
    else:  # overlapping intervals and a gap: last match wins, fallback 0
        jtf = jtfm.from_text(
            "a 0.2 0.5 0.1 0.2 0.3 0.4\nb 0.4 0.7 0.5 0.6 0.7 0.8\n"
            "c 0.45 0.46 0.9 0.8 0.7 0.6\nd 0.8 0.9 1 0 1 0.5 0.3\n")
    ptf = _port_tf(jtf)
    v = _tf_probe_values(jtf, rng)
    vt = torch.from_numpy(v)
    np.testing.assert_array_equal(_np(ptf.classify_index(vt)),
                                  np.asarray(jtf.classify_index(v)))
    np.testing.assert_array_equal(_np(ptf.classify(vt)),
                                  np.asarray(jtf.classify(v)))


def test_transfer_function_text_round_trip():
    text = jtfm.to_text(J.default_transfer_function())
    ptf = ptfm.from_text(text, device="cpu")
    assert ptfm.to_text(ptf) == text
    ref = P.default_transfer_function(device="cpu")
    for k in ("lower", "upper", "colors", "hg_g"):
        np.testing.assert_array_equal(_np(getattr(ptf, k)), _np(getattr(ref, k)))
    sketch = ptfm.from_text("bone 30 80\nbrain 105 120\n", device="cpu")
    jsketch = jtfm.from_text("bone 30 80\nbrain 105 120\n")
    np.testing.assert_array_equal(_np(sketch.lower), np.asarray(jsketch.lower))


@pytest.mark.parametrize("fixture", ["centered_sphere", "corner_sphere"])
def test_synthetic_volumes_equal(fixture):
    jv = getattr(jsynthetic, fixture)(24)
    pv = getattr(psynthetic, fixture)(24, device="cpu")
    assert pv.dims == jv.dims and pv.octree_depth == jv.octree_depth
    np.testing.assert_array_equal(_np(pv.data), np.asarray(jv.data))
    assert float(pv.cal_max) == float(jv.cal_max)


@pytest.mark.parametrize("version,dtype", [(1, np.int16), (2, np.float32)])
def test_nifti_reader_equal(tmp_path, version, dtype):
    rng = np.random.default_rng(2)
    dims = (5, 6, 7)
    vox = rng.integers(-20, 300, dims).astype(dtype)
    code = {np.int16: 4, np.float32: 16}[dtype]
    if version == 1:
        hdr = bytearray(348)
        hdr[0:4] = np.int32(348).tobytes()
        hdr[40:56] = np.asarray([3, *dims, 1, 1, 1, 1], np.int16).tobytes()
        hdr[70:72] = np.int16(code).tobytes()
        hdr[72:74] = np.int16(8 * vox.itemsize).tobytes()
        hdr[76:108] = np.asarray([1, 1.5, 1.5, 2, 0, 0, 0, 0], np.float32).tobytes()
        hdr[108:112] = np.float32(352).tobytes()
        hdr[124:128] = np.float32(250.7).tobytes()
        hdr[344:348] = b"n+1\0"
        head = bytes(hdr) + b"\0" * 4
    else:
        hdr = bytearray(540)
        hdr[0:4] = np.int32(540).tobytes()
        hdr[4:12] = b"n+2\0\r\n\x1a\n"
        hdr[12:14] = np.int16(code).tobytes()
        hdr[14:16] = np.int16(8 * vox.itemsize).tobytes()
        hdr[16:80] = np.asarray([3, *dims, 1, 1, 1, 1], np.int64).tobytes()
        hdr[104:168] = np.asarray([1, 1, 1, 1, 0, 0, 0, 0], np.float64).tobytes()
        hdr[168:176] = np.int64(544).tobytes()
        hdr[192:200] = np.float64(0.0).tobytes()  # cal_max 0: use the data max
        head = bytes(hdr) + b"\0" * 4
    path = os.path.join(tmp_path, f"v{version}.nii")
    # the file's flat order is x-major: C-order [X, Y, Z]
    with open(path, "wb") as f:
        f.write(head + vox.tobytes())
    jv = J.load_nifti(path, backend="python")
    pv = P.load_nifti(path, device="cpu")
    assert pv.dims == jv.dims
    np.testing.assert_array_equal(_np(pv.data), np.asarray(jv.data))
    for k in ("cal_max", "cal_min", "pixdim"):
        np.testing.assert_array_equal(_np(getattr(pv, k)),
                                      np.asarray(getattr(jv, k)))


def test_interop_volume_round_trip():
    rng = np.random.default_rng(4)
    data = rng.uniform(-30, 255, (6, 7, 8)).astype(np.float32)
    jv = J.make_volume(data, cal_max=200.5)
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    assert pv.dims == jv.dims and pv.channels == 1
    assert pv.octree_depth == jv.octree_depth == 3
    np.testing.assert_array_equal(_np(pv.data), data)
    assert dataclasses.replace(pv).cal_max.item() == np.float32(200.5)
