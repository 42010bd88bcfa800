"""The port's library API against the JAX package's.

- Names: every public name a ``gisnav_tpu`` package ``__init__.py`` exports
  (read on the syntax tree: its imports, definitions and assignments,
  ``__version__`` included) imports from the same path in
  ``gisnav_tpu_torch``, one case per (package, name), with no exception
  list. A submodule stays a module, a class a class, a function a
  callable, and a number or a string is equal.
- Constants: every public name of ``gisnav_tpu/constants.py`` is in the
  port's with an equal value, ``FrameID``'s ``typing.get_args`` included.
- Import hygiene: in a fresh interpreter, a bare ``import gisnav_tpu_torch``
  imports no ``nodes``; importing each subpackage leaves ``sys.modules``
  free of cv2, PIL, requests, triton, JAX and ``gisnav_tpu``, starts no
  process (no ``nvcc``, no ``g++``) and adds no entry under
  ``kernels/_build`` or ``native/_build``.
- Host geometry (f64): ``heading_deg_from_quat``, ``roll_deg_from_quat``,
  ``angle_off_nadir``, ``poses_to_twist`` and ``rotation_about_center``
  to 1e-12; ``poses_to_twist`` raises ``ValueError`` on dt <= 0 as JAX
  does.
- ``keypoints_to_3d`` exact, with and without a DEM, points off the raster
  included; ``project_points`` to 1e-5 relative in f32.
- ``load_pretrained``: the same keys, arrays and dtypes as the JAX loader's
  for the three bundles, ``PRETRAINED_PATH`` by default, and
  ``FileNotFoundError`` naming the port's ``train`` on a missing path.
- ``stamp_us_now``: integer microseconds of the wall clock, as JAX's.
- Without a card, ``extract_features`` and ``match_features`` raise unless
  the caller passes ``device="cpu"``.
"""
import ast
import importlib
import inspect
import json
import os
import subprocess
import sys
import time
import typing

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "gisnav_tpu")
PORT_PKG = os.path.join(ROOT, "gisnav_tpu_torch")


def _jax_exports():
    """(package, name) for every public name of every ``gisnav_tpu``
    ``__init__.py``: imported, defined or assigned at its top level."""
    out = []
    for dirpath, _, files in sorted(os.walk(JAX_PKG)):
        if "__init__.py" not in files:
            continue
        pkg = ".".join(os.path.relpath(dirpath, ROOT).split(os.sep))
        with open(os.path.join(dirpath, "__init__.py")) as f:
            tree = ast.parse(f.read())
        names = []
        for node in tree.body:
            if isinstance(node, ast.ImportFrom):
                names += [a.asname or a.name for a in node.names]
            elif isinstance(node, ast.Import):
                names += [a.asname or a.name for a in node.names]
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.append(node.name)
            elif isinstance(node, ast.Assign):
                names += [t.id for t in node.targets
                          if isinstance(t, ast.Name)]
        out += [(pkg, n) for n in names
                if not n.startswith("_") or n == "__version__"]
    return out


EXPORTS = _jax_exports()


def test_export_list_is_whole():
    """The names the case list reads: every JAX subpackage, and every
    name the JAX ``__init__``s hold (131 with ``__version__``)."""
    pkgs = {p for p, _ in EXPORTS}
    assert {"gisnav_tpu", "gisnav_tpu.geometry", "gisnav_tpu.nodes",
            "gisnav_tpu.io", "gisnav_tpu.fusion", "gisnav_tpu.matching",
            "gisnav_tpu.pipeline", "gisnav_tpu.pnp", "gisnav_tpu.features",
            "gisnav_tpu.gis", "gisnav_tpu.utils", "gisnav_tpu.raster",
            "gisnav_tpu.parallel", "gisnav_tpu.train"} == pkgs
    assert len(EXPORTS) == len(set(EXPORTS)) == 131
    assert ("gisnav_tpu", "__version__") in EXPORTS


@pytest.mark.parametrize("pkg,name", EXPORTS,
                         ids=[f"{p}:{n}" for p, n in EXPORTS])
def test_jax_export_imports_from_same_path(pkg, name):
    port_pkg = pkg.replace("gisnav_tpu", "gisnav_tpu_torch", 1)
    got = getattr(importlib.import_module(port_pkg), name)
    want = getattr(importlib.import_module(pkg), name)
    if inspect.ismodule(want):
        assert inspect.ismodule(got)
        assert got.__name__ == want.__name__.replace(
            "gisnav_tpu", "gisnav_tpu_torch", 1)
    elif inspect.isclass(want):
        assert inspect.isclass(got)
    elif callable(want):
        assert callable(got) and not inspect.isclass(got)
    else:
        assert got == want


def test_quickstart_node_graph_import():
    from gisnav_tpu_torch.nodes import GisNavApp
    from gisnav_tpu_torch.nodes.app import GisNavApp as app

    assert GisNavApp is app


def test_lightglue_names():
    """``matching.LightGlue`` is the module-route class, as
    ``gisnav_tpu.matching.LightGlue`` is the flax module; the fused class
    stays in ``lightglue_fused``."""
    from gisnav_tpu_torch import matching
    from gisnav_tpu_torch.matching import lightglue, lightglue_fused

    assert matching.LightGlue is lightglue.LightGlue
    assert lightglue_fused.LightGlue is not lightglue.LightGlue
    assert matching.match_features is lightglue.match_features


def test_constants_equal():
    from gisnav_tpu import constants as j
    from gisnav_tpu_torch import constants as t

    names = [n for n in vars(j) if not n.startswith("_")
             and n not in ("Final", "Literal")]
    assert len(names) == 29
    for n in names:
        if n == "FrameID":
            assert typing.get_args(t.FrameID) == typing.get_args(j.FrameID)
            assert typing.get_origin(t.FrameID) is typing.Literal
        else:
            assert getattr(t, n) == getattr(j, n), n


def test_version_and_top_level():
    import gisnav_tpu
    import gisnav_tpu_torch

    assert gisnav_tpu_torch.__version__ == gisnav_tpu.__version__
    assert gisnav_tpu_torch.constants.ROS_NAMESPACE == "gisnav"
    assert callable(gisnav_tpu_torch.resolve_device)


# --- import hygiene ---------------------------------------------------------

SUBPACKAGES = sorted(
    d for d in os.listdir(PORT_PKG)
    if os.path.isfile(os.path.join(PORT_PKG, d, "__init__.py")))

_HYGIENE = r"""
import json, os, shutil, subprocess, sys, tempfile
root, sub = sys.argv[1], sys.argv[2]
started = []
real = subprocess.Popen.__init__

def spy(self, *a, **kw):
    started.append(repr(a[0] if a else kw.get("args")))
    return real(self, *a, **kw)

subprocess.Popen.__init__ = spy
os.system = lambda cmd: started.append(cmd) or 0
import gisnav_tpu_torch.native as native
# native libraries build into a private, empty directory: one this import
# builds lands there, while other test processes building into the
# checkout's directory at the same time do not count
native.NATIVE_BUILD_DIR = tempfile.mkdtemp()
builds = [native.NATIVE_BUILD_DIR,
          os.path.join(root, "gisnav_tpu_torch", "kernels", "_build")]

def listing():
    return {b: sorted(os.listdir(b)) if os.path.isdir(b) else None
            for b in builds}

before = listing()
import gisnav_tpu_torch
bare_nodes = "gisnav_tpu_torch.nodes" in sys.modules
__import__("gisnav_tpu_torch." + sub)
builds_same = listing() == before
shutil.rmtree(native.NATIVE_BUILD_DIR)
print(json.dumps({
    "bare_nodes": bare_nodes,
    "forbidden": sorted(m for m in sys.modules if m.split(".")[0] in (
        "cv2", "PIL", "requests", "triton", "jax", "jaxlib", "flax",
        "gisnav_tpu")),
    "started": started,
    "builds_same": builds_same}))
"""


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_import_builds_nothing_and_imports_no_forbidden(sub):
    assert len(SUBPACKAGES) >= 15
    proc = subprocess.run([sys.executable, "-c", _HYGIENE, ROOT, sub],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bare_nodes": False, "forbidden": [], "started": [],
                   "builds_same": True}, got


# --- host geometry ----------------------------------------------------------


def _quats(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # exact cases: identity, nadir-looking, a pure yaw, a negative w
    return list(q) + [np.array([0.0, 0.0, 0.0, 1.0]),
                      np.array([0.0, np.sqrt(0.5), 0.0, np.sqrt(0.5)]),
                      np.array([0.0, 0.0, np.sin(0.6), np.cos(0.6)]),
                      np.array([0.1, -0.2, 0.3, -0.9])]


@pytest.mark.parametrize("name", ["heading_deg_from_quat",
                                  "roll_deg_from_quat", "angle_off_nadir"])
def test_quaternion_helpers_vs_jax(name):
    from gisnav_tpu import geometry as j
    from gisnav_tpu_torch import geometry as t

    for q in _quats(64, seed=len(name)):
        got, want = getattr(t, name)(q), getattr(j, name)(q)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_poses_to_twist_vs_jax():
    from gisnav_tpu.geometry import poses_to_twist as j_twist
    from gisnav_tpu_torch.geometry import poses_to_twist

    rng = np.random.default_rng(3)
    qs = _quats(32, seed=4)
    for i in range(len(qs) - 1):
        args = (rng.normal(0, 50, 3), qs[i + 1], 1_700_000_000_250_000 + i,
                rng.normal(0, 50, 3), qs[i], 1_700_000_000_000_000)
        for got, want in zip(poses_to_twist(*args), j_twist(*args)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # no rotation: a zero angular velocity
    same = (np.ones(3), qs[0], 2_000_000, np.zeros(3), qs[0], 1_000_000)
    for got, want in zip(poses_to_twist(*same), j_twist(*same)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert not np.any(poses_to_twist(*same)[1])
    for stamp2 in (1_000_000, 999_999):
        bad = (np.ones(3), qs[1], stamp2, np.zeros(3), qs[0], 1_000_000)
        for fn in (poses_to_twist, j_twist):
            with pytest.raises(ValueError, match="non-positive time step"):
                fn(*bad)


@pytest.mark.parametrize("h,w,angle", [(480, 640, 0.0), (101, 64, 33.3),
                                       (97, 97, -141.0), (2048, 2048, 90.0),
                                       (17, 1, 725.5)])
def test_rotation_about_center_vs_jax(h, w, angle):
    from gisnav_tpu.raster.warp import rotation_about_center as j_rot
    from gisnav_tpu_torch.raster import rotation_about_center

    got, want = rotation_about_center(h, w, angle), j_rot(h, w, angle)
    assert got.shape == (2, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --- pnp --------------------------------------------------------------------


@pytest.mark.parametrize("with_dem", [True, False])
def test_keypoints_to_3d_vs_jax(with_dem):
    import jax.numpy as jnp

    from gisnav_tpu.pnp import keypoints_to_3d as j_lift
    from gisnav_tpu_torch.pnp import keypoints_to_3d

    rng = np.random.default_rng(5)
    dem = (rng.normal(400, 30, (37, 53))).astype(np.float32)
    pts = rng.uniform(-8, 62, (300, 2)).astype(np.float32)  # some off it
    pts[:4] = [[-0.5, 3.0], [52.999, 36.999], [53.0, 10.0], [0.0, 37.0]]
    want = np.asarray(j_lift(jnp.asarray(pts),
                             jnp.asarray(dem) if with_dem else None))
    got = keypoints_to_3d(torch.as_tensor(pts),
                          torch.as_tensor(dem) if with_dem else None)
    assert got.dtype == torch.float32 and got.shape == (300, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    off = (pts[:, 0] < 0) | (pts[:, 0] >= 53) | (pts[:, 1] < 0) | (
        pts[:, 1] >= 37)
    assert off.sum() > 30 and not got[torch.as_tensor(off), 2].any()


def test_project_points_vs_jax():
    import jax.numpy as jnp

    from gisnav_tpu.geometry.quaternion import quat_to_matrix
    from gisnav_tpu.pnp import project_points as j_project
    from gisnav_tpu_torch.pnp import project_points

    rng = np.random.default_rng(6)
    pts = np.concatenate([rng.uniform(0, 2048, (500, 2)),
                          rng.normal(0, 40, (500, 1))], 1).astype(np.float32)
    r = quat_to_matrix(_quats(1, seed=7)[0] * [0.05, 0.05, 1.0, 1.0]
                       ).astype(np.float32)
    t = np.array([-1000.0, -900.0, 1800.0], np.float32)
    k = np.array([[1493.3, 0.0, 960.0], [0.0, 1493.3, 544.0],
                  [0.0, 0.0, 1.0]], np.float32)
    want = np.asarray(j_project(*(jnp.asarray(a) for a in (pts, r, t, k))))
    got = project_points(*(torch.as_tensor(a) for a in (pts, r, t, k)))
    assert got.dtype == torch.float32 and got.shape == (500, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


# --- weights, stamps, devices ----------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.mark.parametrize("bundle", ["PRETRAINED_PATH", "LEARNED_LG9_PATH",
                                    "LOFTR_PATH"])
def test_load_pretrained_vs_jax(bundle):
    from gisnav_tpu import weights as jw
    from gisnav_tpu_torch import weights as tw

    path = getattr(tw, bundle)
    assert os.path.realpath(path) == os.path.realpath(getattr(jw, bundle))
    got, want = _flat(tw.load_pretrained(path)), _flat(
        jw.load_pretrained(getattr(jw, bundle)))
    assert got.keys() == want.keys() and len(got) > 20
    for key in want:
        assert isinstance(got[key], np.ndarray)
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    if bundle == "PRETRAINED_PATH":  # the default
        assert _flat(tw.load_pretrained()).keys() == got.keys()


def test_load_pretrained_missing_path(tmp_path):
    from gisnav_tpu import weights as jw
    from gisnav_tpu_torch import weights as tw

    path = str(tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError, match="no bundled weights") as e:
        tw.load_pretrained(path)
    assert "python -m gisnav_tpu_torch train" in str(e.value)
    assert path in str(e.value) and "matching/convert.py" in str(e.value)
    with pytest.raises(FileNotFoundError, match="no bundled weights"):
        jw.load_pretrained(path)


def test_stamp_us_now():
    from gisnav_tpu.nodes.messages import stamp_us_now as j_stamp
    from gisnav_tpu_torch.nodes.messages import stamp_us_now

    before = int(time.time() * 1e6)
    got = stamp_us_now()
    want = j_stamp()
    after = int(time.time() * 1e6)
    assert isinstance(got, int)
    assert before <= got <= want <= after


def test_entry_points_raise_without_cuda(monkeypatch):
    from gisnav_tpu_torch.features import SuperPointFeatures, extract_features
    from gisnav_tpu_torch.matching import match_features

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats = SuperPointFeatures(torch.zeros(512, 2), torch.zeros(512),
                               torch.zeros(512, 256),
                               torch.ones(512, dtype=torch.bool))
    lg = {"input_proj": {"weight": torch.zeros(256, 256)}}
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_features({}, np.zeros((64, 64), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        match_features(lg, feats, (64, 64), feats, (64, 64))
