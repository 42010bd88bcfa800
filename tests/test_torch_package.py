"""Rules of the PyTorch/CUDA port that hold for the whole package.

- No module of ``gisnav_tpu_torch``, and not ``chip_smoke.py`` nor a
  ``tools/*_torch.py`` script, imports JAX, flax, OpenCV, ``requests`` or
  anything of ``gisnav_tpu`` (checked on the syntax tree).
- The entry points run on CUDA unless the caller asks for the CPU: without
  a card they raise instead of running on the CPU.
- ``chip_smoke.py`` exits non-zero, with no result line, without a card.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import gisnav_tpu_torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gisnav_tpu", "cv2",
             "requests", "PIL"}


def _port_files():
    pkg = os.path.dirname(gisnav_tpu_torch.__file__)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "tools", n)
              for n in os.listdir(os.path.join(ROOT, "tools"))
              if n.endswith("_torch.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 15
    rel = {os.path.relpath(p, ROOT) for p in files}
    assert {os.path.join("gisnav_tpu_torch", *m.split("/")) for m in (
        "features/harris.py", "features/convert.py", "matching/convert.py",
        "matching/loftr.py", "weights.py", "pipeline/runners.py",
        "features/sift.py", "matching/mnn.py", "pipeline/classical.py",
        "nodes/twist_node.py", "nodes/bus.py", "constants.py",
        "geometry/tm.py", "geometry/bbox.py", "geometry/geoid.py",
        "fusion/ekf.py", "fusion/ukf.py", "fusion/filter.py", "io/nmea.py",
        "io/ubx.py", "io/uorb.py", "nodes/tf.py", "nodes/messages.py",
        "nodes/bbox_node.py", "gis/cache.py", "gis/png.py", "gis/wms.py",
        "nodes/gis_node.py", "nodes/pose_node.py", "nodes/fusion_node.py",
        "nodes/mock_gps.py", "nodes/app.py", "cli.py", "__main__.py",
        "utils/world_wms.py", "train/__init__.py", "train/data.py",
        "train/device_data.py", "train/steps.py", "train/checkpoint.py",
        "train/loop.py", "train/loftr_steps.py", "io/serial_bridge.py",
        "nodes/wfst_node.py", "gis/geotiff.py", "gis/server.py",
        "nodes/ros_adapter.py", "nodes/viz.py", "utils/profiling.py",
        "replay.py", "gis/jpeg.py", "native/__init__.py",
        "gis/imgcodecs.py", "gis/coders.py", "gis/tiff.py", "gis/gif.py",
        "gis/bmp.py", "gis/pxm.py", "gis/sunras.py", "gis/hdr.py",
        "utils/world.py", "utils/drawing.py")} | {
        os.path.join("tools", "make_demo_geotiff_torch.py")} <= rel
    bad = {(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_runner_without_device_raises_without_cuda(monkeypatch):
    from gisnav_tpu_torch.device import resolve_device
    from gisnav_tpu_torch.pipeline.runners import make_bucketed_warp_runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_bucketed_warp_runner()
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_count_nothing_on_cpu():
    from gisnav_tpu_torch.features.nms_kernel import nms_cellmax, nms_select
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.matching.attention import masked_attention
    from gisnav_tpu_torch.raster.shear_kernel import (
        shear_first_axis,
        shear_last_axis,
    )

    reset_launches()
    nms_select(torch.rand(32, 64), 4)
    nms_cellmax(torch.rand(32, 256), 4)
    masked_attention(torch.rand(256, 2, 32), torch.rand(128, 2, 32),
                     torch.rand(128, 2, 32), torch.rand(128) > 0.5)
    shear_last_axis(torch.rand(1, 128, 384), 0.3, 64.0)
    shear_first_axis(torch.rand(1, 384, 128), 0.3, 64.0)
    assert set(LAUNCHES) == {"stem_stage", "conv_stage", "nms_select",
                             "fused_block", "masked_attention",
                             "shear_last_axis", "shear_first_axis",
                             "nms_cellmax"}
    assert all(n == 0 for n in LAUNCHES.values())


def test_every_kernel_source_is_built_and_shipped():
    """Each ``.cu`` in ``kernels/`` is a build target, and the package data
    ships it."""
    from gisnav_tpu_torch.kernels import build

    pkg = os.path.dirname(build.__file__)
    sources = sorted(n[:-3] for n in os.listdir(pkg) if n.endswith(".cu"))
    assert sources == sorted(build.SOURCES)
    assert {"attention", "shear"} <= set(sources)
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert '"gisnav_tpu_torch.kernels" = ["*.cu"' in f.read()


def test_library_name_follows_source_and_shared_headers(tmp_path):
    """The build target's name changes when the source's or any shared
    header's bytes change (so an edited header rebuilds), and not
    otherwise. No compiler runs."""
    from gisnav_tpu_torch.kernels import build
    from gisnav_tpu_torch.utils import jitcache

    (tmp_path / "k.cu").write_text('#include "core.cuh"\nint f();\n')
    (tmp_path / "core.cuh").write_text("// v1\n")
    first = build._target("k", str(tmp_path))
    assert first == build._target("k", str(tmp_path))
    assert os.path.dirname(first) == jitcache.cache_dir()
    (tmp_path / "core.cuh").write_text("// v2\n")
    second = build._target("k", str(tmp_path))
    assert second != first
    (tmp_path / "k.cu").write_text('#include "core.cuh"\nint g();\n')
    third = build._target("k", str(tmp_path))
    assert third not in (first, second)
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert build._target("k", str(tmp_path)) != third
    # the package's own headers are shipped beside the sources
    pkg = os.path.dirname(build.__file__)
    assert any(n.endswith(".cuh") for n in os.listdir(pkg))
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert '"*.cuh"' in f.read()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        with open(src) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--quick"],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_geoid_grid_is_shipped_and_identical():
    """The port reads its own copy of the EGM96 grid: the same bytes as the
    JAX package's, listed in the package data."""
    from gisnav_tpu_torch.geometry import geoid

    with open(geoid.EMBEDDED_GRID_PATH, "rb") as f:
        ours = f.read()
    with open(os.path.join(ROOT, "gisnav_tpu", "data", "egm96_grid.npz"),
              "rb") as f:
        assert ours == f.read()
    assert os.path.relpath(geoid.EMBEDDED_GRID_PATH, ROOT) == os.path.join(
        "gisnav_tpu_torch", "data", "egm96_grid.npz")
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert '"gisnav_tpu_torch" = ["data/*.npz"]' in f.read()


def test_every_native_source_is_built_and_shipped(tmp_path, monkeypatch):
    """Each ``.cpp`` in ``native/`` builds with the host compiler into a
    library of its own name, and the package data ships the sources."""
    from gisnav_tpu_torch import native

    sources = sorted(n[:-4] for n in os.listdir(native.NATIVE_DIR)
                     if n.endswith(".cpp"))
    assert sources == ["fax3", "imgcodecs", "jpeg", "jpeg2000", "shmbus",
                       "webp"]
    assert set(sources) <= set(native._WHAT)
    monkeypatch.setattr(native, "NATIVE_BUILD_DIR", str(tmp_path))
    lib = native.build_native_lib("imgcodecs")
    assert os.path.basename(lib).startswith("libimgcodecs_")
    assert os.path.dirname(lib) == str(tmp_path)
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert '"gisnav_tpu_torch.native" = ["*.cpp"]' in f.read()
