"""``python -m gisnav_tpu_torch bench`` against the JAX package's ``bench.py``
(the repo root), on the CPU.

- **The fixture.** ``gisnav_tpu_torch.bench._render_fixture`` gives JAX's
  ring and ortho byte for byte at the CPU sizes (256x320 over maps of 512
  and 416 px) and at the small config's (480x640 over 1024): zero pixels
  differ. Its two OpenCV calls: ``utils.world.warp_perspective_u8`` equals
  ``cv2.warpPerspective`` on every byte, also where taps fall outside the
  source and in a row's scalar tail (a width that is no multiple of 16);
  ``utils.world.resize_cubic`` is ``cv2.resize``'s bicubic (Intel IPP's in
  this OpenCV) to 2e-6 on unit noise.
- **The command's line beside JAX's.** Both run as processes at the CPU
  sizes (4 frames, 2 measurements): the same keys, recursively; the same
  ``mode``, ``frames_per_measurement``, ``weights`` and
  ``validated_config.config``; the bucketed and exact-warp rows' valid
  fractions equal (1.0 in both) and their inliers a frame within 10 % of
  JAX's. The cached row's frames 1 and 2 of the ring (yaws 90 and 180
  against an unrotated map) have inlier counts that straddle
  ``min_matches`` = 15 with the RANSAC draw in either package (over 40
  keys or seeds, frame 1 is valid 5 times in JAX and 13 in the port,
  frame 2 22 and 27 times), so that row's valid fraction and inliers are
  held within what those two frames can move them (0.5 and 7.5), and
  frame by frame below.
- **The cached frame program frame by frame**, both packages over RANSAC
  keys / seeds 2-4: the matches agree within 2 a frame, and a frame JAX
  finds valid under every key the port finds valid under every seed, its
  median inliers within 5 of JAX's.
- **No card**: ``bench`` without ``--device cpu`` prints the error line
  (JAX's keys) and exits 1.
- **The programs hold no host read**: the whole command at 96x128 with
  every ``FrameGraph`` program run once unguarded (the card's warm-up) and
  then under ``pipeline.graph.HostReadGuard``, one case a program.
"""
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from gisnav_tpu_torch import bench as tbench
from gisnav_tpu_torch import cli
from gisnav_tpu_torch.pipeline import graph as tgraph
from gisnav_tpu_torch.utils.world import resize_cubic, warp_perspective_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import bench as jbench  # noqa: E402 - the repo-root JAX benchmark

INLIER_RTOL = 0.10  # bucketed and exact-warp inliers a frame, vs JAX
CACHED_VALID_ATOL = 0.5  # frames 1 and 2 of 4 flip with the RANSAC draw
CACHED_INLIER_ATOL = 7.5
MATCH_ATOL = 2  # LightGlue matches a cached frame, port vs JAX
ROBUST_INLIER_ATOL = 5  # median inliers of a frame valid under every key
SEEDS = (2, 3, 4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The in-process runs of this file on two of torch's CPU threads, as
    each bench process is pinned to two cores; the count is put back after
    the file, so other test files keep their own."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("seed,h,w,ortho_hw,focal", [
    (0, 256, 320, 512, 200.0),  # the CPU rows' cached fixture
    (3, 256, 320, 416, 200.0),  # the CPU warp rows' fixture
    (1, 480, 640, 1024, 400.0),  # small_config's
])
def test_fixture_is_jax_byte_for_byte(seed, h, w, ortho_hw, focal):
    ring, ortho = tbench._render_fixture(seed, h, w, ortho_hw, focal)
    j_ring, j_ortho = jbench._render_fixture(seed, h, w, ortho_hw, focal)
    assert ring.dtype == j_ring.dtype and ring.shape == j_ring.shape
    assert ortho.shape == j_ortho.shape
    assert int((ortho != j_ortho).sum()) == 0
    assert int((ring != j_ring).sum()) == 0


def _homography(rng):
    return np.array([
        [1 + rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3),
         rng.uniform(-80, 80)],
        [rng.uniform(-0.3, 0.3), 1 + rng.uniform(-0.3, 0.3),
         rng.uniform(-80, 80)],
        [rng.uniform(-1e-3, 1e-3), rng.uniform(-1e-3, 1e-3), 1.0]])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("out_hw", [(280, 350), (256, 320), (97, 129)])
def test_warp_perspective_u8_is_cv2(seed, out_hw):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (300, 400)).astype(np.uint8)
    hm = _homography(rng)
    want = cv2.warpPerspective(src, hm, out_hw[::-1])
    got = warp_perspective_u8(src, hm, out_hw)
    assert got.dtype == np.uint8
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("n,size", [(2, 512), (4, 1024), (16, 512),
                                    (64, 832), (256, 416), (512, 512)])
def test_resize_cubic_is_cv2_to_2e6(n, size):
    a = np.random.default_rng(n).standard_normal((n, n)).astype(np.float32)
    want = cv2.resize(a, (size, size), interpolation=cv2.INTER_CUBIC)
    got = resize_cubic(a, size)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 2e-6


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


# each bench process is held to two cores of its own (where there are
# four), so that it neither starves the other test workers nor waits on
# them: JAX's bench otherwise spreads XLA's threads over every core
_PIN = ("import os, runpy, sys; os.sched_setaffinity(0, {cpus}); "
        "sys.argv = {argv}; runpy.{run}({target!r}, run_name='__main__')")


def _pinned(cpus, run, target, argv):
    return [sys.executable, "-c", _PIN.format(cpus=set(cpus), argv=argv,
                                              run=run, target=target)]


@pytest.fixture(scope="module")
def lines():
    """JAX's ``bench.py`` and the port's ``bench --device cpu``, run side
    by side as processes: their last stdout lines as dicts."""
    cpus = sorted(os.sched_getaffinity(0))
    jax_cpus, port_cpus = (cpus[:2], cpus[2:4]) if len(cpus) >= 4 else \
        (cpus, cpus)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(argv, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for argv in (_pinned(jax_cpus, "run_path", "bench.py",
                                  ["bench.py"]),
                          _pinned(port_cpus, "run_module",
                                  "gisnav_tpu_torch",
                                  ["gisnav_tpu_torch", "bench", "--device",
                                   "cpu"]))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return {"jax": outs[0], "port": outs[1]}


def test_bench_line_has_jax_keys(lines):
    assert _keys(lines["port"]) == _keys(lines["jax"])
    for key in ("metric", "unit", "mode", "frames_per_measurement",
                "frame_content", "weights"):
        assert lines["port"][key] == lines["jax"][key], key
    assert lines["port"]["frames_per_measurement"] == 4
    assert lines["port"]["validated_config"]["config"] == \
        lines["jax"]["validated_config"]["config"]
    assert lines["port"]["small_config"] is None
    assert lines["port"]["platform"] == "cpu"


@pytest.mark.parametrize("row", ["bucketed_warp_mode", "warp_exact_mode"])
def test_warp_rows_valid_and_inliers_as_jax(lines, row):
    port, ref = lines["port"][row], lines["jax"][row]
    assert port["valid_fraction"] == ref["valid_fraction"] == 1.0
    assert abs(port["inliers_per_frame"] - ref["inliers_per_frame"]) <= \
        INLIER_RTOL * ref["inliers_per_frame"]
    assert port["fps"] > 0 and port["p50_latency_ms"] > 0


def test_cached_row_within_its_flipping_frames(lines):
    port, ref = lines["port"]["cached_mode"], lines["jax"]["cached_mode"]
    assert abs(port["valid_fraction"] - ref["valid_fraction"]) <= \
        CACHED_VALID_ATOL
    assert abs(port["inliers_per_frame"] - ref["inliers_per_frame"]) <= \
        CACHED_INLIER_ATOL
    assert port["map_refresh_ms"] > 0


def test_line_formulas(lines):
    port = lines["port"]
    b = port["bucketed_warp_mode"]
    assert port["value"] == b["fps"] == port["validated_config"]["fps"]
    assert port["vs_baseline"] == round(b["fps"] / 30.0, 3)
    assert port["p50_latency_ms"] == b["p50_latency_ms"]
    assert port["inliers_per_frame"] == b["inliers_per_frame"]
    # one refresh amortised over the measurement's frames
    per_frame = b["p50_latency_ms"] + b["bucket_refresh_ms"] / 4
    assert abs(1e3 / per_frame - b["fps"]) <= 0.02 * b["fps"]
    w = port["warp_exact_mode"]
    assert abs(1e3 / w["p50_latency_ms"] - w["fps"]) <= 0.02 * w["fps"]


def test_cached_frames_valid_where_jax_always_is():
    import jax
    import jax.numpy as jnp

    from gisnav_tpu.geometry.crs import pixel_to_wgs84_affine
    from gisnav_tpu.pipeline import PipelineConfig as JConfig
    from gisnav_tpu.pipeline import build_frame_to_geopose_cached as jframe
    from gisnav_tpu.pipeline import build_reference_extractor as jextract
    from gisnav_tpu.pipeline.runners import load_bundled as jload
    from gisnav_tpu_torch.pipeline import geopose as tgp
    from gisnav_tpu_torch.weights import load_bundled, params_from_jax

    size = tbench.SIZES["cpu"]
    h, w, side, kp = size["h"], size["w"], size["ortho_hw"], size["max_kp"]
    focal = 400.0 * w / 640.0
    ring, ortho = tbench._render_fixture(0, h, w, side, focal)
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    aff = pixel_to_wgs84_affine(side, side, *tbench.AFFINE_BOX).astype(
        np.float32)

    cfg = JConfig(image_shape=(h, w), ortho_shape=(side, side),
                  max_keypoints=kp, lightglue_depth=9)
    params = jax.device_put(jload(tbench.WEIGHTS)[0])
    frame = jax.jit(jframe(cfg))
    ref = jax.jit(jextract(cfg))(params, jnp.asarray(ortho))
    dem = jnp.zeros((side, side), jnp.float32)
    jax_valid = np.zeros((len(SEEDS), len(ring)), bool)
    jax_inliers = np.zeros((len(SEEDS), len(ring)), int)
    jax_matches = np.zeros(len(ring), int)
    for s, seed in enumerate(SEEDS):
        for i in range(len(ring)):
            pose = frame(params, jnp.asarray(ring[i]), ref, dem,
                         jnp.asarray(k), jnp.asarray(aff),
                         jax.random.fold_in(jax.random.PRNGKey(seed), i))
            jax_valid[s, i] = bool(pose.valid)
            jax_inliers[s, i] = int(pose.num_inliers)
            jax_matches[i] = int(pose.num_matches)

    tcfg = tgp.PipelineConfig(image_shape=(h, w), ortho_shape=(side, side),
                              max_keypoints=kp, lightglue_depth=9)
    models = tgp.build_models(params_from_jax(
        load_bundled(tbench.WEIGHTS)[0]), tcfg)
    tframe = tgp.build_frame_to_geopose_cached(tcfg)
    gen = torch.Generator()
    port_valid = np.zeros_like(jax_valid)
    port_inliers = np.zeros_like(jax_inliers)
    with torch.no_grad():
        tref = tgp.build_reference_extractor(tcfg)(models,
                                                   torch.as_tensor(ortho))
        for s, seed in enumerate(SEEDS):
            gen.manual_seed(seed)
            for i in range(len(ring)):
                pose = tframe(models, torch.as_tensor(ring[i]), tref,
                              torch.zeros(side, side), torch.as_tensor(k),
                              torch.as_tensor(aff), generator=gen)
                port_valid[s, i] = bool(pose.valid)
                port_inliers[s, i] = int(pose.num_inliers)
                assert abs(int(pose.num_matches) - jax_matches[i]) <= \
                    MATCH_ATOL, i
    always = jax_valid.all(axis=0)
    assert always.any()
    assert port_valid[:, always].all()
    assert np.all(np.abs(np.median(port_inliers[:, always], axis=0)
                         - np.median(jax_inliers[:, always], axis=0))
                  <= ROBUST_INLIER_ATOL)


def test_bench_without_cuda_prints_the_error_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["bench"]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert line["metric"] == "frame_to_geopose_fps_1080p_2048kp"
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "CUDA" in line["error"]


PROGRAMS = ("warp_exact", "cached", "cached_refresh", "bucketed",
            "bucketed_refresh")


@pytest.fixture(scope="module")
def guarded():
    """``bench.run("cpu")`` at 96x128 / 64 keypoints, 2 frames, 1
    measurement, each program's first call unguarded and every later one
    under ``HostReadGuard``: {program: the guard's errors}, and the line."""
    errors: dict = {}

    class Guarded(tgraph.FrameGraph):
        def __call__(self, *args):
            if not self.replays:
                self.replays = 1
                return self.fn(*args)
            name = next(n for n, s in tbench.LAST.items()
                        if s is self.stats)
            try:
                with tgraph.HostReadGuard():
                    out = self.fn(*args)
                errors.setdefault(name, [])
            except tgraph.CaptureError as e:
                errors.setdefault(name, []).append(str(e))
                out = self.fn(*args)
            return out

    class Timed(tbench._Timed):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.graph = Guarded(self.graph.fn, "cpu")
            self.graph.stats = self.stats

    sizes = dict(tbench.SIZES["cpu"], h=96, w=128, ortho_hw=256, max_kp=64,
                 frames=2, reps=1)
    mp = pytest.MonkeyPatch()
    mp.setitem(tbench.SIZES, "cpu", sizes)
    mp.setattr(tbench, "_Timed", Timed)
    try:
        line = tbench.run("cpu")
    finally:
        mp.undo()
    return errors, line


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_reads_nothing_on_the_host(guarded, program):
    errors, _ = guarded
    assert program in errors, "the program never ran under the guard"
    assert errors[program] == []


def test_guarded_run_gives_a_line(guarded):
    _, line = guarded
    assert line["frames_per_measurement"] == 2
    assert line["validated_config"]["config"] == \
        "96x128_64kp_lg9_learned_lg9_warp-bucketed"
    assert set(tbench.LAST) == set(PROGRAMS)
