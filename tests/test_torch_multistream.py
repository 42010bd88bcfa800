"""The port's multi-stream pipeline against the JAX package's.

Four streams of the default bundle, ``harris_lg5``, in cached mode at its
own width (480x640, 512 keypoints, the query pooled by 2 as the cached
runner pools it at 500 m) on the port's rendered world: ``chip_smoke.py``
path 4's scene (an 800x800 map at 3x the footprint), four yaws, each
stream with the map's features, the DEM, the intrinsics and the affine of
its own (equal here, as in ``tests/test_multistream.py``).

- On the CPU the pipeline runs the cached frame program stream by stream:
  stream i equals the single-stream frame on the same input and draw, bit
  for bit, with generators (noise drawn per stream) and with sample
  indices, with and without forked streams.
- Against JAX's ``build_multistream_pipeline`` (jitted, vmapped) with keys
  ``split(PRNGKey(1), 4)``, each port stream drawing JAX's samples for its
  key on its own match mask: every stream valid where JAX's is, match
  counts within 10 % + 1, each fix within 10 m of its truth, and within
  the warp modes' 2.5 m horizontally and 0.5 m in altitude of the JAX fix
  (measured 0.000-0.479 m and 0.000-0.038 m; the cached harris_lg5 frame
  agrees to 0.055-0.454 m at the median over keys,
  ``tests/test_torch_runners.py``).
- ``utils.world.render_streams``, path 12's layout, at a small size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.pipeline import geopose as jgp
from gisnav_tpu.pipeline import runners as jruns
from gisnav_tpu.pipeline.multistream import (
    build_multistream_pipeline as j_multistream,
)
from gisnav_tpu_torch.geometry.crs import haversine_m
from gisnav_tpu_torch.pipeline import geopose as tgp
from gisnav_tpu_torch.pipeline.multistream import build_multistream_pipeline
from gisnav_tpu_torch.utils.world import render_scene
from gisnav_tpu_torch.weights import load_bundled, params_from_jax

from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)

N = 4
YAWS = [0.0, 90.0, 180.0, 270.0]


@pytest.fixture(scope="module")
def streams():
    s = render_scene(seed=6, h=480, w=640, yaws=YAWS, map_side=800,
                     coverage=3.0, offset_m=22.2)
    params, cfg = load_bundled("harris_lg5")
    cfg = dataclasses.replace(cfg, ortho_shape=s.ortho.shape,
                              detector_downsample=2)
    models = tgp.build_models(params_from_jax(params), cfg)
    ref = tgp.build_reference_extractor(cfg)(
        models, torch.as_tensor(s.ortho.astype(np.float32)) / 255.0)
    k32, aff32 = (np.asarray(a, np.float32) for a in (s.k, s.crs_affine))
    batch = (
        torch.as_tensor(np.stack(s.frames).astype(np.float32)) / 255.0,
        type(ref)(*(torch.stack([f] * N) for f in ref)),
        torch.stack([torch.as_tensor(s.dem)] * N),
        torch.stack([torch.as_tensor(k32)] * N),
        torch.stack([torch.as_tensor(aff32)] * N))
    return s, cfg, models, batch


def _stream(pose, i):
    return type(pose)(*(f[i] for f in pose))


def _single(cfg, models, batch, i, **draw):
    q, ref, dems, ks, affs = batch
    return tgp.build_frame_to_geopose_cached(cfg)(
        models, q[i], type(ref)(*(f[i] for f in ref)), dems[i], ks[i],
        affs[i], **draw)


def _equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("fork", [True, False])
def test_stream_equals_single_frame_with_generators(streams, fork):
    _, cfg, models, batch = streams
    out = build_multistream_pipeline(cfg, fork_streams=fork)(
        models, *batch, [torch.Generator().manual_seed(i + 1)
                         for i in range(N)])
    assert out.ecef_position.shape == (N, 3)
    assert out.matched_ref.shape == (N, cfg.max_keypoints, 2)
    for i in range(N):
        _equal(_stream(out, i), _single(
            cfg, models, batch, i,
            generator=torch.Generator().manual_seed(i + 1)))


def test_stream_equals_single_frame_with_sample_idx(streams):
    _, cfg, models, batch = streams
    gen = torch.Generator().manual_seed(5)
    idx = torch.randint(0, cfg.max_keypoints, (N, cfg.num_hypotheses, 4),
                        generator=gen)
    out = build_multistream_pipeline(cfg)(models, *batch, idx)
    for i in range(N):
        _equal(_stream(out, i),
               _single(cfg, models, batch, i, sample_idx=idx[i]))


def test_multistream_vs_jax(streams):
    s, cfg, models, batch = streams
    j_params, j_cfg = jruns.load_bundled("harris_lg5")
    j_cfg = dataclasses.replace(j_cfg, ortho_shape=s.ortho.shape,
                                detector_downsample=2)
    j_ref = jax.jit(jgp.build_reference_extractor(j_cfg))(
        j_params, jnp.asarray(s.ortho, jnp.float32) / 255.0)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    j_batch = [jnp.asarray(t.numpy()) for t in (batch[0], *batch[2:])]
    j_out = jax.jit(j_multistream(j_cfg))(
        j_params, j_batch[0],
        jax.tree.map(lambda a: jnp.broadcast_to(a, (N,) + a.shape), j_ref),
        *j_batch[1:], keys)
    out = build_multistream_pipeline(cfg)(
        models, *batch,
        [lambda mask, _, key=key: jax_ransac_sample(key, mask.numpy())
         for key in keys])
    for i, (lon, lat) in enumerate(s.truth_lonlat):
        p, r = _stream(out, i), jax.tree.map(lambda a: np.asarray(a)[i],
                                             j_out)
        pf = tgp.geopose_to_wgs84_f64(p, s.crs_affine)
        rf = jgp.geopose_to_wgs84_f64(r, s.crs_affine)
        horiz = haversine_m(pf["lat"], pf["lon"], rf["lat"], rf["lon"])
        dalt = abs(pf["alt_ellipsoid"] - rf["alt_ellipsoid"])
        print(f"stream {i}: port-vs-JAX {horiz:.3f} m, {dalt:.3f} m alt; "
              f"matches {int(p.num_matches)}/{int(r.num_matches)}")
        assert bool(p.valid) == bool(r.valid) is True
        n = int(r.num_matches)
        assert abs(int(p.num_matches) - n) <= 0.1 * n + 1
        for fix in (pf, rf):
            assert haversine_m(lat, lon, fix["lat"], fix["lon"]) < 10.0
        assert horiz < 2.5 and dalt < 0.5


def test_render_streams_places_feeds_apart():
    """``chip_smoke.py`` path 12's layout at a small size: 8 feeds 115 m
    apart on a 150 m ring, each over its own map with the camera 50 m off
    its centre, so a fix read through a neighbour's map lands 38 m off."""
    import itertools

    from gisnav_tpu_torch.utils.world import render_streams

    scenes = render_streams(seed=12, h=96, w=160, yaws=[10.0 + 45 * i
                                                         for i in range(8)],
                            map_side=1024, coverage=3.0)
    truths = [s.truth_lonlat[0] for s in scenes]
    apart = [haversine_m(a[1], a[0], b[1], b[0])
             for a, b in itertools.combinations(truths, 2)]
    assert 114.0 < min(apart) < 116.0
    for i, s in enumerate(scenes):
        assert s.frames[0].shape == (96, 160)
        assert s.ortho.shape == (1024, 1024)
        assert s.frames[0].std() > 5.0
        aff = s.crs_affine
        px = np.linalg.solve(aff[:2, :2], np.array(truths[i]) - aff[:2, 3])
        gsd = 3.0 * 500 * 160 / 100 / 1024  # f = 100 px at 160 px wide
        # 50 m from the map's centre, to the crop's rounding (0.7 px)
        assert abs(np.hypot(*(px - 512)) * gsd - 50.0) < 0.71 * gsd
        nxt = scenes[(i + 1) % 8].crs_affine
        pj = np.linalg.solve(nxt[:2, :2], np.array(truths[(i + 1) % 8])
                             - nxt[:2, 3])
        lon, lat = aff[:2, :2] @ pj + aff[:2, 3]
        assert 30.0 < haversine_m(truths[i][1], truths[i][0], lat, lon) < 45
