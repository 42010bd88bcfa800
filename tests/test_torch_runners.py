"""The cached-reference and exact-warp runners of the port against the JAX
runners, with the bundled learned_lg9 weights at depth 9 and 512 keypoints
on the port's rendered scene.

The exact-warp runner runs at the size of the bucketed runner's test
(128x256 frames, the 288x288 map at 3x coverage). The cached mode matches
the query against the whole map without a warp; at that size and coverage
neither package's cached runner finds a valid fix (the query is pooled to
64x128 and the learned weights do not bridge the gap), which would compare
nothing. Its scene is 256x320 frames over a 512x512 map at 2.2x coverage
(3.43 m/px against the query's 2.5 m/px, no pooling), where both packages
fix every frame.

The port's RANSAC draws are the JAX runner's (``PRNGKey(frame number)``
rebuilt on the port's match mask and passed to the port's frame program as
``sample_idx``). The gates follow the bucketed runner's test:

- reference extractor over the whole orthoimage (tiled selection): at least
  90 % of the JAX keypoints reproduced to 1e-3 px and 98 % to 0.5 px;
- the geometry tail (DEM lift, RANSAC-PnP, geopose assembly, f64
  re-assembly) on the JAX program's own matches and draw: its fix to 1 mm;
- the exact-warp runner and the zoom-less exact-warp program
  (``gsd_zoom=None`` on a map at the query's ground sample distance):
  valid where the JAX one is, within 2.5 m horizontally and 0.5 m in
  altitude of it (measured 0.81 m, 0.001 m and 0.07 m);
- the cached runner, also with a position prior:
  valid where the JAX runner is, match counts within 5, no farther from the
  JAX fix than the JAX program's own fix moves between two of 16 RANSAC
  keys on that frame, and within 2 map px (6.9 m) and 2.5 m in altitude.
  Measured 1.761 / 7.968 / 1.908 m (altitude 0.002 / 3.106 / 1.619 m;
  prior 1.922 / 0.287 m), match counts 99/99, 99/99, 100/101, against JAX
  key spreads of 7.47 / 20.14 / 7.32 m. The match sets differ: on frame 1
  (yaw 30) 77 of the 99 matched pairs equal the JAX runner's to 1e-3 px
  and 98 lie within 0.5 px (the bf16 trunk moves a few query keypoints),
  so the mask, and with it the whole RANSAC draw, differs; with 80-90
  inliers of 100 matches at 3.43 m/px the estimate is loose by metres in
  both packages. That frame is held to the JAX program's own spread alone,
  horizontally and in altitude (20.14 m and 5.43 m), as the harris_lg5
  test holds its frames; the 2.5 m of the warp modes is not reachable here;
- the cached runner with query derotation (yaw -10): at least 85 % of the
  JAX runner's camera-pixel keypoints reproduced to 1e-2 px and 98 % to
  0.5 px, match counts within 5, and the fix within the JAX program's key
  spread on that frame (measured 9.81 m against a spread of 23.8 m: with 62
  inliers of 80 matches the derotated frame is looser still in both), and
  each package's fix within 25 m of the scene's truth, the bound of the
  other runner tests (measured: port 3.9 m, JAX 7.8 m, at 3.43 m/px);
- ``runner.stats`` equal, one map extraction for one ``map_stamp``.

With the default bundle, ``harris_lg5`` (Harris detector + LightGlue-5) at
its own width, 480x640 and 512 keypoints, on the scene of ``chip_smoke.py``
path 4 (an 800x800 map at 3x the footprint, the sizing of the JAX package's
8-yaw sweep, ``tests/test_cached_rotation.py``):

- ``params=None`` gives every deep runner ``harris_lg5`` with
  ``PRETRAINED_CONFIG``, as in the JAX package; params without a config
  give the config inferred from the tree (a written departure: the JAX
  runners pin ``PRETRAINED_CONFIG``);
- the cached runner (query pooled to 240x320 against the whole map) on two
  yaws, drawing as the JAX runner: valid where the JAX runner is, match
  counts within 10 % (the port's select takes the TPU kernel's route for
  240 rows, which keeps a few bottom-band keypoints the JAX CPU route
  suppresses), each fix within 10 m of the truth and within the warp
  modes' 2.5 m horizontally and 0.5 m in altitude of the JAX fix, or
  within the JAX program's own spread over 16 RANSAC keys where that is
  wider (measured 0.055 / 0.004 m and 1.949 / 1.645 m, against JAX
  spreads of 2.32 / 0.28 m and 3.28 / 3.07 m); the frame program under
  each of the 16 keys against the JAX program under the same key: the
  median within 2.5 m and 0.5 m in altitude (measured 0.055 / 0.004 m and
  0.454 / 0.146 m), each key within 2.5 m or the spread;
- the exact-warp and bucketed runners on one frame each: the warp modes'
  2.5 m / 0.5 m (measured 0.1 mm);
- the port's cached runner over all 8 yaws under 10 m of the truth (marked
  ``slow``; measured 0.6-5.1 m).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.features.superpoint import SuperPoint as JSuperPoint
from gisnav_tpu.matching.lightglue import LightGlue as JLightGlue
from gisnav_tpu.matching.lightglue import apply_lightglue
from gisnav_tpu.pipeline import geopose as jgp
from gisnav_tpu.pipeline import runners as jruns
from gisnav_tpu.pnp.dem import gather_elevation as j_gather_elevation
from gisnav_tpu.pnp.ransac import ransac_pnp as j_ransac_pnp
from gisnav_tpu_torch.geometry.crs import haversine_m
from gisnav_tpu_torch.pipeline import geopose as tgp
from gisnav_tpu_torch.pipeline import runners as truns
from gisnav_tpu_torch.pnp.dem import gather_elevation
from gisnav_tpu_torch.pnp.ransac import ransac_pnp
from gisnav_tpu_torch.utils.world import render_scene
from gisnav_tpu_torch.weights import load_bundled, params_from_jax

from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)

H, W, K = 128, 256, 512
HC, WC = 256, 320  # the cached mode's frame
CACHED_GATES = dict(horiz_m=6.9, alt_m=2.5)  # 2 px of the 3.43 m/px map
KEYS = 16  # RANSAC keys over which the JAX program's own spread is taken


def _dist(a, b):
    return (haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]),
            abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]))


def _with_jax_draw(make_program):
    """``make_program`` (a ``build_frame_to_geopose*`` of the port), with the
    program drawing RANSAC samples as the JAX runner does for its n-th
    frame."""
    frames = itertools.count(1)

    def build(config):
        fn = make_program(config)

        def run(*args, **kw):
            key = jax.random.PRNGKey(next(frames))
            kw["sample_idx"] = lambda mask, _: jax_ransac_sample(
                key, mask.cpu().numpy())
            return fn(*args, **kw)

        return run

    return build


def _port_runner(name, *args, **kw):
    """A port runner on the CPU whose frame program draws as JAX does.

    The program is patched around every call of the runner (the cached
    runner builds its program at its first frame, the others when they are
    made), so every frame draws the JAX runner's RANSAC samples."""
    program = {"make_cached_deep_runner": "build_frame_to_geopose_cached",
               "make_deep_runner": "build_frame_to_geopose",
               "make_bucketed_warp_runner":
                   "build_frame_to_geopose_warpcached"}[name]
    patched = _with_jax_draw(getattr(truns, program))

    def patch(fn, *a, **k):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(truns, program, patched)
            return fn(*a, **k)

    runner = patch(getattr(truns, name), *args, device="cpu", **kw)

    def run(*a, **k):
        return patch(runner, *a, **k)

    run.__dict__.update(vars(runner))  # the cached runner's ``stats``
    return run


def _key_spread(program, *args, altitude=False):
    """Largest move of the JAX program's fix over RANSAC keys 1..KEYS
    (horizontal, or with ``altitude`` both moves); ``program(key)`` returns
    a JAX GeoPose."""
    fixes = [jgp.geopose_to_wgs84_f64(program(jax.random.PRNGKey(n)), *args)
             for n in range(1, KEYS + 1)]
    moves = [_dist(a, b) for a, b in itertools.combinations(fixes, 2)]
    if altitude:
        return tuple(max(m[i] for m in moves) for i in (0, 1))
    return max(m[0] for m in moves)


def _fly(scene, port, ref, frames, **kw):
    out = []
    for i in frames:
        args = (scene.frames[i], scene.ortho, scene.dem, scene.yaws[i],
                scene.k, scene.crs_affine)
        kws = dict(map_stamp=1, altitude_agl=scene.alt_m, **kw)
        p, r = port(*args, **kws), ref(*args, **kws)
        out.append((p, tgp.geopose_to_wgs84_f64(p, scene.crs_affine), r,
                    jgp.geopose_to_wgs84_f64(r, scene.crs_affine)))
    return out


def _assert_near(out, spreads=None, horiz_m=2.5, alt_m=0.5):
    """Each (port pose, port fix, JAX pose, JAX fix) of ``out`` within the
    gates; with ``spreads`` also within the JAX program's own key spread."""
    rows = [(*_dist(pf, rf), p, r) for p, pf, r, rf in out]
    for n, (horiz, dalt, p, r) in enumerate(rows):
        print(f"port-vs-JAX {horiz:.3f} m horizontal, {dalt:.3f} m "
              f"altitude; matches {int(p.num_matches)}/{int(r.num_matches)}"
              f" inliers {int(p.num_inliers)}/{int(r.num_inliers)}"
              + (f"; JAX spread over {KEYS} keys {spreads[n]:.4f} m"
                 if spreads else ""))
    for n, (horiz, dalt, p, r) in enumerate(rows):
        assert bool(p.valid) and bool(r.valid)
        assert abs(int(p.num_matches) - int(r.num_matches)) <= 5
        assert horiz < horiz_m and dalt < alt_m, (horiz, dalt)
        if spreads:
            assert horiz <= spreads[n], (horiz, spreads[n])


@pytest.fixture(scope="module")
def setup():
    params, cfg = load_bundled("learned_lg9")
    cfg = dataclasses.replace(cfg, image_shape=(H, W), max_keypoints=K)
    j_params, j_cfg = jruns.load_bundled("learned_lg9")
    j_cfg = dataclasses.replace(j_cfg, image_shape=(H, W), max_keypoints=K)
    return params, cfg, j_params, j_cfg


@pytest.fixture(scope="module")
def cached_setup(setup):
    params, cfg, j_params, j_cfg = setup
    return (params, dataclasses.replace(cfg, image_shape=(HC, WC)), j_params,
            dataclasses.replace(j_cfg, image_shape=(HC, WC)))


@pytest.fixture(scope="module")
def cached_scene():
    return render_scene(seed=4, h=HC, w=WC, yaws=[0.0, 30.0, -10.0],
                        map_side=512, coverage=2.2)


@pytest.fixture(scope="module")
def cached_jax(cached_setup, cached_scene):
    """The JAX cached program's parts on the cached scene: reference
    features, and per frame the query features, ``matches0`` and the
    program itself as a function of the RANSAC key (and prior)."""
    _, _, j_params, j_cfg = cached_setup
    scene = cached_scene
    shape = scene.ortho.shape
    cfg = dataclasses.replace(j_cfg, ortho_shape=shape)
    ortho = jnp.asarray(scene.ortho, jnp.float32) / 255.0
    ref = jax.jit(jgp.build_reference_extractor(cfg))(j_params, ortho)
    sp, lg = JSuperPoint(max_keypoints=K), JLightGlue(depth=9)

    @jax.jit
    def match(query):
        f = sp.apply(j_params["superpoint"], query)
        m = apply_lightglue(lg, j_params["lightglue"], f.keypoints,
                            f.descriptors, f.mask, (HC, WC), ref.keypoints,
                            ref.descriptors, ref.mask, shape)
        return f, m.matches0

    frame_fn = jax.jit(jgp.build_frame_to_geopose_cached(cfg))
    k = jnp.asarray(scene.k, jnp.float32)
    aff = jnp.asarray(scene.crs_affine, jnp.float32)
    dem = jnp.asarray(scene.dem)

    def program(i, prior_xy=np.zeros(2, np.float32), radius=-1.0,
                rotation=()):
        q = jnp.asarray(scene.frames[i], jnp.float32) / 255.0
        return lambda key: frame_fn(j_params, q, ref, dem, k, aff, key,
                                    jnp.asarray(prior_xy),
                                    jnp.float32(radius),
                                    *map(jnp.float32, rotation))

    per_frame = [match(jnp.asarray(f, jnp.float32) / 255.0)
                 for f in scene.frames]
    return ref, per_frame, program


@pytest.fixture(scope="module")
def cached_fixes(cached_setup, cached_scene):
    params, cfg, j_params, j_cfg = cached_setup
    port = _port_runner("make_cached_deep_runner", params, cfg)
    ref = jruns.make_cached_deep_runner(j_params, j_cfg)
    return _fly(cached_scene, port, ref, [0, 1, 2]), port, ref


def test_reference_extractor_keypoints_vs_jax(cached_setup, cached_scene,
                                              cached_jax):
    params, cfg, _, _ = cached_setup
    models = tgp.build_models(params_from_jax(params), cfg)
    got = tgp.build_reference_extractor(cfg)(
        models, torch.as_tensor(cached_scene.ortho.astype(np.float32))
        / 255.0)
    jf = cached_jax[0]
    assert got.keypoints.shape == (2 * K, 2)
    a = got.keypoints[got.mask].numpy()
    b = np.asarray(jf.keypoints)[np.asarray(jf.mask)]
    assert abs(len(a) - len(b)) <= 0.02 * len(b) + 1, (len(a), len(b))
    d = np.linalg.norm(b[:, None] - a[None], axis=-1).min(axis=1)
    exact, near = float((d < 1e-3).mean()), float((d < 0.5).mean())
    print(f"reference keypoints: port {len(a)} jax {len(b)}, {exact:.2%} "
          f"to 1e-3 px, {near:.2%} to 0.5 px")
    assert exact >= 0.85 and near >= 0.98, (exact, near)


def test_cached_tail_on_jax_matches(cached_setup, cached_scene, cached_jax):
    """The port's tail on the JAX program's matches and draw gives the fix
    of the JAX tail on the same to 1 mm."""
    _, cfg, _, j_cfg = cached_setup
    scene = cached_scene
    ref, per_frame, _ = cached_jax
    kref = np.asarray(ref.keypoints)
    aff = torch.as_tensor(scene.crs_affine, dtype=torch.float32)
    k = torch.as_tensor(scene.k, dtype=torch.float32)

    @jax.jit
    def j_tail(kq, m0, key):
        mvalid = m0 >= 0
        mkp_ref = ref.keypoints[jnp.clip(m0, 0)]
        jaff = jnp.asarray(scene.crs_affine, jnp.float32)
        dem_m = j_gather_elevation(jnp.asarray(scene.dem), mkp_ref)
        obj = jnp.concatenate([mkp_ref, (dem_m / jaff[2, 2])[:, None]], 1)
        pnp = j_ransac_pnp(obj, kq, jnp.asarray(scene.k, jnp.float32),
                           mvalid, key=key,
                           num_hypotheses=j_cfg.num_hypotheses,
                           threshold_px=j_cfg.threshold_px,
                           min_inliers=j_cfg.min_matches,
                           refine_iters=j_cfg.refine_iters)
        _, _, _, cam = jgp.assemble_geopose(pnp.r, pnp.t, jnp.eye(3), jaff)
        return pnp.r, cam, pnp.valid

    for n, (fq, m0) in enumerate(per_frame[:2], start=1):
        key = jax.random.PRNGKey(n)
        r, cam, valid = j_tail(fq.keypoints, m0, key)
        want = jgp.geopose_to_wgs84_f64(
            jgp.GeoPose(*([None] * 3), r, cam, jnp.eye(3), *([None] * 6)),
            scene.crs_affine)
        m0 = np.asarray(m0)
        mvalid = m0 >= 0
        mkp_ref = torch.as_tensor(kref[np.clip(m0, 0, None)])
        dem_m = gather_elevation(torch.as_tensor(scene.dem), mkp_ref)
        obj = torch.cat([mkp_ref, (dem_m / aff[2, 2])[:, None]], dim=1)
        pnp = ransac_pnp(obj, torch.as_tensor(np.asarray(fq.keypoints)), k,
                         torch.as_tensor(mvalid),
                         sample_idx=jax_ransac_sample(key, mvalid),
                         min_inliers=cfg.min_matches)
        eye = torch.eye(3)
        _, _, _, tcam = tgp.assemble_geopose(pnp.r, pnp.t, eye, aff)
        got = tgp.geopose_to_wgs84_f64(
            tgp.GeoPose(*([None] * 3), pnp.r, tcam, eye, *([None] * 6)),
            scene.crs_affine)
        assert bool(pnp.valid) and bool(valid)
        assert np.hypot(*_dist(got, want)) < 1e-3


def test_cached_runner_vs_jax_runner(cached_fixes, cached_jax,
                                     cached_scene):
    out, port, ref = cached_fixes
    _, _, program = cached_jax
    spreads = [_key_spread(program(i), cached_scene.crs_affine,
                           altitude=True) for i in (0, 1, 2)]
    print(f"JAX key spreads (horizontal, altitude): {spreads}")
    _assert_near([out[0], out[2]], [spreads[0][0], spreads[2][0]],
                 **CACHED_GATES)
    # frame 1's match set differs from the JAX runner's (module docstring):
    # the JAX program's own spread over its keys is the gate
    _assert_near([out[1]], [spreads[1][0]], horiz_m=spreads[1][0],
                 alt_m=spreads[1][1])
    for (p, pf, _, _), (lon, lat) in zip(out, cached_scene.truth_lonlat):
        assert float(p.m_crop.sub(torch.eye(3)).abs().max()) == 0.0
        assert haversine_m(lat, lon, pf["lat"], pf["lon"]) < 25.0


def test_cached_runner_stats_and_map_refresh(cached_fixes, cached_scene):
    _, port, ref = cached_fixes
    assert port.stats == ref.stats
    frames, extractions = port.stats["frames"], \
        port.stats["map_extractions"]
    assert extractions == 1 and frames >= 2
    s = cached_scene
    args = (s.frames[0], s.ortho, s.dem, 0.0, s.k, s.crs_affine)
    port(*args, map_stamp=1, altitude_agl=s.alt_m)
    assert port.stats == {"frames": frames + 1, "map_extractions": 1}
    port(*args, map_stamp=2, altitude_agl=s.alt_m)
    assert port.stats == {"frames": frames + 2, "map_extractions": 2}
    ref(*args, map_stamp=1, altitude_agl=s.alt_m)
    ref(*args, map_stamp=2, altitude_agl=s.alt_m)
    assert port.stats == ref.stats


def test_cached_runner_derotate_vs_jax_runner(cached_setup, cached_scene,
                                              cached_jax):
    """Yaw -10: SuperPoint sees the derotated query, PnP the keypoints
    mapped back to camera pixels."""
    params, cfg, j_params, j_cfg = cached_setup
    port = _port_runner("make_cached_deep_runner", params, cfg,
                        derotate=True)
    ref = jruns.make_cached_deep_runner(j_params, j_cfg, derotate=True)
    out = _fly(cached_scene, port, ref, [2])
    spread = _key_spread(cached_jax[2](2, rotation=(-10.0,)),
                         cached_scene.crs_affine)
    _assert_near(out, [spread], horiz_m=20.0, alt_m=2.5)
    p, r = out[0][0], out[0][2]
    # both fixes against the scene's truth, under the bound the other
    # runner tests hold their fixes to
    lon, lat = cached_scene.truth_lonlat[2]
    for name, fix in (("port", out[0][1]), ("JAX", out[0][3])):
        off = haversine_m(lat, lon, fix["lat"], fix["lon"])
        print(f"derotated {name} fix {off:.3f} m from the truth")
        assert off < 25.0, (name, off)
    # the derotated query's keypoints, mapped back to camera pixels, as sets
    a, b = p.matched_qry.numpy(), np.asarray(r.matched_qry)
    d = np.linalg.norm(b[:, None] - a[None], axis=-1).min(axis=1)
    print(f"derotated keypoints in camera px: {(d < 1e-2).mean():.2%} to "
          f"1e-2 px, {(d < 0.5).mean():.2%} to 0.5 px")
    assert (d < 1e-2).mean() >= 0.85 and (d < 0.5).mean() >= 0.98
    # PnP ran on camera pixels: the query keypoints are not the upright
    # grid positions the derotated frame gave
    assert not torch.equal(p.matched_qry, p.matched_qry.round())


def test_cached_runner_prior_vs_jax_runner(cached_setup, cached_scene,
                                           cached_jax):
    params, cfg, j_params, j_cfg = cached_setup
    s = cached_scene
    port = _port_runner("make_cached_deep_runner", params, cfg)
    ref = jruns.make_cached_deep_runner(j_params, j_cfg)
    prior = s.truth_lonlat[0]
    out = _fly(s, port, ref, [0], prior_lonlat=prior)
    aff = np.asarray(s.crs_affine, np.float64)
    pxy = np.linalg.solve(aff[:2, :2], np.asarray(prior) - aff[:2, 3])
    radius = 0.75 * s.alt_m * np.hypot(HC, WC) / s.k[0, 0] / abs(
        aff[2, 2]) * 1.5
    spread = _key_spread(cached_jax[2](0, pxy.astype(np.float32), radius),
                         s.crs_affine)
    _assert_near(out, [spread], **CACHED_GATES)
    # the gate really masks: a prior far off the map leaves no candidates
    far = _fly(s, port, ref, [0], prior_lonlat=(prior[0] + 1.0, prior[1]))
    assert not bool(far[0][0].valid) and not bool(far[0][2].valid)
    assert int(far[0][0].num_matches) == int(far[0][2].num_matches) == 0


def test_deep_runner_vs_jax_runner(setup):
    params, cfg, j_params, j_cfg = setup
    scene = render_scene(seed=4, h=H, w=W, yaws=[0.0, 30.0])
    port = _port_runner("make_deep_runner", params, cfg)
    ref = jruns.make_deep_runner(j_params, j_cfg)
    out = _fly(scene, port, ref, [0, 1])
    # every match is an inlier on these frames, so the JAX program's fix
    # does not move with the RANSAC key (0.2 mm): no spread gate here
    _assert_near(out)
    for (_, pf, _, _), (lon, lat) in zip(out, scene.truth_lonlat):
        assert haversine_m(lat, lon, pf["lat"], pf["lon"]) < 25.0


def test_exact_warp_program_without_zoom_vs_jax(setup):
    """``gsd_zoom=None`` on a map at the query's ground sample distance
    (coverage = map side / frame width): ``rotate_and_crop_auto`` takes the
    zoom-less route (the gather, for CPU tensors, in both packages)."""
    params, cfg, j_params, j_cfg = setup
    scene = render_scene(seed=4, h=H, w=W, yaws=[20.0], coverage=288 / W)
    models = tgp.build_models(params_from_jax(params), cfg)
    key = jax.random.PRNGKey(1)
    f32 = np.float32
    p = tgp.build_frame_to_geopose(cfg)(
        models, torch.as_tensor(scene.frames[0].astype(f32)) / 255.0,
        torch.as_tensor(scene.ortho.astype(f32)) / 255.0,
        torch.as_tensor(scene.dem), 20.0,
        torch.as_tensor(scene.k.astype(f32)),
        torch.as_tensor(scene.crs_affine.astype(f32)),
        sample_idx=lambda mask, _: jax_ransac_sample(key,
                                                     mask.cpu().numpy()))
    frame_fn = jax.jit(jgp.build_frame_to_geopose(j_cfg))

    def program(k_):
        return frame_fn(
            j_params, jnp.asarray(scene.frames[0], jnp.float32) / 255.0,
            jnp.asarray(scene.ortho, jnp.float32) / 255.0,
            jnp.asarray(scene.dem), jnp.float32(20.0),
            jnp.asarray(scene.k, jnp.float32),
            jnp.asarray(scene.crs_affine, jnp.float32), k_)

    r = program(key)
    np.testing.assert_allclose(p.m_crop.numpy(), np.asarray(r.m_crop),
                               rtol=1e-5, atol=1e-5)
    out = [(p, tgp.geopose_to_wgs84_f64(p, scene.crs_affine), r,
            jgp.geopose_to_wgs84_f64(r, scene.crs_affine))]
    _assert_near(out, [max(_key_spread(program, scene.crs_affine), 2.5)])


def test_new_runners_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (truns.make_deep_runner, truns.make_cached_deep_runner,
                 truns.make_semidense_runner):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_pipeline_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(
        tgp.PipelineConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(
        jgp.PipelineConfig)}
    assert ours == theirs


# chip_smoke.py path 4's scene: the JAX 8-yaw sweep's sizing
# (tests/test_cached_rotation.py: 800 px map at 3x the footprint, f = 400
# px, 500 m AGL, the camera ~22 m off the map centre along its yaw)
HARRIS_YAWS = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0]


@pytest.fixture(scope="module")
def harris_scene():
    return render_scene(seed=6, h=480, w=640, yaws=HARRIS_YAWS,
                        map_side=800, coverage=3.0, offset_m=22.2)


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_runner_defaults_as_jax(monkeypatch):
    """``params=None``: ``harris_lg5`` with ``PRETRAINED_CONFIG``; a config
    passed with it is kept; a tree without a config gets the config its
    shape implies."""
    built = []
    real = tgp.build_models
    monkeypatch.setattr(truns, "build_models", lambda p, c: (
        built.append((p, c)), real(p, c))[1])
    harris = params_from_jax(load_bundled("harris_lg5")[0])["superpoint"]
    makes = (truns.make_deep_runner, truns.make_bucketed_warp_runner,
             truns.make_cached_deep_runner)
    for make in makes:
        make(device="cpu")
        params, cfg = built[-1]
        assert _asdict(cfg) == _asdict(jruns.PRETRAINED_CONFIG)
        assert "convPa" not in params["superpoint"]
        assert torch.equal(params["superpoint"]["convDa"]["weight"],
                           harris["convDa"]["weight"])
        assert params["lightglue"].keys() >= {"self_4", "cross_4"}
        assert "self_5" not in params["lightglue"]
    small = dataclasses.replace(jruns.PRETRAINED_CONFIG, max_keypoints=256)
    truns.make_deep_runner(config=small, device="cpu")
    assert _asdict(built[-1][1]) == _asdict(small)
    learned, _ = load_bundled("learned_lg9")
    for make in makes:
        make(learned, device="cpu")
        assert _asdict(built[-1][1]) == _asdict(jruns.LEARNED_LG9_CONFIG)
    for name in ("PRETRAINED_CONFIG", "LEARNED_LG9_CONFIG",
                 "SEMIDENSE_CONFIG"):
        assert _asdict(getattr(truns, name)) == _asdict(
            getattr(jruns, name))


@pytest.fixture(scope="module")
def harris_cached_keys(harris_scene):
    """Frames 0 and 1 of the harris scene through the JAX cached program
    and the port's, both drawing RANSAC samples from keys 1..KEYS: per
    frame the two lists of fixes."""
    s = harris_scene
    j_params, j_cfg = jruns.load_bundled("harris_lg5")
    params, cfg = load_bundled("harris_lg5")
    j_cfg, cfg = (dataclasses.replace(c, ortho_shape=s.ortho.shape,
                                      detector_downsample=2)
                  for c in (j_cfg, cfg))
    j_ref = jax.jit(jgp.build_reference_extractor(j_cfg))(
        j_params, jnp.asarray(s.ortho, jnp.float32) / 255.0)
    j_fn = jax.jit(jgp.build_frame_to_geopose_cached(j_cfg))
    models = tgp.build_models(params_from_jax(params), cfg)
    t_ref = tgp.build_reference_extractor(cfg)(
        models, torch.as_tensor(s.ortho.astype(np.float32)) / 255.0)
    t_fn = tgp.build_frame_to_geopose_cached(cfg)
    k32, aff32 = (np.asarray(a, np.float32) for a in (s.k, s.crs_affine))
    out = []
    for i in (0, 1):
        q = s.frames[i].astype(np.float32) / 255.0
        jax_fixes, port_fixes = [], []
        for n in range(1, KEYS + 1):
            key = jax.random.PRNGKey(n)
            r = j_fn(j_params, jnp.asarray(q), j_ref, jnp.asarray(s.dem),
                     jnp.asarray(k32), jnp.asarray(aff32), key,
                     jnp.zeros(2, jnp.float32), jnp.float32(-1.0))
            p = t_fn(models, torch.as_tensor(q), t_ref,
                     torch.as_tensor(s.dem), torch.as_tensor(k32),
                     torch.as_tensor(aff32),
                     sample_idx=lambda mask, _, key=key: jax_ransac_sample(
                         key, mask.numpy()))
            jax_fixes.append(jgp.geopose_to_wgs84_f64(r, s.crs_affine))
            port_fixes.append(tgp.geopose_to_wgs84_f64(p, s.crs_affine))
        out.append((jax_fixes, port_fixes))
    return out


def test_cached_runner_harris_vs_jax_runner(harris_scene,
                                            harris_cached_keys):
    """The runner's fixes against the JAX runner's, and the frame
    program's under each of 16 RANSAC keys against the JAX program's under
    the same key. The port's query select keeps 4-5 keypoints in the
    bottom border band of the 240-row pooled query that the JAX CPU route
    suppresses (its TPU kernel route keeps them, as the port does), and
    the reference features and LightGlue on equal features agree exactly;
    those few keypoints change the match mask and so the RANSAC draw, so a
    port fix is another draw from the same spread as the JAX one."""
    s = harris_scene
    params, cfg = load_bundled("harris_lg5")
    j_params, j_cfg = jruns.load_bundled("harris_lg5")
    port = _port_runner("make_cached_deep_runner", params, cfg)
    ref = jruns.make_cached_deep_runner(j_params, j_cfg)
    out = _fly(s, port, ref, [0, 1])
    for (p, pf, r, rf), (jax_fixes, port_fixes), (lon, lat) in zip(
            out, harris_cached_keys, s.truth_lonlat):
        horiz, dalt = _dist(pf, rf)
        moves = [_dist(a, b) for a, b in itertools.combinations(jax_fixes,
                                                                2)]
        spread = tuple(max(m[i] for m in moves) for i in (0, 1))
        same = np.array([_dist(a, b) for a, b in zip(port_fixes,
                                                     jax_fixes)])
        print(f"harris cached runner: port-vs-JAX {horiz:.3f} m "
              f"horizontal, {dalt:.3f} m altitude; matches "
              f"{int(p.num_matches)}/{int(r.num_matches)}; JAX spread over "
              f"{KEYS} keys {spread[0]:.3f} m / {spread[1]:.3f} m; same key "
              f"port-vs-JAX median {np.median(same[:, 0]):.3f} m / "
              f"{np.median(same[:, 1]):.3f} m, max {same[:, 0].max():.3f} m"
              f" / {same[:, 1].max():.3f} m")
        assert bool(p.valid) and bool(r.valid)
        n = int(r.num_matches)
        assert abs(int(p.num_matches) - n) <= 0.1 * n + 1
        assert horiz < max(2.5, spread[0]) and dalt < max(0.5, spread[1])
        for fix in (pf, rf):
            assert haversine_m(lat, lon, fix["lat"], fix["lon"]) < 10.0
        assert np.median(same[:, 0]) < 2.5 and np.median(same[:, 1]) < 0.5
        assert (same[:, 0] < np.maximum(2.5, spread[0])).all()
    assert tuple(port.stats.values()) == (2, 1) and port.stats == ref.stats


@pytest.mark.parametrize("name", ["make_deep_runner",
                                  "make_bucketed_warp_runner"])
def test_warp_runners_harris_vs_jax_runner(harris_scene, name):
    params, cfg = load_bundled("harris_lg5")
    j_params, j_cfg = jruns.load_bundled("harris_lg5")
    port = _port_runner(name, params, cfg)
    ref = getattr(jruns, name)(j_params, j_cfg)
    out = _fly(harris_scene, port, ref, [1])
    _assert_near(out)
    lon, lat = harris_scene.truth_lonlat[1]
    assert haversine_m(lat, lon, out[0][1]["lat"], out[0][1]["lon"]) < 10.0


@pytest.mark.slow
def test_cached_runner_harris_eight_yaws(harris_scene):
    """The JAX package's 8-yaw cached sweep (``test_cached_rotation.py``)
    on the port: every fix valid and under 10 m."""
    s = harris_scene
    runner = truns.make_cached_deep_runner(device="cpu")
    for i, (lon, lat) in enumerate(s.truth_lonlat):
        pose = runner(s.frames[i], s.ortho, s.dem, 0.0, s.k, s.crs_affine,
                      map_stamp=1, altitude_agl=s.alt_m)
        fix = tgp.geopose_to_wgs84_f64(pose, s.crs_affine)
        err = haversine_m(lat, lon, fix["lat"], fix["lon"])
        print(f"yaw {s.yaws[i]:5.1f}: valid={bool(pose.valid)} inliers "
              f"{int(pose.num_inliers)} error {err:.3f} m")
        assert bool(pose.valid) and err < 10.0
