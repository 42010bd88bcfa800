"""The slice as a whole: the port's bucketed warp runner against the JAX one.

Both runners get the bundled learned_lg9 weights (depth 9), the same rendered
scene at 128x256 with 512 keypoints, and two frames in two rotation buckets.
The port's RANSAC draws are the JAX runner's (``PRNGKey(frame number)``
through ``jax.random.choice``, rebuilt here on the port's match mask and
passed to the port's frame program as ``sample_idx``).

The gates, from the trunk to the fix:

- conv trunk on the scene's frame: on the same input a stage differs from
  the JAX reference in at most 0.1 % of its bf16 values (summation order);
  chained from the image, those flips compound to 11.5 % of the stage-4
  activations (measured), each still within 4e-3;
- SuperPoint keypoints as sets, query and bucket crop: at least 90 % of the
  JAX keypoints are reproduced to 1e-3 px and 98 % to 0.5 px;
- LightGlue on the JAX runner's own features: ``matches0`` agrees on more
  than 98 % (measured 99.8 % and 100 %);
- geometry tail (DEM lift, RANSAC-PnP, geopose assembly, f64 re-assembly) on
  the JAX runner's own matches and draw: the JAX fix to 0.25 m;
- the whole runner: within 2.5 m horizontally and 0.5 m in altitude of the
  JAX runner, and no farther than the JAX runner's own fix moves between
  two of its RANSAC keys on this scene (16 keys a frame; measured 3.40 m on
  the first frame, 1.17 m on the second, against port differences of
  1.24 m and 1.97 m). The few keypoints the trunk flips change the inlier
  set, and at this size's 8.3 m/px map sampling the 4-point RANSAC +
  Gauss-Newton estimate moves by metres with it.

``JAX_PLATFORMS=cpu python -m tests.test_torch_pipeline`` prints the
readings these gates hold.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.features import pallas_conv as jconv
from gisnav_tpu.features.superpoint import SuperPoint as JSuperPoint
from gisnav_tpu.matching.lightglue import LightGlue as JLightGlue
from gisnav_tpu.matching.lightglue import apply_lightglue
from gisnav_tpu.pipeline import geopose as jgp
from gisnav_tpu.pipeline.runners import load_bundled as j_load_bundled
from gisnav_tpu.pipeline.runners import make_bucketed_warp_runner as j_runner
from gisnav_tpu.pnp.dem import gather_elevation as j_gather_elevation
from gisnav_tpu.pnp.ransac import ransac_pnp as j_ransac_pnp
from gisnav_tpu_torch.features import conv as tconv
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
BUCKET = 15.0
KEYS = 16  # RANSAC keys over which the JAX runner's own spread is taken


def _jax_side(j_params, j_cfg, scene):
    """Per frame: the JAX runner's query and bucket-crop features, its
    matches, DEM crop and crop affine, and its fix under RANSAC keys
    1..KEYS."""
    extract = jax.jit(jgp.build_warp_reference_extractor(j_cfg))
    sp = JSuperPoint(max_keypoints=K)
    lg = JLightGlue(depth=9)

    @jax.jit
    def match(query, ref):
        f = sp.apply(j_params["superpoint"], query)
        m = apply_lightglue(lg, j_params["lightglue"], f.keypoints,
                            f.descriptors, f.mask, (H, W), ref.keypoints,
                            ref.descriptors, ref.mask, (H, W))
        return f, m.matches0

    @jax.jit
    def tail(kq, m0, kref, dem_crop, m_crop, k, aff, key):
        mvalid = m0 >= 0
        mkp_ref = kref[jnp.clip(m0, 0)]
        z_scale = aff[2, 2] * jnp.sqrt(jnp.abs(jnp.linalg.det(m_crop[:2, :2])))
        dem_m = j_gather_elevation(dem_crop, mkp_ref)
        obj = jnp.concatenate([mkp_ref, (dem_m / z_scale)[:, None]], axis=1)
        pnp = j_ransac_pnp(obj, kq, k, mvalid, key=key,
                           num_hypotheses=j_cfg.num_hypotheses,
                           threshold_px=j_cfg.threshold_px,
                           min_inliers=j_cfg.min_matches,
                           refine_iters=j_cfg.refine_iters)
        _, _, _, cam = jgp.assemble_geopose(pnp.r, pnp.t, m_crop, aff)
        return pnp.r, cam

    zoom = scene.alt_m / scene.k[0, 0] / abs(scene.crs_affine[2, 2])
    zstep = np.log1p(0.10)
    zq = float(np.exp(round(np.log(zoom) / zstep) * zstep))
    ortho = jnp.asarray(scene.ortho, jnp.float32) / 255.0
    k = jnp.asarray(scene.k, jnp.float32)
    aff = jnp.asarray(scene.crs_affine, jnp.float32)
    out = []
    for frame, yaw in zip(scene.frames, scene.yaws):
        feats, dem_crop, m_crop = extract(
            j_params, ortho, jnp.asarray(scene.dem),
            jnp.float32(round(yaw / BUCKET) * BUCKET), jnp.float32(zq))
        fq, m0 = match(jnp.asarray(frame, jnp.float32) / 255.0, feats)
        fixes = []
        for key in range(1, KEYS + 1):
            r, cam = tail(fq.keypoints, m0, feats.keypoints, dem_crop, m_crop,
                          k, aff, jax.random.PRNGKey(key))
            pose = jgp.GeoPose(*([None] * 3), r, cam, m_crop, *([None] * 6))
            fixes.append(jgp.geopose_to_wgs84_f64(pose, scene.crs_affine))
        out.append({"query": fq, "ref": feats, "m0": np.asarray(m0),
                    "dem_crop": np.asarray(dem_crop),
                    "m_crop": np.asarray(m_crop), "key_fixes": fixes})
    return out


def _with_jax_draw(config):
    """The port's frame program, drawing RANSAC samples as the JAX runner
    does for its n-th frame."""
    hot = tgp.build_frame_to_geopose_warpcached(config)
    frames = itertools.count(1)

    def fn(*args, sample_idx=None, generator=None):
        key = jax.random.PRNGKey(next(frames))
        return hot(*args, generator=generator,
                   sample_idx=lambda mask, _: jax_ransac_sample(
                       key, mask.cpu().numpy()))

    return fn


@pytest.fixture(scope="module")
def fixes():
    scene = render_scene(seed=4, h=H, w=W, yaws=[0.0, 30.0])
    params, cfg = load_bundled("learned_lg9")
    cfg = dataclasses.replace(cfg, image_shape=(H, W), max_keypoints=K)
    j_params, j_cfg = j_load_bundled("learned_lg9")
    j_cfg = dataclasses.replace(j_cfg, image_shape=(H, W), max_keypoints=K)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(truns, "build_frame_to_geopose_warpcached", _with_jax_draw)
        port = truns.make_bucketed_warp_runner(params, cfg, BUCKET,
                                               device="cpu")
    ref = j_runner(j_params, j_cfg, BUCKET)
    out = []
    for frame, yaw, truth in zip(scene.frames, scene.yaws,
                                 scene.truth_lonlat):
        args = (frame, scene.ortho, scene.dem, yaw, scene.k,
                scene.crs_affine)
        kw = dict(map_stamp=1, altitude_agl=scene.alt_m)
        p, r = port(*args, **kw), ref(*args, **kw)
        out.append((p, tgp.geopose_to_wgs84_f64(p, scene.crs_affine), r,
                    jgp.geopose_to_wgs84_f64(r, scene.crs_affine), truth))
    models = tgp.build_models(params_from_jax(params), cfg)
    return scene, out, _jax_side(j_params, j_cfg, scene), models, cfg


def _dist(a, b):
    return (haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]),
            abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]))


def _key_spread(side):
    """Largest move of the JAX fix between any two of its RANSAC keys."""
    fx = side["key_fixes"]
    return max(_dist(a, b)[0] for a, b in itertools.combinations(fx, 2))


def trunk_diffs(scene):
    """Port trunk vs JAX XLA trunk on the first frame: per stage the share
    of differing bf16 values and the largest difference, on the same input
    (``same``) and chained from the frame (``chained``)."""
    j_params, _ = j_load_bundled("learned_lg9")
    jp = j_params["superpoint"]["params"]
    tp = params_from_jax(j_params)["superpoint"]

    def jw(n):
        return jnp.asarray(jp[n]["kernel"]), jnp.asarray(jp[n]["bias"])

    def tw(n):
        return tp[n]["weight"], tp[n]["bias"]

    def diff(j, t):
        d = np.abs(np.asarray(j.astype(jnp.float32)) - t.float().numpy())
        return float((d > 0).mean()), float(d.max())

    q = scene.frames[0].astype(np.float32) / 255.0
    j = jconv.stem_stage(jnp.asarray(q), *jw("conv1a"), *jw("conv1b"), True)
    t = tconv.stem_stage(torch.as_tensor(q), *tw("conv1a"), *tw("conv1b"))
    out = {"stem": {"same": diff(j, t), "chained": diff(j, t)}}
    for a, b, pool in (("conv2a", "conv2b", True), ("conv3a", "conv3b", True),
                       ("conv4a", "conv4b", False)):
        same_in = torch.as_tensor(np.asarray(j.astype(jnp.float32))).to(
            torch.bfloat16)
        j = jconv.conv_stage(j, *jw(a), *jw(b), pool)
        t = tconv.conv_stage(t, *tw(a), *tw(b), pool=pool)
        same = tconv.conv_stage(same_in, *tw(a), *tw(b), pool=pool)
        out[a[:-1]] = {"same": diff(j, same), "chained": diff(j, t)}
    return out


def keypoint_shares(fixes, side):
    """Per frame: port and JAX keypoint counts, and the share of JAX
    keypoints the port reproduces to 1e-3 px and to 0.5 px."""
    scene, _, jax_side, models, cfg = fixes
    ortho = torch.as_tensor(scene.ortho.astype(np.float32)) / 255.0
    extract = tgp.build_warp_reference_extractor(cfg)
    zoom = scene.alt_m / scene.k[0, 0] / abs(scene.crs_affine[2, 2])
    zstep = np.log1p(0.10)
    zq = float(np.exp(round(np.log(zoom) / zstep) * zstep))
    out = []
    for frame, yaw, js in zip(scene.frames, scene.yaws, jax_side):
        if side == "query":
            got = models["superpoint"](
                torch.as_tensor(frame.astype(np.float32)) / 255.0)
        else:
            got = extract(models, ortho, torch.as_tensor(scene.dem),
                          float(np.float32(round(yaw / BUCKET) * BUCKET)),
                          zq)[0]
        jf = js[side]
        a = got.keypoints[got.mask].numpy()
        b = np.asarray(jf.keypoints)[np.asarray(jf.mask)]
        d = np.linalg.norm(b[:, None] - a[None], axis=-1).min(axis=1)
        out.append((len(a), len(b), float((d < 1e-3).mean()),
                    float((d < 0.5).mean())))
    return out


def lightglue_agreement(fixes):
    """Per frame: share of ``matches0`` the port's LightGlue gives as the
    JAX one does, both on the JAX runner's own features."""
    _, _, jax_side, models, _ = fixes
    out = []
    for js in jax_side:
        fq, fr = js["query"], js["ref"]
        t = [torch.as_tensor(np.asarray(a)) for a in (
            fq.keypoints, fq.descriptors, fq.mask, fr.keypoints,
            fr.descriptors, fr.mask)]
        got = models["lightglue"](*t[:3], (H, W), *t[3:], (H, W)).matches0
        out.append(float((got.numpy() == js["m0"]).mean()))
    return out


def tail_diffs(fixes):
    """Per frame: the port's geometry tail on the JAX runner's matches and
    RANSAC draw against the JAX runner's fix, (valid, horizontal m,
    altitude m)."""
    scene, out, jax_side, _, _ = fixes
    aff = torch.as_tensor(scene.crs_affine, dtype=torch.float32)
    k = torch.as_tensor(scene.k, dtype=torch.float32)
    diffs = []
    for n, ((_, _, _, rf, _), js) in enumerate(zip(out, jax_side), start=1):
        m0 = js["m0"]
        mvalid = m0 >= 0
        kref = np.asarray(js["ref"].keypoints)
        mkp_ref = torch.as_tensor(kref[np.clip(m0, 0, None)])
        m_crop_t = torch.as_tensor(js["m_crop"])
        z_scale = aff[2, 2] * torch.sqrt(torch.abs(torch.linalg.det(
            m_crop_t[:2, :2])))
        dem_m = gather_elevation(torch.as_tensor(js["dem_crop"]), mkp_ref)
        obj = torch.cat([mkp_ref, (dem_m / z_scale)[:, None]], dim=1)
        pnp = ransac_pnp(obj, torch.as_tensor(np.asarray(
            js["query"].keypoints)), k, torch.as_tensor(mvalid),
            sample_idx=jax_ransac_sample(jax.random.PRNGKey(n), mvalid),
            min_inliers=15)
        _, _, _, cam = tgp.assemble_geopose(pnp.r, pnp.t, m_crop_t, aff)
        pose = tgp.GeoPose(*([None] * 3), pnp.r, cam, m_crop_t,
                           *([None] * 6))
        diffs.append((bool(pnp.valid), *_dist(
            tgp.geopose_to_wgs84_f64(pose, scene.crs_affine), rf)))
    return diffs


def test_conv_trunk_flip_share_on_scene(fixes):
    """Chained from the frame, the port's trunk and the JAX XLA trunk drift
    apart by one-ulp flips; on the same input a stage differs in <= 0.1 %."""
    diffs = trunk_diffs(fixes[0])
    for stage, d in diffs.items():
        share, err = d["same"]
        assert share <= 1e-3 and err <= 2e-3, (stage, share, err)
    share, err = diffs["conv4"]["chained"]
    assert share <= 0.15 and err <= 4e-3, (share, err)


@pytest.mark.parametrize("side", ["query", "ref"])
def test_superpoint_keypoints_vs_jax(fixes, side):
    for n_port, n_jax, exact, near in keypoint_shares(fixes, side):
        assert abs(n_port - n_jax) <= 0.02 * n_jax + 1, (n_port, n_jax)
        assert exact >= 0.90 and near >= 0.98, (exact, near)


def test_lightglue_on_runner_features(fixes):
    for agree in lightglue_agreement(fixes):
        assert agree > 0.98


def test_geometry_tail_on_jax_matches(fixes):
    for n, (valid, horiz, dalt) in enumerate(tail_diffs(fixes), start=1):
        assert valid
        assert np.hypot(horiz, dalt) < 0.25, (horiz, dalt)
    # the JAX tail of _jax_side is the JAX runner's own under the same key
    for n, ((_, _, _, rf, _), js) in enumerate(zip(fixes[1], fixes[2]),
                                               start=1):
        assert _dist(js["key_fixes"][n - 1], rf)[0] < 1e-3


def test_port_runner_vs_jax_runner(fixes):
    _, out, jax_side, _, _ = fixes
    spread = max(_key_spread(js) for js in jax_side)
    for p, pf, r, rf, _ in out:
        assert bool(p.valid) and bool(r.valid)
        horiz, dalt = _dist(pf, rf)
        assert horiz < 2.5 and dalt < 0.5, (horiz, dalt)
        assert horiz <= spread, (horiz, spread)


def test_port_runner_fixes_near_truth(fixes):
    """Both runners fix the rendered camera within 3 px of the 8.3 m/px map
    sampling of this size."""
    for _, pf, _, rf, (lon, lat) in fixes[1]:
        assert haversine_m(lat, lon, pf["lat"], pf["lon"]) < 25.0
        assert haversine_m(lat, lon, rf["lat"], rf["lon"]) < 25.0


if __name__ == "__main__":
    # print the readings these tests gate:
    #   JAX_PLATFORMS=cpu python -m tests.test_torch_pipeline
    fx = fixes.__wrapped__()
    for stage, d in trunk_diffs(fx[0]).items():
        print(f"trunk {stage}: same input share {d['same'][0]:.4%} max "
              f"{d['same'][1]:.4g}; chained share {d['chained'][0]:.4%} "
              f"max {d['chained'][1]:.4g}")
    for side in ("query", "ref"):
        for n, (a, b, exact, near) in enumerate(keypoint_shares(fx, side)):
            print(f"keypoints {side} frame {n}: port {a} jax {b}, "
                  f"{exact:.2%} to 1e-3 px, {near:.2%} to 0.5 px")
    print("lightglue matches0 agreement on JAX features:",
          [f"{a:.2%}" for a in lightglue_agreement(fx)])
    for n, (valid, horiz, dalt) in enumerate(tail_diffs(fx)):
        print(f"geometry tail frame {n}: valid={valid} {horiz * 1e3:.3f} mm "
              f"horizontal, {dalt * 1e3:.3f} mm altitude")
    for n, ((p, pf, r, rf, _), js) in enumerate(zip(fx[1], fx[2])):
        print(f"runner frame {n}: port-vs-JAX {_dist(pf, rf)[0]:.3f} m "
              f"horizontal, {_dist(pf, rf)[1]:.3f} m altitude; JAX spread "
              f"over {KEYS} keys {_key_spread(js):.3f} m")
