"""The port's functional entry points against the JAX package's, on the CPU
(the kernels' plain versions; the JAX functions on their XLA reference).

On the scene of ``tests/test_torch_pipeline.py`` (128x256 frames, 512
keypoints, the bundled learned_lg9 weights through ``load_pretrained``):

- ``extract_features`` on the frame and on the bucket crop (the same numpy
  image for both packages): keypoint counts within 2 % + 1, and at least
  90 % of the JAX keypoints reproduced to 1e-3 px and 98 % to 0.5 px, the
  gates of the pipeline test; at the keypoints reproduced to 1e-3 px the
  descriptors and the scores within 4e-3 of JAX's, the pipeline test's
  gate on the chained trunk (measured 4.3e-4 / 5.3e-4 and 7.6e-4 /
  4.2e-4);
- ``match_features`` on the JAX features, through the fused route (both
  sets at 512, ``fused_lightglue_supported``) and the module route (the
  second set cut to 400 keypoints), against JAX's ``match_features`` (the
  flax module on the CPU): ``matches0`` agreement of at least 99 % at depth
  9 (threshold 0.1) and more than 98 % at depth 2 (threshold 0: cut to
  depth 2 the trained weights' scores stay low, as in
  ``tests/test_torch_lightglue.py``); ``apply_lightglue`` gives
  ``match_features``' result bit for bit, and against JAX's
  ``apply_lightglue`` the same agreement;
- ``match_features`` lays out each route's weights once for the tree it
  was last called with: a second call reuses the matcher, an in-place
  update of a leaf or a call with another tree builds it anew; a write
  through ``.data`` is not seen, as documented, and a ``LightGlueMatcher``
  the caller builds after it, passed in the tree's place, matches with the
  new weights.

The quickstart (``docs/quickstart.md``, "Library only": the cached runner
with the bundled weights, one frame with ``map_stamp=0``, the f64 fix)
with ``gisnav_tpu_torch`` for ``gisnav_tpu`` and ``device="cpu"``, at
256x320 frames over a 512 map at 2.2x the footprint: valid as the JAX
script's fix is, within the runner gates of it (2.5 m horizontally and
0.5 m in altitude, or the JAX runner's own spread over 16 RANSAC draws on
the frame where that is larger), and both within 10 m of the truth.

``JAX_PLATFORMS=cpu python -m tests.test_torch_api_models`` prints the
readings these gates hold.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu import weights as jweights
from gisnav_tpu.features import extract_features as j_extract
from gisnav_tpu.matching import match_features as j_match
from gisnav_tpu.matching.lightglue import LightGlue as JLightGlue
from gisnav_tpu.matching.lightglue import apply_lightglue as j_apply
from gisnav_tpu_torch.features import SuperPointFeatures, extract_features
from gisnav_tpu_torch.geometry.crs import haversine_m
from gisnav_tpu_torch.matching import lightglue as tlg
from gisnav_tpu_torch.matching import lightglue_fused as tlf
from gisnav_tpu_torch.matching import match_features
from gisnav_tpu_torch.parallel.tp import map_tree
from gisnav_tpu_torch.raster.warp import rotate_and_crop_center
from gisnav_tpu_torch.utils.world import render_scene
from gisnav_tpu_torch.weights import (
    LEARNED_LG9_PATH,
    load_pretrained,
    params_from_jax,
)

torch.set_num_threads(2)

H, W, K = 128, 256, 512
BUCKET = 15.0
MODULE_K1 = 400  # no multiple of the fused route's 512-row block


@pytest.fixture(scope="module")
def setup():
    scene = render_scene(seed=4, h=H, w=W, yaws=[0.0, 30.0])
    tree = load_pretrained(LEARNED_LG9_PATH)
    params = params_from_jax(tree, "cpu")
    j_tree = jweights.load_pretrained(jweights.LEARNED_LG9_PATH)
    zoom = scene.alt_m / scene.k[0, 0] / abs(scene.crs_affine[2, 2])
    zstep = np.log1p(0.10)
    zq = float(np.exp(round(np.log(zoom) / zstep) * zstep))
    stack = torch.stack([torch.as_tensor(scene.ortho.astype(np.float32))
                         / 255.0, torch.as_tensor(scene.dem)], dim=-1)
    crop, _ = rotate_and_crop_center(
        stack, float(round(scene.yaws[1] / BUCKET) * BUCKET), (H, W), zq)
    images = {"query": scene.frames[1].astype(np.float32) / 255.0,
              "ref": crop[:, :, 0].contiguous().numpy()}
    j_feats = {k: j_extract(j_tree["superpoint"], jnp.asarray(v),
                            max_keypoints=K) for k, v in images.items()}
    return scene, params, j_tree, images, j_feats


def keypoint_shares(setup):
    """Per image: port and JAX keypoint counts, the share of JAX
    keypoints the port reproduces to 1e-3 px and to 0.5 px, and at those
    reproduced to 1e-3 px the largest difference of the descriptors and of
    the scores."""
    _, params, _, images, j_feats = setup
    out = {}
    for name, image in images.items():
        got = extract_features(params["superpoint"], image, max_keypoints=K,
                               device="cpu")
        assert isinstance(got, SuperPointFeatures)
        assert got.keypoints.shape == (K, 2)
        assert got.descriptors.shape == (K, 256)
        jf = j_feats[name]
        ia, ib = (np.flatnonzero(np.asarray(m)) for m in (got.mask, jf.mask))
        a = got.keypoints.numpy()[ia]
        b = np.asarray(jf.keypoints)[ib]
        dist = np.linalg.norm(b[:, None] - a[None], axis=-1)
        d = dist.min(axis=1)
        exact = d < 1e-3
        pa, pb = ia[dist.argmin(axis=1)[exact]], ib[exact]

        def err(field):
            return float(np.abs(getattr(got, field).numpy()[pa] - np.asarray(
                getattr(jf, field))[pb]).max())

        out[name] = (len(a), len(b), float(exact.mean()),
                     float((d < 0.5).mean()), err("descriptors"),
                     err("scores"))
    return out


def _sets(j_feats, k1):
    """The JAX query and reference features as numpy, the reference cut to
    its first ``k1`` keypoints."""
    q, r = j_feats["query"], j_feats["ref"]

    def np_feats(f, n):
        return SuperPointFeatures(*(np.array(getattr(f, a))[:n] for a in (
            "keypoints", "scores", "descriptors", "mask")))

    return np_feats(q, K), np_feats(r, k1)


def match_agreement(setup, depth, k1):
    """(share of ``matches0`` equal to JAX's, JAX's match count, the
    routes the port's call went through) of ``match_features`` on the JAX
    features."""
    _, params, j_tree, _, j_feats = setup
    f0, f1 = _sets(j_feats, k1)
    thr = 0.1 if depth == 9 else 0.0
    j0, j1 = (SuperPointFeatures(*map(jnp.asarray, f)) for f in (f0, f1))
    want = j_match(j_tree["lightglue"], j0, (H, W), j1, (H, W), depth=depth,
                   filter_threshold=thr)
    routes = set()
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, route in ((tlf, "fused_block", "fused"),
                                 (tlg, "_attention", "module")):
            mp.setattr(mod, name, lambda *a, real=getattr(mod, name),
                       route=route, **kw: (routes.add(route),
                                           real(*a, **kw))[1])
        got = match_features(params["lightglue"], f0, (H, W), f1, (H, W),
                             depth=depth, filter_threshold=thr, device="cpu")
    ref_m0 = np.asarray(want.matches0)
    return (float((got.matches0.numpy() == ref_m0).mean()),
            int((ref_m0 >= 0).sum()), sorted(routes))


@pytest.mark.parametrize("side", ["query", "ref"])
def test_extract_features_vs_jax(setup, side):
    n_port, n_jax, exact, near, desc, score = keypoint_shares(setup)[side]
    assert abs(n_port - n_jax) <= 0.02 * n_jax + 1, (n_port, n_jax)
    assert exact >= 0.90 and near >= 0.98, (exact, near)
    assert desc <= 4e-3 and score <= 4e-3, (desc, score)


@pytest.mark.parametrize("depth,k1,route", [
    (2, K, "fused"), (9, K, "fused"), (2, MODULE_K1, "module"),
    (9, MODULE_K1, "module")])
def test_match_features_vs_jax(setup, depth, k1, route):
    assert tlf.fused_lightglue_supported(K, k1, 256, 4) == (route == "fused")
    agree, n_matches, routes = match_agreement(setup, depth, k1)
    assert routes == [route]
    assert n_matches >= 30, n_matches  # real matches exist
    assert agree >= 0.99 if depth == 9 else agree > 0.98, agree


@pytest.mark.parametrize("k1", [K, MODULE_K1])
def test_apply_lightglue_is_match_features(setup, k1):
    _, params, j_tree, _, j_feats = setup
    f0, f1 = _sets(j_feats, k1)
    t = [torch.as_tensor(getattr(f, a)) for f in (f0, f1)
         for a in ("keypoints", "descriptors", "mask")]
    lg = params["lightglue"]
    got = tlg.apply_lightglue(tlg.LightGlue(lg, depth=2,
                                            filter_threshold=0.0), lg,
                              *t[:3], (H, W), *t[3:], (H, W))
    via = match_features(lg, f0, (H, W), f1, (H, W), depth=2,
                         filter_threshold=0.0, device="cpu")
    for a, b in zip(got, via):
        assert torch.equal(a, b)
    want = j_apply(JLightGlue(depth=2, filter_threshold=0.0),
                   j_tree["lightglue"], *map(jnp.asarray, (
                       f0.keypoints, f0.descriptors, f0.mask)), (H, W),
                   *map(jnp.asarray, (f1.keypoints, f1.descriptors,
                                      f1.mask)), (H, W))
    agree = (got.matches0.numpy() == np.asarray(want.matches0)).mean()
    assert agree > 0.98, agree


def test_match_features_lays_out_weights_once(setup, monkeypatch):
    _, params, _, _, j_feats = setup
    f0, f1 = _sets(j_feats, K)
    lg = {k: v for k, v in params["lightglue"].items()}  # a tree of its own
    built = []
    real = tlf.LightGlue.__init__
    monkeypatch.setattr(tlf.LightGlue, "__init__", lambda self, *a, **kw: (
        built.append(1), real(self, *a, **kw))[1])

    def run():
        return match_features(lg, f0, (H, W), f1, (H, W), depth=1,
                              device="cpu")

    first = run()
    second = run()
    assert len(built) == 1
    assert torch.equal(first.matches0, second.matches0)
    with torch.no_grad():
        lg["final_proj"]["weight"].mul_(1.0)  # an in-place update
    run()
    assert len(built) == 2
    other = dict(lg)  # another tree takes the one slot
    match_features(other, f0, (H, W), f1, (H, W), depth=1, device="cpu")
    run()
    assert len(built) == 4
    with pytest.raises(ValueError, match="input_dim=128"):
        match_features(lg, f0, (H, W), f1, (H, W), input_dim=128,
                       device="cpu")



def test_match_features_held_matcher_after_data_write(setup):
    _, params, _, _, j_feats = setup
    f0, f1 = _sets(j_feats, K)
    lg = map_tree(torch.clone, params["lightglue"])  # leaves of its own

    def run(weights):
        return match_features(weights, f0, (H, W), f1, (H, W), depth=2,
                              filter_threshold=0.0, device="cpu")

    before = run(lg)
    assert (before.matches0 >= 0).sum() >= 30
    lg["final_proj"]["weight"].data.zero_()  # past the version counter
    # documented: the kept matcher does not see it
    assert torch.equal(run(lg).matches0, before.matches0)
    held = tlg.LightGlueMatcher(lg, depth=2, filter_threshold=0.0)
    after = run(held)
    assert torch.equal(after.matches0, run(map_tree(torch.clone,
                                                    lg)).matches0)
    # zero similarity: at most the one mutual pair of the ties remains
    assert (after.matches0 >= 0).sum() <= 1
    with pytest.raises(ValueError, match="not the call's"):
        match_features(held, f0, (H, W), f1, (H, W), depth=2, device="cpu")


# --- the quickstart ---------------------------------------------------------

QS_H, QS_W, QS_MAP, QS_COVERAGE = 256, 320, 512, 2.2
QS_DRAWS = 16


def quickstart(pkg, query, ortho, dem, rotation_deg, k, aff, draws=1,
               **runner_kw):
    """``docs/quickstart.md``'s library example with ``pkg`` for
    ``gisnav_tpu``; ``draws`` frames of the same query (the JAX runner
    draws RANSAC from the frame number, so its later frames are its
    spread). Returns the poses and the f64 fixes."""
    runners = __import__(f"{pkg}.pipeline.runners", fromlist=["x"])
    geopose = __import__(f"{pkg}.pipeline.geopose", fromlist=["x"])
    runner = runners.make_cached_deep_runner(**runner_kw)
    out = []
    for _ in range(draws):
        pose = runner(query, ortho, dem, rotation_deg, k, aff, map_stamp=0)
        out.append((pose, geopose.geopose_to_wgs84_f64(pose, aff)
                    if pose.valid else None))
    return out


@pytest.fixture(scope="module")
def quickstart_fixes():
    s = render_scene(seed=4, h=QS_H, w=QS_W, yaws=[0.0], map_side=QS_MAP,
                     coverage=QS_COVERAGE)
    args = (s.frames[0], s.ortho, s.dem, 0.0, s.k, s.crs_affine)
    port = quickstart("gisnav_tpu_torch", *args, device="cpu")[0]
    ref = quickstart("gisnav_tpu", *args, draws=QS_DRAWS)
    return s, port, ref


def _dist(a, b):
    return (haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]),
            abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]))


def quickstart_readings(quickstart_fixes):
    s, (pose, fix), ref = quickstart_fixes
    (lon, lat), jfix = s.truth_lonlat[0], ref[0][1]
    spread = [max(_dist(a[1], b[1])[i] for a, b in itertools.combinations(
        [r for r in ref if r[1] is not None], 2)) for i in (0, 1)]
    return {"port_valid": bool(pose.valid), "jax_valid": bool(ref[0][0].valid),
            "port_vs_jax": _dist(fix, jfix) if fix and jfix else None,
            "jax_spread": spread,
            "port_error_m": fix and haversine_m(lat, lon, fix["lat"],
                                                fix["lon"]),
            "jax_error_m": jfix and haversine_m(lat, lon, jfix["lat"],
                                                jfix["lon"])}


def test_quickstart_vs_jax(quickstart_fixes):
    r = quickstart_readings(quickstart_fixes)
    assert r["port_valid"] and r["jax_valid"], r
    horiz, dalt = r["port_vs_jax"]
    assert horiz < max(2.5, r["jax_spread"][0]), r
    assert dalt < max(0.5, r["jax_spread"][1]), r
    assert r["port_error_m"] < 10.0 and r["jax_error_m"] < 10.0, r


def test_quickstart_config_is_the_default_bundle():
    from gisnav_tpu.pipeline import runners as jruns
    from gisnav_tpu_torch.pipeline import runners as truns

    assert dataclasses.asdict(truns.PRETRAINED_CONFIG) == \
        dataclasses.asdict(jruns.PRETRAINED_CONFIG)


if __name__ == "__main__":
    s = setup.__wrapped__()
    print("extract_features (port, jax, exact, near, descriptors, scores):",
          keypoint_shares(s))
    for depth, k1 in itertools.product((2, 9), (K, MODULE_K1)):
        print(f"match_features depth {depth} k1 {k1}:",
              match_agreement(s, depth, k1))
    print("quickstart:", quickstart_readings(quickstart_fixes.__wrapped__()))
