"""The port's semi-dense mode (LoFTR) against the JAX package's, with the
bundled ``loftr`` weights on the CPU. Both run in f32.

- ``_sine_pos_encoding`` and ``_linear_attention`` to 1e-6 (sin/cos/exp
  of another library differ by an ulp);
- the backbone's fine (1/2) and coarse (1/8) maps at 64x80 and 96x128, to
  1e-5 absolute on values of order 1 (measured 1.7e-6): a stride-2 conv
  padded (1, 1) where flax's ``SAME`` pads (0, 1) shifts every cell by half
  a pixel and fails this by orders of magnitude;
- the whole matcher at 96x128 with 64 matches: the valid matches
  (confidence > 0.2) as sets of coarse cells, their confidences to 1e-5
  and the refined ``kp1`` of shared matches to 1e-3 px (the tail of
  zero-score, non-mutual cells is ordered differently by ``jax.lax.top_k``
  and ``torch.topk``, so slots are not compared one by one);
- the semi-dense runner (and through it the frame program) on two frames of
  a 128x256 scene against the JAX runner, the port drawing the JAX
  runner's RANSAC samples: the same match sets, the fix within 1 cm
  horizontally and in altitude (same matches, same draw: the rest is f32
  rounding in the warp and the solver);
- the semi-dense runners at full width on four frames of the scene of
  ``chip_smoke.py`` path 4, each with its own draw: the same validity and
  match counts, fixes within 1 cm;
- ``init_semidense_params``: the keys and shapes of the JAX init, flax's
  initialisers' statistics, and the runner's fall-back to it without the
  bundle file.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.matching import loftr as jl
from gisnav_tpu.pipeline import geopose as jgp
from gisnav_tpu.pipeline import runners as jruns
from gisnav_tpu_torch import weights as tw
from gisnav_tpu_torch.geometry.crs import haversine_m
from gisnav_tpu_torch.matching import loftr as tl
from gisnav_tpu_torch.pipeline import geopose as tgp
from gisnav_tpu_torch.pipeline import runners as truns
from gisnav_tpu_torch.utils.world import render_scene

from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


@pytest.fixture(scope="module")
def bundle():
    tree, cfg = tw.load_bundled("loftr")
    return tree, tw.params_from_jax(tree)["loftr"], cfg


def test_sine_pos_encoding_vs_jax():
    for h, w, dim in ((12, 16, 256), (8, 10, 64)):
        np.testing.assert_allclose(
            tl._sine_pos_encoding(h, w, dim).numpy(),
            np.asarray(jl._sine_pos_encoding(h, w, dim)), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tl._sine_pos_encoding(4, 4, 30)


def test_linear_attention_vs_jax():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((n, 8, 32)).astype(np.float32)
               for n in (100, 120, 120))
    got = tl._linear_attention(*map(torch.as_tensor, (q, k, v))).numpy()
    want = np.asarray(jl._linear_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_params_from_jax_loftr_layout(bundle):
    tree, port, _ = bundle
    jt = tree["loftr"]["params"]
    stem = port["backbone"]["stem"]["weight"]
    assert stem.dtype == torch.float32 and tuple(stem.shape) == (64, 1, 3, 3)
    np.testing.assert_array_equal(
        port["backbone"]["c3"]["weight"].numpy(),
        np.transpose(jt["backbone"]["c3"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(port["self_2"]["fc1"]["weight"].numpy(),
                                  jt["self_2"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(port["cross_3"]["norm2"]["weight"].numpy(),
                                  jt["cross_3"]["norm2"]["scale"])


@pytest.mark.parametrize("shape", [(64, 80), (96, 128)])
def test_backbone_vs_jax(bundle, shape):
    tree, port, _ = bundle
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    fine, coarse = tl._Backbone(port["backbone"])(torch.as_tensor(img))
    j_fine, j_coarse = jl._Backbone().apply(
        {"params": tree["loftr"]["params"]["backbone"]}, jnp.asarray(img))
    h, w = shape
    assert fine.shape == (h // 2, w // 2, 128)
    assert coarse.shape == (h // 8, w // 8, 256)
    np.testing.assert_allclose(fine.numpy(), np.asarray(j_fine), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(j_coarse), rtol=0,
                               atol=1e-5)


def test_block_vs_jax(bundle):
    tree, port, _ = bundle
    rng = np.random.default_rng(2)
    x, src = (rng.standard_normal((n, 256)).astype(np.float32)
              for n in (96, 80))
    got = tl._LoFTRBlock(port["cross_1"], 256, 8)(torch.as_tensor(x),
                                                  torch.as_tensor(src))
    want = jl._LoFTRBlock(256, 8).apply(
        {"params": tree["loftr"]["params"]["cross_1"]}, jnp.asarray(x),
        jnp.asarray(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_loftr_matches_vs_jax(bundle):
    tree, port, _ = bundle
    s = render_scene(seed=4, h=96, w=128, yaws=[0.0], map_side=128,
                     coverage=1.0)
    img0 = s.frames[0].astype(np.float32) / 255.0
    img1 = s.ortho[16:112].astype(np.float32) / 255.0
    got = tl.LoFTR(port, max_matches=64)(torch.as_tensor(img0),
                                         torch.as_tensor(img1))
    want = jl.LoFTR(max_matches=64).apply(tree["loftr"], jnp.asarray(img0),
                                          jnp.asarray(img1))
    for name in ("kp0", "kp1", "confidence", "mask"):
        assert getattr(got, name).shape == np.asarray(
            getattr(want, name)).shape
    gm, wm = got.mask.numpy(), np.asarray(want.mask)
    print(f"valid matches: port {gm.sum()}, JAX {wm.sum()}")
    assert wm.sum() >= 32
    port_cells = {tuple(p): i for i, p in enumerate(got.kp0.numpy())
                  if gm[i]}
    jax_cells = {tuple(p): i for i, p in enumerate(np.asarray(want.kp0))
                 if wm[i]}
    assert port_cells.keys() == jax_cells.keys()
    for cell, j in jax_cells.items():
        i = port_cells[cell]
        assert float(got.confidence[i]) == pytest.approx(
            float(want.confidence[j]), abs=1e-5)
        np.testing.assert_allclose(got.kp1[i].numpy(),
                                   np.asarray(want.kp1[j]), rtol=0,
                                   atol=1e-3)


H, W, K = 128, 256, 256


def test_semidense_runner_vs_jax_runner(bundle):
    tree, _, cfg = bundle
    cfg = dataclasses.replace(cfg, image_shape=(H, W), max_keypoints=K)
    scene = render_scene(seed=4, h=H, w=W, yaws=[0.0, 30.0])
    frames = itertools.count(1)

    def with_jax_draw(config):
        fn = tgp.build_frame_to_geopose_semidense(config)

        def run(*args, **kw):
            key = jax.random.PRNGKey(next(frames))
            kw["sample_idx"] = lambda mask, _: jax_ransac_sample(
                key, mask.cpu().numpy())
            return fn(*args, **kw)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(truns, "build_frame_to_geopose_semidense", with_jax_draw)
        port = truns.make_semidense_runner(tree, cfg, device="cpu")
    ref = jruns.make_semidense_runner(tree, cfg)
    for i, (lon, lat) in enumerate(scene.truth_lonlat):
        args = (scene.frames[i], scene.ortho, scene.dem, scene.yaws[i],
                scene.k, scene.crs_affine)
        p = port(*args, map_stamp=1, altitude_agl=scene.alt_m)
        r = ref(*args, map_stamp=1, altitude_agl=scene.alt_m)
        pf = tgp.geopose_to_wgs84_f64(p, scene.crs_affine)
        rf = jgp.geopose_to_wgs84_f64(r, scene.crs_affine)
        horiz = haversine_m(pf["lat"], pf["lon"], rf["lat"], rf["lon"])
        dalt = abs(pf["alt_ellipsoid"] - rf["alt_ellipsoid"])
        truth = haversine_m(lat, lon, pf["lat"], pf["lon"])
        print(f"frame {i}: port-vs-JAX {horiz:.4f} m, altitude {dalt:.4f} m;"
              f" matches {int(p.num_matches)}/{int(r.num_matches)}, inliers "
              f"{int(p.num_inliers)}/{int(r.num_inliers)}; truth {truth:.2f}"
              f" m")
        assert bool(p.valid) and bool(r.valid)
        assert int(p.num_matches) == int(r.num_matches)
        pm, rm = p.match_mask.numpy(), np.asarray(r.match_mask)
        assert sorted(map(tuple, p.matched_qry.numpy()[pm])) == sorted(
            map(tuple, np.asarray(r.matched_qry)[rm]))
        assert horiz < 0.01 and dalt < 0.01, (horiz, dalt)
        assert truth < 10.0


def test_semidense_runner_on_the_harris_scene(bundle):
    """Full width (480x640, 1024 matches) on the first four frames of the
    scene of ``chip_smoke.py`` path 4, both runners with the bundle and
    their own draws: the JAX runner localizes frames 1-3 under 10 m and
    finds 12 matches on frame 0, under ``min_matches`` (which path 5 holds
    the card run to); the port gives the same validity and match counts
    and fixes within 1 cm of the JAX ones (measured under 0.4 mm)."""
    tree, _, _ = bundle
    scene = render_scene(seed=6, h=480, w=640, yaws=[0.0, 45.0, 90.0, 135.0],
                         map_side=800, coverage=3.0, offset_m=22.2)
    port = truns.make_semidense_runner(tree, device="cpu")
    ref = jruns.make_semidense_runner(tree)
    valid = []
    for i, (lon, lat) in enumerate(scene.truth_lonlat):
        args = (scene.frames[i], scene.ortho, scene.dem, scene.yaws[i],
                scene.k, scene.crs_affine)
        p = port(*args, map_stamp=1, altitude_agl=scene.alt_m)
        r = ref(*args, map_stamp=1, altitude_agl=scene.alt_m)
        pf = tgp.geopose_to_wgs84_f64(p, scene.crs_affine)
        rf = jgp.geopose_to_wgs84_f64(r, scene.crs_affine)
        truth = haversine_m(lat, lon, rf["lat"], rf["lon"])
        print(f"frame {i}: JAX valid={bool(r.valid)} matches "
              f"{int(r.num_matches)} truth {truth:.3f} m; port "
              f"valid={bool(p.valid)} matches {int(p.num_matches)}")
        assert bool(p.valid) == bool(r.valid)
        assert int(p.num_matches) == int(r.num_matches)
        assert haversine_m(pf["lat"], pf["lon"], rf["lat"], rf["lon"]) < 0.01
        valid.append(bool(r.valid) and truth < 10.0)
    assert valid == [False, True, True, True]


def test_init_semidense_params_vs_jax_init():
    cfg = dataclasses.replace(truns.SEMIDENSE_CONFIG, image_shape=(32, 32),
                              max_keypoints=16)
    got = _flatten(tgp.init_semidense_params(
        torch.Generator().manual_seed(0), cfg))
    want = _flatten(jax.tree.map(np.asarray, jgp.init_semidense_params(
        jax.random.PRNGKey(0), cfg)))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32
    for key, value in got.items():
        if key.endswith("/scale"):
            assert (value == 1).all()
        elif key.endswith("/bias"):
            assert (value == 0).all()
    # lecun_normal: std sqrt(1 / fan_in) after truncation at 2 std
    k = got["loftr/params/self_0/fc1/kernel"]
    assert abs(float(k.std()) * np.sqrt(512) - 1.0) < 0.02
    assert np.abs(k).max() <= 2 / np.sqrt(512) / 0.87962566103423978
    again = _flatten(tgp.init_semidense_params(
        torch.Generator().manual_seed(0), cfg))
    assert all(np.array_equal(got[k], again[k]) for k in got)


def test_semidense_runner_defaults(monkeypatch, tmp_path):
    """``params=None`` loads the bundle, or draws the init where the file
    is missing; ``config=None`` is ``SEMIDENSE_CONFIG``."""
    captured = []
    real = tgp.build_models

    def spy(params, config):
        captured.append((params, config))
        return real(params, config)

    monkeypatch.setattr(truns, "build_models", spy)
    truns.make_semidense_runner(device="cpu")
    params, config = captured[-1]
    assert dataclasses.asdict(config) == dataclasses.asdict(
        jruns.SEMIDENSE_CONFIG)
    bundled = tw.params_from_jax(tw.load_bundled("loftr")[0])["loftr"]
    assert torch.equal(params["loftr"]["backbone"]["c3"]["weight"],
                       bundled["backbone"]["c3"]["weight"])
    monkeypatch.setattr(tw, "LOFTR_PATH", str(tmp_path / "missing.npz"))
    truns.make_semidense_runner(seed=3, device="cpu")
    params, _ = captured[-1]
    assert not torch.equal(params["loftr"]["backbone"]["c3"]["weight"],
                           bundled["backbone"]["c3"]["weight"])
    assert (params["loftr"]["self_0"]["norm1"]["weight"] == 1).all()
