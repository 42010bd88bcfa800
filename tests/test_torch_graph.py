"""What makes a frame program capturable, held on the CPU.

- RANSAC's split draw (``draw_noise`` then the top 4 of ``probs / noise``)
  equals ``torch.multinomial`` without replacement for the same generator
  state, bit for bit, on several masks: random, empty (uniform), fewer
  than 4 valid entries, all valid.
- The frame programs with every input a tensor (the cached frame's prior
  as a (2,) and a () tensor, RANSAC's noise drawn ahead) equal the eager
  programs called as before (host prior values, the generator), bit for
  bit; and the cached frame with a prior against the JAX program with
  JAX's draws fed as ``sample_idx``, at ``tests/test_torch_pipeline.py``'s
  tolerance for a whole frame (2.5 m horizontally, 0.5 m in altitude;
  measured 0.248 / 1.015 m and 0.144 / 0.452 m).
- ``solve_ex`` / ``inv_ex`` (no ``info`` read on the host) give what
  ``solve`` / ``inv`` gave, bit for bit, on RANSAC's systems.
- ``FrameGraph`` on the CPU calls its function; its tree flattening and
  the packed output layout (every dtype a frame returns, 0-d tensors
  included) give back the outputs exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.pipeline import geopose as jgp
from gisnav_tpu.pipeline import runners as jruns
from gisnav_tpu_torch.geometry.crs import haversine_m
from gisnav_tpu_torch.pipeline import geopose as tgp
from gisnav_tpu_torch.pipeline import graph as tgraph
from gisnav_tpu_torch.pnp import ransac as tr
from gisnav_tpu_torch.utils.world import render_scene
from gisnav_tpu_torch.weights import load_bundled, params_from_jax

from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)


def _mask(kind, n, seed):
    if kind == "random":
        return torch.rand(n, generator=torch.Generator().manual_seed(
            100 + seed)) > 0.6
    mask = torch.zeros(n, dtype=torch.bool)
    if kind == "three":
        mask[[3, n // 2, n - 1]] = True
    elif kind == "full":
        mask[:] = True
    return mask


@pytest.mark.parametrize("n", [2048, 37])
@pytest.mark.parametrize("kind", ["random", "empty", "three", "full"])
def test_split_draw_equals_multinomial(kind, n):
    for seed in range(5):
        mask = _mask(kind, n, seed)
        probs = mask.float()
        if not bool(probs.sum() > 0):
            probs = torch.ones_like(probs)
        want = torch.multinomial(probs.expand(64, -1), 4, replacement=False,
                                 generator=torch.Generator().manual_seed(seed))
        got = tr.draw_samples(mask, 64, torch.Generator().manual_seed(seed))
        noise = tr.draw_noise(torch.Generator().manual_seed(seed), 64, n)
        assert torch.equal(got, want)
        assert torch.equal(tr.draw_samples(mask, 64, noise=noise), want)
        assert got.shape == (64, 4)
        if kind != "three":
            assert (got.sort(dim=1).values.diff(dim=1) > 0).all()


def test_solve_ex_and_inv_ex_equal_solve_and_inv():
    gen = torch.Generator().manual_seed(3)
    a = torch.randn((64, 8, 8), generator=gen)
    ata = a.transpose(-1, -2) @ a + 1e-8 * torch.eye(8)
    b = torch.randn((64, 8, 1), generator=gen)
    assert torch.equal(torch.linalg.solve_ex(ata, b,
                                             check_errors=False).result,
                       torch.linalg.solve(ata, b))
    j = torch.randn((40, 6), generator=gen)
    jtj = j.T @ j + 1e-6 * torch.eye(6)
    r = torch.randn((6,), generator=gen)
    assert torch.equal(torch.linalg.solve_ex(jtj, r,
                                             check_errors=False).result,
                       torch.linalg.solve(jtj, r))
    assert torch.equal(tr._solve(jtj, r), torch.linalg.solve(jtj, r))
    k = torch.tensor([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    assert torch.equal(torch.linalg.inv_ex(k, check_errors=False).inverse,
                       torch.linalg.inv(k))
    # and RANSAC's homographies through the module's own solve
    src = torch.rand((64, 4, 2), generator=gen)
    dst = src + 0.01 * torch.rand((64, 4, 2), generator=gen)
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    m = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], -2)
    mt = m.transpose(-1, -2)
    h = torch.linalg.solve(mt @ m + 1e-8 * torch.eye(8),
                           mt @ torch.cat([u, v], -1)[..., None])[..., 0]
    want = torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(-1, 3, 3)
    assert torch.equal(tr._homography_4pt(src, dst), want)


@pytest.fixture(scope="module")
def harris():
    s = render_scene(seed=6, h=480, w=640, yaws=[0.0, 90.0], map_side=800,
                     coverage=3.0, offset_m=22.2)
    params, cfg = load_bundled("harris_lg5")
    cfg = dataclasses.replace(cfg, ortho_shape=s.ortho.shape,
                              detector_downsample=2)
    models = tgp.build_models(params_from_jax(params), cfg)
    ref = tgp.build_reference_extractor(cfg)(
        models, torch.as_tensor(s.ortho.astype(np.float32)) / 255.0)
    return s, cfg, models, ref


def _equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def _prior(s, i, radius_px):
    lon, lat = s.truth_lonlat[i]
    aff = np.asarray(s.crs_affine, np.float64)
    xy = np.linalg.solve(aff[:2, :2], np.array([lon, lat]) - aff[:2, 3])
    return xy.astype(np.float32), radius_px


def test_tensor_input_cached_frame_equals_eager_frame(harris):
    s, cfg, models, ref = harris
    fn = tgp.build_frame_to_geopose_cached(cfg)
    f32 = np.float32
    args = (models, torch.as_tensor(s.frames[1].astype(f32)) / 255.0, ref,
            torch.as_tensor(s.dem), torch.as_tensor(s.k.astype(f32)),
            torch.as_tensor(s.crs_affine.astype(f32)))
    for xy, radius in ((np.zeros(2, f32), -1.0), _prior(s, 1, 150.0)):
        old = fn(*args, prior_xy=xy, prior_radius=radius,
                 generator=torch.Generator().manual_seed(7))
        new = fn(*args, prior_xy=torch.from_numpy(xy),
                 prior_radius=torch.tensor(radius, dtype=torch.float32),
                 noise=tr.draw_noise(torch.Generator().manual_seed(7),
                                     cfg.num_hypotheses, cfg.max_keypoints))
        _equal(new, old)
        assert bool(new.valid)


def test_noise_input_warpcached_frame_equals_eager_frame(harris):
    s, cfg, models, _ = harris
    cfg = dataclasses.replace(cfg, detector_downsample=1)
    extract = tgp.build_warp_reference_extractor(cfg)
    f32 = np.float32
    zoom = s.alt_m / s.k[0, 0] / abs(s.crs_affine[2, 2])
    feats, dem, m_crop = extract(
        models, torch.as_tensor(s.ortho.astype(f32)) / 255.0,
        torch.as_tensor(s.dem), 0.0, float(f32(zoom)))
    fn = tgp.build_frame_to_geopose_warpcached(cfg)
    args = (models, torch.as_tensor(s.frames[0].astype(f32)) / 255.0, feats,
            dem, m_crop, torch.as_tensor(s.k.astype(f32)),
            torch.as_tensor(s.crs_affine.astype(f32)))
    old = fn(*args, generator=torch.Generator().manual_seed(11))
    new = fn(*args, noise=tr.draw_noise(torch.Generator().manual_seed(11),
                                        cfg.num_hypotheses,
                                        cfg.max_keypoints))
    _equal(new, old)
    assert bool(new.valid)


def test_tensor_prior_cached_frame_vs_jax(harris):
    s, cfg, models, ref = harris
    j_params, j_cfg = jruns.load_bundled("harris_lg5")
    j_cfg = dataclasses.replace(j_cfg, ortho_shape=s.ortho.shape,
                                detector_downsample=2)
    j_ref = jax.jit(jgp.build_reference_extractor(j_cfg))(
        j_params, jnp.asarray(s.ortho, jnp.float32) / 255.0)
    j_fn = jax.jit(jgp.build_frame_to_geopose_cached(j_cfg))
    fn = tgp.build_frame_to_geopose_cached(cfg)
    k32, aff32 = (np.asarray(a, np.float32) for a in (s.k, s.crs_affine))
    for i in (0, 1):
        xy, radius = _prior(s, i, 150.0)
        q = s.frames[i].astype(np.float32) / 255.0
        key = jax.random.PRNGKey(i + 1)
        r = j_fn(j_params, jnp.asarray(q), j_ref, jnp.asarray(s.dem),
                 jnp.asarray(k32), jnp.asarray(aff32), key,
                 jnp.asarray(xy), jnp.float32(radius))
        p = fn(models, torch.as_tensor(q), ref, torch.as_tensor(s.dem),
               torch.as_tensor(k32), torch.as_tensor(aff32),
               prior_xy=torch.from_numpy(xy),
               prior_radius=torch.tensor(radius, dtype=torch.float32),
               sample_idx=lambda mask, _: jax_ransac_sample(key,
                                                            mask.numpy()))
        pf = tgp.geopose_to_wgs84_f64(p, s.crs_affine)
        rf = jgp.geopose_to_wgs84_f64(r, s.crs_affine)
        horiz = haversine_m(pf["lat"], pf["lon"], rf["lat"], rf["lon"])
        dalt = abs(pf["alt_ellipsoid"] - rf["alt_ellipsoid"])
        print(f"frame {i} with a prior: port-vs-JAX {horiz:.3f} m, "
              f"{dalt:.3f} m alt; matches {int(p.num_matches)}/"
              f"{int(r.num_matches)}")
        assert bool(p.valid) and bool(r.valid)
        assert horiz < 2.5 and dalt < 0.5


def test_frame_graph_on_the_cpu_calls_its_function():
    calls = []

    def fn(a, pair):
        calls.append(1)
        return {"sum": a + pair[0], "pose": (pair[1] > 0, a.sum())}

    g = tgraph.FrameGraph(fn, "cpu", sticky=(1,))
    a, pair = torch.ones(3), (torch.arange(3.0), torch.tensor([-1, 2, 3]))
    out = g(a, pair)
    assert calls == [1] and g.launches == {} and g.capture_ms is None
    assert torch.equal(out["sum"], torch.tensor([1.0, 2, 3]))


def test_flatten_and_packed_layout_give_outputs_back():
    pose = tgp.GeoPose(
        ecef_position=torch.tensor([1.5, -2.0, 3.25]),
        ecef_quat=torch.rand(4), lon_lat_alt=torch.rand(3),
        r_raster=torch.rand(3, 3), cam_pos_raster=torch.rand(3),
        m_crop=torch.eye(3), num_matches=torch.tensor(17),
        num_inliers=torch.tensor(12, dtype=torch.int32),
        valid=torch.tensor(True), matched_qry=torch.rand(5, 2),
        matched_ref=torch.rand(5, 2),
        match_mask=torch.tensor([True, False, True, True, False]))
    tree = (pose, [torch.arange(7, dtype=torch.int16)],
            {"z": torch.zeros(0)})
    leaves, spec = tgraph._flatten(tree)
    assert len(leaves) == 14
    back = tgraph._unflatten(spec, leaves)
    assert isinstance(back[0], tgp.GeoPose) and isinstance(back[1], list)
    g = tgraph.FrameGraph(lambda: None, "cpu")
    g._pack(tree)
    assert all(off % 16 == 0 for off, *_ in g._layout)
    packed = g._packed.clone()
    out = tgraph._unflatten(g._out_spec, [
        packed[off:off + size].view(dtype).view(shape)
        for off, size, dtype, shape in g._layout])
    for x, y in zip(tgraph._flatten(out)[0], leaves):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    with pytest.raises(TypeError, match="tensors"):
        tgraph._flatten((torch.ones(1), 2.0))

