"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
The module imports neither JAX nor the JAX package, so it runs on a machine
with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as ``chip_smoke.py`` states them (the conv and attention kernels
also give the same bits on a second run): conv bf16 outputs 2 ulp + 0.05
(sums in another order round to neighbouring bf16s), NMS cell maxima exact
and positions 1e-4 px, the LightGlue block 5e-2 on f32 outputs, the masked
attention 1e-2 of the largest |output| (on unit-normal and on sharpened
queries), the shear (both entries, and the rotation built on them) bit for
bit, the NMS cell max exact.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gisnav_tpu_torch.device import strict_fp32

    strict_fp32()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _conv_w(gen, cin, cout):
    w = torch.randn((9, cin, cout), generator=gen, device="cuda")
    w = (w * (2.0 / (9 * cin)) ** 0.5).to(torch.bfloat16)
    return w, 0.05 * torch.randn((cout,), generator=gen, device="cuda")


def _close_bf16(got, want):
    got, want = got.float(), want.float()
    assert not ((got - want).abs() > 0.05 + 2.0 ** -7 * want.abs()).any()


@pytest.mark.parametrize("cin,cmid,cout,pool", [
    (64, 64, 64, True), (64, 128, 128, True), (128, 128, 128, False),
    (128, 256, None, False)])
def test_conv_stage_kernel(card, cin, cmid, cout, pool):
    from gisnav_tpu_torch.features.conv import conv_stage, conv_stage_plain

    x = torch.rand((48, 80, cin), generator=card, device="cuda").to(
        torch.bfloat16)
    w1, b1 = _conv_w(card, cin, cmid)
    w2, b2 = _conv_w(card, cmid, cout) if cout else (None, None)
    _close_bf16(conv_stage(x, w1, b1, w2, b2, pool=pool),
                conv_stage_plain(x, w1, b1, w2, b2, pool=pool))


# the trunk's path shapes (chip_smoke.CONV_SHAPES) and one whose height and
# width are no multiple of the kernel's 8x16 pixel tile, pool on and off
CONV_CASES = [
    (544, 960, 64, 64, 64, True), (272, 480, 64, 128, 128, True),
    (136, 240, 128, 128, 128, False), (136, 240, 128, 256, None, False),
    (34, 60, 64, 64, None, True), (34, 60, 64, 128, None, False),
    (34, 60, 128, 256, None, True), (34, 60, 128, 64, 64, False),
    # harris_lg5 (chip_smoke.py path 4): the 480x640 frame's stages, the
    # cached mode's 240x320 pooled query down to 30x40, and the 800 map's
    (240, 320, 64, 64, 64, True), (60, 80, 128, 128, 128, False),
    (30, 40, 128, 128, 128, False), (30, 40, 128, 256, None, False),
    (400, 400, 64, 64, 64, True), (100, 100, 128, 256, None, False),
]


@pytest.mark.parametrize("h,w,cin,cmid,cout,pool", CONV_CASES)
def test_conv_stage_kernel_path_shapes_and_edges(card, h, w, cin, cmid, cout,
                                                 pool):
    from gisnav_tpu_torch.features.conv import conv_stage, conv_stage_plain

    x = torch.rand((h, w, cin), generator=card, device="cuda").to(
        torch.bfloat16)
    w1, b1 = _conv_w(card, cin, cmid)
    w2, b2 = _conv_w(card, cmid, cout) if cout else (None, None)
    got = conv_stage(x, w1, b1, w2, b2, pool=pool)
    assert got.shape == ((h // 2, w // 2) if pool else (h, w)) + (
        cout or cmid,)
    _close_bf16(got, conv_stage_plain(x, w1, b1, w2, b2, pool=pool))
    # no atomics, a fixed order of sums: the same bits on a second run
    assert torch.equal(got, conv_stage(x, w1, b1, w2, b2, pool=pool))


def test_stem_stage_kernel_full_frame(card):
    """The frame's size, in one launch: conv1a inside conv1b's patch."""
    from gisnav_tpu_torch.features.conv import stem_stage, stem_stage_plain
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    img = torch.rand((1088, 1920), generator=card, device="cuda")
    args = (*_conv_w(card, 1, 64), *_conv_w(card, 64, 64))
    reset_launches()
    got = stem_stage(img, *args)
    assert LAUNCHES["stem_stage"] == 1
    _close_bf16(got, stem_stage_plain(img, *args))
    assert torch.equal(got, stem_stage(img, *args))


# the frame, a square map, and two ragged even sizes (the CPU tests hold the
# plain version against the JAX reference at these): edge tiles partly
# outside the image, where conv1a's image padding and conv1b's patch padding
# are two different conditions
STEM_CASES = [(1088, 1920), (2048, 2048), (36, 52), (18, 34),
              (480, 640), (240, 320), (800, 800)]


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("h,w", STEM_CASES)
def test_stem_stage_kernel_sizes(card, h, w, pool):
    from gisnav_tpu_torch.features.conv import stem_stage, stem_stage_plain

    img = torch.rand((h, w), generator=card, device="cuda")
    args = (*_conv_w(card, 1, 64), *_conv_w(card, 64, 64))
    got = stem_stage(img, *args, pool=pool)
    assert got.shape == ((h // 2, w // 2) if pool else (h, w)) + (64,)
    _close_bf16(got, stem_stage_plain(img, *args, pool=pool))
    assert torch.equal(got, stem_stage(img, *args, pool=pool))


def test_conv_kernel_refuses_other_channel_counts(card):
    from gisnav_tpu_torch.features.conv import conv_stage

    x = torch.rand((16, 16, 32), generator=card, device="cuda").to(
        torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported conv shape"):
        conv_stage(x, *_conv_w(card, 32, 64))


def test_stem_stage_kernel(card):
    from gisnav_tpu_torch.features.conv import stem_stage, stem_stage_plain

    img = torch.rand((64, 96), generator=card, device="cuda")
    args = (*_conv_w(card, 1, 64), *_conv_w(card, 64, 64))
    _close_bf16(stem_stage(img, *args), stem_stage_plain(img, *args))


def test_nms_select_kernel(card):
    from gisnav_tpu_torch.features.nms_kernel import (
        nms_select,
        nms_select_plain,
    )

    heat = torch.rand((100, 260), generator=card, device="cuda") ** 8
    got, want = nms_select(heat, 4), nms_select_plain(heat, 4)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sets,cross", [(1, False), (2, False), (2, True)])
def test_fused_block_kernel(card, sets, cross):
    from gisnav_tpu_torch.matching.lightglue_fused import (
        fused_block,
        fused_block_plain,
    )

    n, dim = 256, 256

    def r(shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=card, device="cuda")
                ).to(dtype).contiguous()

    bf = torch.bfloat16
    x = r((sets * n, dim))
    q, k, v = (r((sets * n, dim), 1.0, bf) for _ in range(3))
    bias = torch.where(torch.rand((sets, n), generator=card, device="cuda")
                       < 0.9, 0.0, -1e9).float()
    w = [r((dim, dim), dim ** -0.5, bf), r((dim,), 0.05),
         r((dim, 2 * dim), (2 * dim) ** -0.5, bf),
         r((dim, 2 * dim), (2 * dim) ** -0.5, bf), r((2 * dim,), 0.05),
         1.0 + r((2 * dim,), 0.1), r((2 * dim,), 0.1),
         r((2 * dim, dim), (2 * dim) ** -0.5, bf), r((dim,), 0.05)]
    kw = dict(heads=4, sets=sets, cross=cross)
    torch.testing.assert_close(fused_block(x, q, k, v, bias, *w, **kw),
                               fused_block_plain(x, q, k, v, bias, *w, **kw),
                               rtol=0, atol=5e-2)


# chip_smoke.check_block's six cases: the dual self and cross stage at 2x2048
# keypoints and the cached path's one-stream calls
BLOCK_CASES = [(4096, 4096, 2, False), (4096, 4096, 2, True),
               (2048, 2048, 1, False), (2048, 4096, 1, False),
               (4096, 2048, 1, False), (4096, 4096, 1, False),
               # harris_lg5: dual 2x512 (warp modes) and the cached mode's
               # one-stream calls at 512 query x 1024 map keypoints
               (1024, 1024, 2, False), (1024, 1024, 2, True),
               (512, 512, 1, False), (512, 1024, 1, False),
               (1024, 512, 1, False), (1024, 1024, 1, False)]


@pytest.mark.parametrize("n,kk_total,sets,cross", BLOCK_CASES)
def test_fused_block_kernel_path_shapes(card, n, kk_total, sets, cross):
    """Against the plain version at 5e-2, bit-equal on a second run (the
    key split's merge runs in split order over a cluster, no atomics), two
    launches a call."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.matching.lightglue_fused import (
        fused_block,
        fused_block_plain,
    )

    dim, bf = 256, torch.bfloat16

    def r(shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=card, device="cuda")
                ).to(dtype).contiguous()

    x = r((n, dim))
    q = r((n, dim), 1.0, bf)
    k, v = (r((kk_total, dim), 1.0, bf) for _ in range(2))
    bias = torch.where(torch.rand((sets, kk_total // sets), generator=card,
                                  device="cuda") < 0.9, 0.0, -1e9).float()
    w = [r((dim, dim), dim ** -0.5, bf), r((dim,), 0.05),
         r((dim, 2 * dim), (2 * dim) ** -0.5, bf),
         r((dim, 2 * dim), (2 * dim) ** -0.5, bf), r((2 * dim,), 0.05),
         1.0 + r((2 * dim,), 0.1), r((2 * dim,), 0.1),
         r((2 * dim, dim), (2 * dim) ** -0.5, bf), r((dim,), 0.05)]
    kw = dict(heads=4, sets=sets, cross=cross)
    reset_launches()
    got = fused_block(x, q, k, v, bias, *w, **kw)
    assert LAUNCHES["fused_block"] == 2  # attention, epilogue
    torch.testing.assert_close(got, fused_block_plain(x, q, k, v, bias, *w,
                                                      **kw),
                               rtol=0, atol=5e-2)
    assert torch.equal(got, fused_block(x, q, k, v, bias, *w, **kw))


def test_runner_on_card_goes_through_every_kernel(card):
    import dataclasses

    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_bucketed_warp_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled

    scene = render_scene(seed=4, h=128, w=256, yaws=[0.0])
    params, cfg = load_bundled("learned_lg9")
    cfg = dataclasses.replace(cfg, image_shape=(128, 256), max_keypoints=512)
    runner = make_bucketed_warp_runner(params, cfg)
    reset_launches()
    pose = runner(scene.frames[0], scene.ortho, scene.dem, 0.0, scene.k,
                  scene.crs_affine, map_stamp=1, altitude_agl=scene.alt_m)
    assert bool(pose.valid)
    assert np.isfinite(pose.lon_lat_alt.cpu().numpy()).all()
    assert LAUNCHES == {"stem_stage": 2, "conv_stage": 16, "nms_select": 2,
                        "fused_block": 36, "masked_attention": 0,
                        "shear_last_axis": 0, "shear_first_axis": 0,
                        "nms_cellmax": 0}


@pytest.mark.parametrize("sharp", [1.0, 4.0])
@pytest.mark.parametrize("kq,kk,d", [(256, 128, 32), (256, 384, 64),
                                     (512, 256, 128), (768, 1536, 64),
                                     (768, 768, 64), (1536, 768, 64)])
def test_masked_attention_kernel(card, kq, kk, d, sharp):
    from gisnav_tpu_torch.matching.attention import (
        masked_attention,
        masked_attention_plain,
    )

    q, k, v = (torch.randn((n, 4, d), generator=card, device="cuda")
               for n in (kq, kk, kk))
    q = q * sharp
    mask = torch.rand((kk,), generator=card, device="cuda") > 0.33
    got = masked_attention(q, k, v, mask)
    assert got.dtype == torch.float32 and got.shape == (kq, 4, d)
    want = masked_attention_plain(q, k, v, mask)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-2 * float(want.abs().max()))
    with pytest.raises(ValueError, match="unsupported"):
        masked_attention(q[:100], k, v, mask)


# the module route's four shapes, the smallest supported one, D = 32 / 128
ATTENTION_CASES = [(1792, 1792, 64), (3584, 3584, 64), (1792, 3584, 64),
                   (3584, 1792, 64), (256, 128, 64), (256, 128, 32),
                   (512, 384, 32), (256, 128, 128), (512, 640, 128)]


@pytest.mark.parametrize("sharp", [1.0, 4.0])
@pytest.mark.parametrize("one_key", [False, True])
@pytest.mark.parametrize("kq,kk,d", ATTENTION_CASES)
def test_masked_attention_kernel_path_shapes(card, kq, kk, d, one_key, sharp):
    """Against the plain version at 1e-2 of its largest |output|, on a random
    mask and with all keys but one masked (every row is then that key's
    value), and bit-equal on a second run (no atomics, sums in split
    order)."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.matching.attention import (
        masked_attention,
        masked_attention_plain,
    )

    q, k, v = (torch.randn((n, 4, d), generator=card, device="cuda")
               for n in (kq, kk, kk))
    q = q * sharp
    if one_key:
        mask = torch.zeros((kk,), dtype=torch.bool, device="cuda")
        mask[kk // 3] = True
    else:
        mask = torch.rand((kk,), generator=card, device="cuda") > 0.33
    reset_launches()
    got = masked_attention(q, k, v, mask)
    assert LAUNCHES["masked_attention"] == 2  # statistics, then P.V
    want = masked_attention_plain(q, k, v, mask)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-2 * float(want.abs().max()))
    if one_key:
        only = v[kk // 3].to(torch.bfloat16).float()
        assert torch.equal(got, only[None].expand(kq, 4, d))
    assert torch.equal(got, masked_attention(q, k, v, mask))


@pytest.mark.parametrize("shift", [0.41, -0.70, 0.0])
def test_shear_kernel(card, shift):
    from gisnav_tpu_torch.raster.shear_kernel import (
        shear_last_axis,
        shear_last_axis_plain,
    )

    img = torch.rand((2, 256, 384), generator=card, device="cuda")
    assert torch.equal(shear_last_axis(img, shift, 128.0),
                       shear_last_axis_plain(img, shift, 128.0))
    with pytest.raises(ValueError, match="128"):
        shear_last_axis(img[:, :, :256].contiguous(), shift, 128.0)


def test_shear_rotation_of_unsupported_side_raises_on_card(card):
    """A stack on the card never takes the plain shear: a side the kernel
    does not serve raises, and the routing takes the gather for it."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.raster import rotate_and_crop_auto
    from gisnav_tpu_torch.raster.shear import rotate_and_crop_center_shear

    stack = torch.rand((100, 100, 1), generator=card, device="cuda")
    with pytest.raises(ValueError, match="128"):
        rotate_and_crop_center_shear(stack, 20.0, (40, 60))
    reset_launches()
    crop, _ = rotate_and_crop_auto(stack, 20.0, (40, 60))
    assert crop.shape == (40, 60, 1) and LAUNCHES["shear_last_axis"] == 0
    assert LAUNCHES["shear_first_axis"] == 0


def test_nms_cellmax_kernel(card):
    from gisnav_tpu_torch.features.nms_kernel import (
        nms_cellmax,
        nms_cellmax_plain,
        nms_select,
    )

    heat = torch.rand((96, 384), generator=card, device="cuda") ** 8
    got = nms_cellmax(heat, 4)
    assert torch.equal(got, nms_cellmax_plain(heat, 4))
    assert torch.equal(got, nms_select(heat, 4)[0])


def _small_scene(**kw):
    import dataclasses

    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled

    params, cfg = load_bundled("learned_lg9")
    return params, dataclasses.replace(
        cfg, image_shape=(256, 320)), render_scene(
            seed=4, h=256, w=320, yaws=[20.0], **kw)


@pytest.mark.parametrize("kp,kernel,count", [
    (512, "fused_block", 72), (256, "masked_attention", 72)])
def test_cached_runner_on_card_launches(card, kp, kernel, count):
    """512 / 1024 keypoints take the fused route one stream at a time, 256 /
    512 the module route with the attention kernel (36 calls of two
    launches)."""
    import dataclasses

    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner

    params, cfg, s = _small_scene(map_side=512, coverage=2.2)
    runner = make_cached_deep_runner(
        params, dataclasses.replace(cfg, max_keypoints=kp))
    args = (s.frames[0], s.ortho, s.dem, 20.0, s.k, s.crs_affine)
    runner(*args, map_stamp=1, altitude_agl=s.alt_m)
    reset_launches()
    pose = runner(*args, map_stamp=1, altitude_agl=s.alt_m)
    assert np.isfinite(pose.lon_lat_alt.cpu().numpy()).all()
    assert runner.stats == {"frames": 2, "map_extractions": 1}
    want = {"stem_stage": 1, "conv_stage": 8, "nms_select": 1, kernel: count}
    assert LAUNCHES == {k: want.get(k, 0) for k in LAUNCHES}


def test_exact_warp_on_card_launches(card):
    """The runner passes a zoom (gather warp); the frame program without a
    zoom on a square 384 map takes the 3-shear rotation: 3 shear launches,
    two along the last axis and one along the first."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose,
        build_models,
    )
    from gisnav_tpu_torch.pipeline.runners import make_deep_runner
    from gisnav_tpu_torch.weights import params_from_jax

    params, cfg, s = _small_scene(map_side=384, coverage=384 / 320)
    runner = make_deep_runner(params, cfg)
    args = (s.frames[0], s.ortho, s.dem, 20.0, s.k, s.crs_affine)
    reset_launches()
    pose = runner(*args, map_stamp=1, altitude_agl=s.alt_m)
    assert bool(pose.valid)
    pair = {"stem_stage": 2, "conv_stage": 16, "nms_select": 2,
            "fused_block": 36}
    assert LAUNCHES == {k: pair.get(k, 0) for k in LAUNCHES}

    dev = torch.device("cuda")
    models = build_models(params_from_jax(params, dev), cfg)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    reset_launches()
    pose = build_frame_to_geopose(cfg)(
        models, f32(s.frames[0]) / 255.0, f32(s.ortho) / 255.0, f32(s.dem),
        20.0, f32(s.k), f32(s.crs_affine),
        generator=torch.Generator(device=dev).manual_seed(1))
    assert bool(pose.valid)
    shears = {"shear_last_axis": 2, "shear_first_axis": 1}
    assert LAUNCHES == {k: {**pair, **shears}.get(k, 0) for k in LAUNCHES}


def _hold_nms_select(heat):
    """K3 against its plain version: cell max exact, positions 1e-4 px."""
    from gisnav_tpu_torch.features.nms_kernel import (
        nms_select,
        nms_select_plain,
    )

    got, want = nms_select(heat, 4), nms_select_plain(heat, 4)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    return got


@pytest.mark.parametrize("h,w", [(36, 52), (100, 132), (68, 200),
                                 (1088, 1920)])
def test_nms_select_kernel_ragged(card, h, w):
    """One partial tile, partial tiles on both edges, W = 200 (a multiple of
    neither 128 nor the 32x128 tile), and the frame."""
    _hold_nms_select(torch.rand((h, w), generator=card, device="cuda") ** 8)


def test_nms_select_kernel_ties_across_tile_borders(card):
    """Equal maxima on both sides of a tile's row border (rows 31 | 32) and
    column border (columns 127 | 128), and two in one cell at a tile corner:
    all survive, and each one's soft-argmax leans half a pixel towards its
    twin (clipped at 0.5 px); the corner cell averages its two."""
    heat = 0.1 * torch.rand((96, 260), generator=card, device="cuda") ** 8
    for y, x in ((31, 60), (32, 60), (50, 127), (50, 128), (62, 252),
                 (63, 253)):
        heat[y, x] = 0.9
    cm, cx, cy = _hold_nms_select(heat)
    for (y, x), (ex, ey) in (((31, 60), (60, 31.5)), ((32, 60), (60, 31.5)),
                             ((50, 127), (127.5, 50)),
                             ((50, 128), (127.5, 50)),
                             ((62, 252), (252.5, 62.5))):
        assert float(cm[y // 4, x // 4]) == pytest.approx(0.9)
        assert float(cx[y // 4, x // 4]) == pytest.approx(ex, abs=0.01)
        assert float(cy[y // 4, x // 4]) == pytest.approx(ey, abs=0.01)


def test_nms_select_kernel_plateau(card):
    """A flat plateau: every pixel on it survives (ties keep), so a tile
    lists thousands of survivors, more than a block computes at once."""
    heat = torch.zeros((96, 260), device="cuda")
    heat[8:88, 8:250] = 0.5
    cm, cx, _ = _hold_nms_select(heat)
    assert float(cm[10, 30]) == 0.5 and float(cx[10, 30]) == 121.5


def test_nms_select_kernel_all_zero(card):
    zero = torch.zeros((1088, 1920), device="cuda")
    for t in _hold_nms_select(zero):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.parametrize("h,w", [(1088, 1920), (2048, 2048)])
def test_nms_cellmax_kernel_equals_select(card, h, w):
    from gisnav_tpu_torch.features.nms_kernel import nms_cellmax, nms_select

    heat = torch.rand((h, w), generator=card, device="cuda") ** 8
    assert torch.equal(nms_cellmax(heat, 4), nms_select(heat, 4)[0])


@pytest.mark.parametrize("c,h,w", [(1, 384, 384), (2, 1024, 1024),
                                   (3, 512, 384), (4, 2048, 2048)])
@pytest.mark.parametrize("shift", [0.999, -0.999, 0.3])
def test_shear_kernels_both_axes(card, c, h, w, shift):
    """Both entries bit-equal to their plain versions, and the first axis to
    the transpose route on the card."""
    from gisnav_tpu_torch.raster.shear_kernel import (
        shear_first_axis,
        shear_first_axis_plain,
        shear_last_axis,
        shear_last_axis_plain,
    )

    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    img = torch.rand((c, h, w), generator=card, device="cuda")
    assert torch.equal(shear_last_axis(img, shift, h / 2),
                       shear_last_axis_plain(img, shift, h / 2))
    reset_launches()
    first = shear_first_axis(img, shift, w / 2)
    assert (LAUNCHES["shear_first_axis"], LAUNCHES["shear_last_axis"]) == (
        1, 0)
    assert torch.equal(first, shear_first_axis_plain(img, shift, w / 2))
    assert torch.equal(first, shear_last_axis(
        img.transpose(-1, -2).contiguous(), shift, w / 2).transpose(-1, -2))


@pytest.mark.parametrize("yaw", [20.0, -33.0, 61.5, 117.0])
def test_shear_rotation_kernel_route_equals_transpose_route(card, yaw,
                                                            monkeypatch):
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.raster import shear as tshear
    from gisnav_tpu_torch.raster.shear_kernel import shear_last_axis

    stack = torch.rand((2048, 2048, 2), generator=card, device="cuda")
    reset_launches()
    got = tshear.rotate_and_crop_center_shear(stack, yaw, (1088, 1920))
    assert (LAUNCHES["shear_last_axis"], LAUNCHES["shear_first_axis"]) == (
        2, 1)
    monkeypatch.setattr(tshear, "shear_first_axis", lambda img, b, c: (
        shear_last_axis(img.transpose(-1, -2).contiguous(), b, c)
        .transpose(-1, -2).contiguous()))
    ref = tshear.rotate_and_crop_center_shear(stack, yaw, (1088, 1920))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("h,w", [(480, 640), (240, 320)])
def test_select_keypoints_harris_shapes(card, h, w):
    """K3 through ``select_keypoints`` on a Harris heatmap at harris_lg5's
    frame and pooled query (240 rows: the zeroed-row route), against the
    plain route on the same CUDA input: scores exact, positions 1e-4 px."""
    from gisnav_tpu_torch.features.harris import harris_response
    from gisnav_tpu_torch.features.nms import select_keypoints
    from gisnav_tpu_torch.features.nms_kernel import nms_select_plain
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    img = torch.rand((h, w), generator=card, device="cuda")
    heat = harris_response(img)
    reset_launches()
    kp, sc, valid = select_keypoints(heat, 512)
    assert LAUNCHES["nms_select"] == 1
    rows = torch.arange(h, device="cuda")[:, None]
    src = heat if h % 32 == 0 else torch.where(rows < h - 4, heat, 0.0)
    cell_max, cx, cy = nms_select_plain(src, 4)
    want_sc, idx = torch.topk(cell_max.reshape(-1), 512)
    assert torch.equal(sc, want_sc)
    want_kp = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=1)[idx]
    torch.testing.assert_close(kp, want_kp, rtol=0, atol=1e-4)
    assert bool(valid.any())


def test_harris_response_on_card_vs_cpu(card):
    """Plain PyTorch on both devices: 1e-5 on the normalised response."""
    from gisnav_tpu_torch.features.harris import harris_response

    img = torch.rand((2, 480, 640), generator=card, device="cuda")
    torch.testing.assert_close(harris_response(img).cpu(),
                               harris_response(img.cpu()), rtol=0,
                               atol=1e-5)


def _harris_scene(map_side=800):
    from gisnav_tpu_torch.utils.world import render_scene

    return render_scene(seed=6, h=480, w=640, yaws=[0.0, 45.0],
                        map_side=map_side, coverage=3.0, offset_m=22.2)


@pytest.mark.parametrize("name,per_frame", [
    ("make_cached_deep_runner", {"stem_stage": 1, "conv_stage": 7,
                                 "nms_select": 1, "fused_block": 40}),
    ("make_bucketed_warp_runner", {"stem_stage": 1, "conv_stage": 7,
                                   "nms_select": 1, "fused_block": 20}),
    ("make_deep_runner", {"stem_stage": 2, "conv_stage": 14,
                          "nms_select": 2, "fused_block": 20})])
def test_harris_runners_on_card_launches(card, name, per_frame):
    """The default bundle (harris_lg5, depth 5, 512 keypoints): no detector
    head (7 conv launches a SuperPoint pass), 5 dual block calls a layer
    pair in the warp modes, 20 one-stream calls in the cached mode; a
    frame that hits the cache (map, bucket) launches only these."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline import runners
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64

    s = _harris_scene()
    runner = getattr(runners, name)()
    args = (s.frames[1], s.ortho, s.dem, s.yaws[1], s.k, s.crs_affine)
    runner(*args, map_stamp=1, altitude_agl=s.alt_m)
    reset_launches()
    pose = runner(*args, map_stamp=1, altitude_agl=s.alt_m)
    assert LAUNCHES == {k: per_frame.get(k, 0) for k in LAUNCHES}
    fix = geopose_to_wgs84_f64(pose, s.crs_affine)
    lon, lat = s.truth_lonlat[1]
    assert bool(pose.valid)
    assert haversine_m(lat, lon, fix["lat"], fix["lon"]) < 10.0


def test_loftr_on_card_vs_cpu(card):
    """The bundled LoFTR at 480x640 with 1024 matches on the card (f32, TF32
    off) against the CPU: no kernel of the port launches; the valid match
    sets agree but for cells whose confidence lies within 1e-3 of the 0.2
    threshold, shared matches' confidences within 1e-4 and refined
    ``kp1`` within 1e-2 px."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.matching.loftr import LoFTR
    from gisnav_tpu_torch.raster import rotate_and_crop_auto
    from gisnav_tpu_torch.weights import load_bundled, params_from_jax

    tree, cfg = load_bundled("loftr")
    s = _harris_scene()
    img0 = torch.as_tensor(s.frames[1].astype(np.float32) / 255.0)
    # the semi-dense runner's crop: rotated to the yaw, at the query's GSD
    ortho = torch.as_tensor(s.ortho.astype(np.float32) / 255.0)
    crop, _ = rotate_and_crop_auto(ortho[..., None], s.yaws[1], (480, 640),
                                   zoom=1.25 / 3.0)
    img1 = crop[..., 0].contiguous()
    cpu = LoFTR(params_from_jax(tree)["loftr"], max_matches=1024)(img0, img1)
    model = LoFTR(params_from_jax(tree, "cuda")["loftr"], max_matches=1024)
    reset_launches()
    got = model(img0.cuda(), img1.cuda())
    assert all(n == 0 for n in LAUNCHES.values())

    def cells(m):
        c = m.confidence.cpu().numpy()
        return {tuple(k): (i, c[i]) for i, k in enumerate(
            m.kp0.cpu().numpy()) if m.mask[i]}

    a, b = cells(got), cells(cpu)
    assert len(b) >= 10
    for cell in a.keys() ^ b.keys():
        conf = (a.get(cell) or b.get(cell))[1]
        assert abs(conf - 0.2) < 1e-3, (cell, conf)
    for cell in a.keys() & b.keys():
        i, j = a[cell][0], b[cell][0]
        assert abs(a[cell][1] - b[cell][1]) < 1e-4
        torch.testing.assert_close(got.kp1[i].cpu(), cpu.kp1[j], rtol=0,
                                   atol=1e-2)
