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
bit, the NMS cell max exact. The classical backend (plain PyTorch, no
kernel of its own): SIFT on the card reproduces the CPU's keypoints (0.05
px, size 1e-3, angle 0.1 deg) and descriptors (every element within 1) as
the CPU reproduces OpenCV's (``tests/test_torch_sift.py``); the classical
frame launches K6 2 + 1 times and fixes within 10 m; the twist node's
steps stay within 0.5 m of the rendered flight's. The node graph: a UKF
step on the card equals the CPU's (1e-4 m) and NaNs on a non-PD P; one
pose-node frame with the production backend is within 10 m and launches
K1-K4. Training: K5's Function against autograd of its plain version (3e-2
of the largest |gradient|) with its pair axis bit-equal to single calls,
K1, K2 and K4's Functions against the same (1e-2), one train step on the
card against the CPU's (loss 2e-2 relative, gt_recall 0.05) with 24 K5
launches, and ``train`` on the card with its checkpoints. Frame graphs
(``pipeline/graph.py``): the bucketed per-frame program captured and
replayed against the eager program on the same inputs and RANSAC noise
(matches and inliers identical, the fix within 1 mm), RANSAC's split draw
equal to ``torch.multinomial`` on the card, launch counts after replays, a
capture that reads the host raising, and a multistream tick (forked and
sequential) equal to its single frames. Every other graphed program,
captured and replayed on new inputs against the same function run eagerly:
the bucket refresh and map extraction (identical; the card's crop matrix
within 1 f32 ulp of the host-built one), the exact-warp frame with its
zoom and through the 3-shear rotation (K6 2 + 1 a replay), the derotated
cached frame and LoFTR's frame (matches and inliers identical, fixes
within 1 mm), the classical rotate + crop and tail (fixes within 1 mm),
the UKF's and EKF's three steps (1e-6 relative), and the three train
chunks and the host-data step (losses within 1e-5 of eager ones from the
same state and generator seed, the generators ending alike, each replay
drawing the eager chunk's pairs and two replays different ones; a state
rebuilt around another step counter captured anew), the capturable AdamW
against ``optax.adamw`` (1e-6; its numpy f32 transcription where JAX is
not installed), a ``sample_idx`` refused by the classical frame; K6 with
its shift read from device memory, bit-equal to its plain versions at the
residual shears' bounds and inside a graph, NaN out of range; a capture
while old graphs wait in reference cycles for the collector. The mesh: a
(2 x 2) mesh over ``cuda:0`` (a graph a row) within JAX's TP2 bound of
TP1 (lon/lat 2e-5 deg) and TP1 equal to the single-device tick, the mesh
train step against the replicated one (loss 1e-2 relative, parameters 5
lr), and every kernel wrapper on ``cuda:1`` against its plain version
with the tolerances above (skipped below two cards).
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


def test_sift_on_card_vs_cpu(card):
    from gisnav_tpu_torch.features.sift import extract_sift

    img = _harris_scene().frames[1]
    cpu = [a.numpy() for a in extract_sift(img, 1024, device="cpu")]
    got = [a.cpu().numpy() for a in extract_sift(img, 1024)]
    (p, s, a, d), (tp, ts, ta, td) = cpu, got
    dist = np.linalg.norm(p[:, None] - tp[None], axis=-1)
    da = np.abs((a[:, None] - ta[None] + 180.0) % 360.0 - 180.0)
    ds = np.abs(s[:, None] - ts[None]) / s[:, None]
    cost = np.where((da <= 0.1) & (ds <= 1e-3), dist, np.inf)
    j = cost.argmin(1)
    ok = cost[np.arange(len(p)), j] <= 0.05
    diff = np.abs(d[ok] - td[j[ok]]).max(1)
    print(f"SIFT card vs CPU: {len(tp)} / {len(p)} keypoints, "
          f"{ok.mean():.2%} reproduced, descriptors {(diff <= 1).mean():.2%}"
          f" within 1")
    assert abs(len(tp) - len(p)) <= 0.01 * len(p) + 1
    assert ok.mean() >= 0.99 and (diff <= 1).mean() >= 0.99


def test_classical_on_card_launches(card):
    """A square map whose side is a multiple of 128: the crop is the
    3-shear rotation (K6 2 + 1), nothing else of the port launches."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.classical import (
        classical_frame_to_geopose,
    )
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64

    s = _harris_scene(map_side=1024)
    args = (s.frames[1], s.ortho, s.dem, s.yaws[1], s.k, s.crs_affine)
    classical_frame_to_geopose(*args)
    reset_launches()
    pose = classical_frame_to_geopose(*args)
    assert LAUNCHES == {k: {"shear_last_axis": 2,
                            "shear_first_axis": 1}.get(k, 0)
                        for k in LAUNCHES}
    fix = geopose_to_wgs84_f64(pose, s.crs_affine)
    lon, lat = s.truth_lonlat[1]
    assert bool(pose.valid)
    assert haversine_m(lat, lon, fix["lat"], fix["lon"]) < 10.0


def test_twist_node_on_card(card):
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.twist_node import TOPIC_TWIST_POSE, TwistNode
    from gisnav_tpu_torch.utils.world import render_flight

    fl = render_flight(seed=3, h=480, w=640, steps=4)
    bus, poses = LocalBus(), []
    node = TwistNode(bus)
    bus.subscribe(TOPIC_TWIST_POSE, poses.append)
    node.initialize_pose(fl.poses[0])
    bus.publish("/camera/camera_info", {"k": fl.k, "width": 640,
                                        "height": 480})
    bus.publish("/mavros/global_position/global",
                {"alt_ellipsoid": fl.alt_m})
    for i, frame in enumerate(fl.frames):
        bus.publish("/camera/image_raw", {"image": frame,
                                          "stamp_us": i * 100_000})
    assert len(poses) == 3
    prev = fl.poses[0][:3, 3]
    for i, pose in enumerate(poses, start=1):
        step = pose["position"] - prev
        true = fl.poses[i][:3, 3] - fl.poses[i - 1][:3, 3]
        assert np.linalg.norm(step - true) < 0.5
        prev = pose["position"]


def test_filter_step_on_card_matches_cpu(card):
    """One UKF submit (predict + pose update) and state query on the card
    equal the CPU's (x within 1e-4 m, TF32 off), and a non-PD covariance
    gives NaN on the card too (``cholesky_ex``, no exception)."""
    from gisnav_tpu_torch.fusion import ekf, ukf
    from gisnav_tpu_torch.fusion.filter import PoseFusionFilter, SensorConfig

    quat = np.array([0.0, 0.0, 0.3, 0.95])
    out = []
    for device in ("cuda", "cpu"):
        f = PoseFusionFilter({"pose": SensorConfig(rejection_threshold=3.0)},
                             backend="ukf", device=device)
        for i in range(3):
            f.submit("pose", 1_000_000 + 250_000 * i,
                     np.array([1000.0 + 5 * i, 500.0, 500.0]), quat)
        out.append(f.state_at(1_600_000))
    np.testing.assert_allclose(out[0]["position"], out[1]["position"],
                               rtol=0, atol=1e-4)
    x = torch.zeros(15, device="cuda")
    p = torch.eye(15, device="cuda")
    p[0, 0] = -1.0
    bad = ukf.ukf_predict(ekf.EKFState(x, p), 0.1,
                          torch.ones(15, device="cuda"))
    assert torch.isnan(bad.x).all()


def test_pose_node_frame_on_card(card):
    """One frame through the pose node with the production backend
    (learned_lg9, bucketed warp, 480x640) against a map from the stub WMS:
    a valid pose within 10 m, and the frame went through K1-K4."""
    from gisnav_tpu_torch.geometry.bbox import fov_bounding_box_enu
    from gisnav_tpu_torch.geometry.crs import (
        affine_to_proj,
        haversine_m,
        pixel_to_wgs84_affine,
    )
    from gisnav_tpu_torch.geometry.quaternion import quat_to_matrix
    from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.pose_node import TOPIC_POSE, PoseNode
    from gisnav_tpu_torch.utils.world_wms import (
        World,
        WorldWMS,
        camera_attitude_quat,
    )

    k = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    world = World.make(seed=7, size_px=2048)
    lon, lat = world.to_lonlat(1024, 1024)
    quat = camera_attitude_quat(20.0)
    bb = fov_bounding_box_enu(k, 640, 480, quat_to_matrix(quat), 500.0,
                              lon, lat)
    with WorldWMS(world) as wms:
        img, dem = request_orthoimage(WMSClient(wms.url), tuple(bb),
                                      (800, 800), ["imagery"], ["dem"])
    bus, poses = LocalBus(), []
    PoseNode(bus, {"backend": "deep"})
    bus.subscribe(TOPIC_POSE, poses.append)
    bus.publish("/camera/camera_info", {"k": k, "width": 640, "height": 480})
    bus.publish("/gisnav/gis_node/orthoimage", {
        "stamp_us": 1, "image": img, "dem": dem, "bbox": bb,
        "crs": affine_to_proj(pixel_to_wgs84_affine(800, 800, *bb))})
    bus.publish("/mavros/global_position/global",
                {"stamp_us": 2, "lat": lat, "lon": lon,
                 "alt_ellipsoid": 500.0})
    bus.publish("/mavros/gimbal_control/device/attitude_status",
                {"stamp_us": 2, "quat_xyzw": quat})
    reset_launches()
    bus.publish("/camera/image_raw", {
        "stamp_us": 3, "image": world.render_frame(lon, lat, 500.0, 20.0,
                                                   k)})
    assert len(poses) == 1
    assert haversine_m(lat, lon, poses[0]["lat"], poses[0]["lon"]) < 10.0
    assert abs(poses[0]["alt_ellipsoid"] - 500.0) < 10.0
    assert LAUNCHES == {"stem_stage": 2, "conv_stage": 16, "nms_select": 2,
                        "fused_block": 36, "masked_attention": 0,
                        "shear_last_axis": 0, "shear_first_axis": 0,
                        "nms_cellmax": 0}


# ---------------------------------------------------------------------------
# training (path 9): gradients of the kernels, the train step, the loop
# ---------------------------------------------------------------------------


def _grad_gap(fn, plain, inputs, g):
    """max |grad of fn - autograd of plain| / max |grad| over the inputs."""
    a = [t.detach().clone().requires_grad_() for t in inputs]
    b = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*a)
    out.backward(g.to(out.dtype))
    plain(*b).backward(g.to(out.dtype))
    return out.detach(), max(
        float((x.grad.float() - y.grad.float()).abs().max())
        / max(float(y.grad.float().abs().max()), 1e-30)
        for x, y in zip(a, b))


@pytest.mark.parametrize("kq,kk,cross", [(256, 256, False), (256, 512, True),
                                         (512, 256, False)])
def test_masked_attention_function_grad_and_pair_axis(card, kq, kk, cross):
    """K5's Function (the kernel, the analytic backward) against autograd of
    the plain version (3e-2 of the largest |gradient|, as chip_smoke), and
    the pair axis bit-equal to single calls."""
    from gisnav_tpu_torch.matching.attention import (
        MaskedAttention,
        masked_attention,
        masked_attention_plain,
    )

    dt = torch.bfloat16 if cross else torch.float32
    q = torch.randn((8, kq, 4, 64), generator=card, device="cuda").to(dt)
    k = torch.randn((8, kk, 4, 64), generator=card, device="cuda").to(dt)
    v = torch.randn((8, kk, 4, 64), generator=card,
                    device="cuda").bfloat16()
    mask = torch.rand((8, kk), generator=card, device="cuda") > 0.3
    g = torch.randn((8, kq, 4, 64), generator=card, device="cuda")
    out, gap = _grad_gap(
        lambda *a: MaskedAttention.apply(*a, mask),
        lambda *a: masked_attention_plain(*a, mask), (q, k, v), g)
    assert gap <= 3e-2
    single = torch.stack([masked_attention(q[i], k[i], v[i], mask[i])
                          for i in range(8)])
    assert torch.equal(single, out)


def test_conv_and_block_function_grads(card):
    """K1, K2, K4: the backward recomputes through the plain version, so
    the Function and autograd of the plain version agree (1e-2 of the
    largest |gradient|: one bf16 ulp where cuDNN picks another algorithm)."""
    from gisnav_tpu_torch.features.conv import (
        conv_stage,
        conv_stage_plain,
        stem_stage,
        stem_stage_plain,
    )
    from gisnav_tpu_torch.matching.lightglue_fused import (
        fused_block,
        fused_block_plain,
    )

    w1a, b1a = _conv_w(card, 1, 64)
    w1b, b1b = _conv_w(card, 64, 64)
    img = torch.rand((64, 96), generator=card, device="cuda")
    g = torch.randn((32, 48, 64), generator=card, device="cuda")
    _, gap = _grad_gap(lambda *a: stem_stage(*a, pool=True),
                       lambda *a: stem_stage_plain(*a, pool=True),
                       (img, w1a, b1a, w1b, b1b), g)
    assert gap <= 1e-2
    x = torch.relu(torch.randn((32, 48, 64), generator=card,
                               device="cuda")).bfloat16()
    w2, b2 = _conv_w(card, 64, 128)
    g = torch.randn((16, 24, 128), generator=card, device="cuda")
    _, gap = _grad_gap(lambda *a: conv_stage(*a, pool=True),
                       lambda *a: conv_stage_plain(*a, pool=True),
                       (x, w2, b2), g)
    assert gap <= 1e-2

    def r(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=card, device="cuda")
                * scale).to(dt).contiguous()

    bf = torch.bfloat16
    n, dim = 512, 256
    bias = torch.where(torch.rand((2, n), generator=card, device="cuda")
                       < 0.9, 0.0, -1e9).float()
    args = (r(2 * n, dim), r(2 * n, dim, dt=bf), r(2 * n, dim, dt=bf),
            r(2 * n, dim, dt=bf), bias, r(dim, dim, scale=dim ** -0.5, dt=bf),
            r(dim, scale=0.05), r(dim, 2 * dim, scale=0.04, dt=bf),
            r(dim, 2 * dim, scale=0.04, dt=bf), r(2 * dim, scale=0.05),
            1.0 + r(2 * dim, scale=0.1), r(2 * dim, scale=0.1),
            r(2 * dim, dim, scale=0.04, dt=bf), r(dim, scale=0.05))
    _, gap = _grad_gap(lambda *a: fused_block(*a, heads=4, sets=2),
                       lambda *a: fused_block_plain(*a, heads=4, sets=2),
                       args, r(2 * n, dim))
    assert gap <= 1e-2


def test_train_step_on_card_vs_cpu(card):
    """One step from the same params and host batch: loss 2e-2 relative,
    gt_recall 0.05; 24 K5 launches a step at depth 3, no other kernel."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.train.data import make_homography_batch
    from gisnav_tpu_torch.train.steps import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    config = TrainConfig()
    batch = make_homography_batch(np.random.default_rng(0), 2,
                                  config.image_shape)
    metrics = {}
    for dev in ("cuda", "cpu"):
        state, tx = init_train_state(torch.Generator().manual_seed(0),
                                     config, dev)
        reset_launches()
        _, m = make_train_step(config, tx)(
            state, *(torch.as_tensor(a, device=dev) for a in batch))
        metrics[dev] = {k: float(v) for k, v in m.items()}
        if dev == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["masked_attention"] == 24
            assert sum(LAUNCHES.values()) == 24
    assert abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"]) <= \
        2e-2 * abs(metrics["cpu"]["loss"])
    assert abs(metrics["cuda"]["gt_recall"]
               - metrics["cpu"]["gt_recall"]) <= 0.05


def test_train_loop_on_card(card, tmp_path):
    """``train`` on the card: device pairs in chunks of 10, checkpoints,
    finite losses, the params moved."""
    from gisnav_tpu_torch.train import checkpoint
    from gisnav_tpu_torch.train.loop import train
    from gisnav_tpu_torch.train.steps import TrainConfig, tree_leaves

    params = train(steps=20, batch_size=2, config=TrainConfig(
        lightglue_depth=1), ckpt_dir=str(tmp_path), ckpt_every=10)
    assert checkpoint.latest_step(str(tmp_path)) == 20
    first = checkpoint.load_params(str(tmp_path), step=10, like=params)
    assert all(torch.isfinite(p).all() for p in tree_leaves(params))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                     tree_leaves(params)))


# --- frame programs as CUDA graphs (pipeline/graph.py) ---------------------


def _small_bucket(cfg, models, scene):
    """The 128x256 scene's bucket features for yaw 0 (zoom as the runner
    quantises it) and the frame's inputs on the card."""
    from gisnav_tpu_torch.pipeline.geopose import (
        build_warp_reference_extractor,
    )

    dev = "cuda"
    zoom = scene.alt_m / scene.k[0, 0] / abs(scene.crs_affine[2, 2])
    zstep = np.log1p(0.10)
    zq = float(np.float32(np.exp(round(np.log(zoom) / zstep) * zstep)))
    bucket = build_warp_reference_extractor(cfg)(
        models, torch.as_tensor(scene.ortho, device=dev).float() / 255.0,
        torch.as_tensor(scene.dem, device=dev), 0.0, zq)
    k, aff = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in (scene.k, scene.crs_affine))
    return bucket, k, aff


def test_frame_graph_replays_equal_eager(card):
    """The bucketed per-frame program at 128x256 / 512 keypoints, captured
    and replayed on three frames with three RANSAC seeds, against the
    eager program on the same inputs and noise: matches and inliers
    identical, the fix within 1 mm; a replay
    counts what an eager frame counts."""
    import dataclasses

    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose_warpcached,
        build_models,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pipeline.graph import FrameGraph
    from gisnav_tpu_torch.pnp.ransac import draw_noise
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled, params_from_jax

    scene = render_scene(seed=4, h=128, w=256, yaws=[0.0, 3.0, -4.0])
    params, cfg = load_bundled("learned_lg9")
    cfg = dataclasses.replace(cfg, image_shape=(128, 256), max_keypoints=512)
    models = build_models(params_from_jax(params, "cuda"), cfg)
    (feats, dem, m_crop), k, aff = _small_bucket(cfg, models, scene)
    hot = build_frame_to_geopose_warpcached(cfg)
    program = FrameGraph(
        lambda q, f, d, m, k_, a, noise: hot(models, q.float() / 255.0, f,
                                             d, m, k_, a, noise=noise),
        "cuda", sticky=(1, 2, 3))
    gen = torch.Generator(device="cuda")

    def noise(seed):
        gen.manual_seed(seed)
        return draw_noise(gen, cfg.num_hypotheses, cfg.max_keypoints)

    q0 = torch.from_numpy(scene.frames[0])
    program(q0, feats, dem, m_crop, k, aff, noise(1))  # captures
    assert program.launches == {"stem_stage": 1, "conv_stage": 8,
                                "nms_select": 1, "fused_block": 36}
    reset_launches()
    for i, seed in ((0, 2), (1, 3), (2, 4)):
        q = torch.from_numpy(scene.frames[i])
        got = program(q, feats, dem, m_crop, k, aff, noise(seed))
        want = hot(models, q.cuda().float() / 255.0, feats, dem, m_crop, k,
                   aff, noise=noise(seed))
        for f in ("matched_qry", "matched_ref", "match_mask", "num_matches",
                  "num_inliers", "valid"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        a, b = (geopose_to_wgs84_f64(p, scene.crs_affine)
                for p in (got, want))
        assert haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]) < 1e-3
        assert abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]) < 1e-3
    assert program.replays == 3
    # 3 replays and 3 eager frames, 46 launches each
    assert LAUNCHES["fused_block"] == 6 * 36 and LAUNCHES["stem_stage"] == 6


@pytest.mark.parametrize("kind", ["random", "empty", "three", "full"])
def test_split_draw_equals_multinomial_on_card(card, kind):
    from gisnav_tpu_torch.pnp.ransac import draw_noise, draw_samples

    n = 2048
    mask = torch.zeros(n, dtype=torch.bool, device="cuda")
    if kind == "random":
        mask = torch.rand(n, generator=card, device="cuda") > 0.6
    elif kind == "three":
        mask[[3, 700, 2047]] = True
    elif kind == "full":
        mask[:] = True
    probs = mask.float()
    if not bool(probs.sum() > 0):
        probs = torch.ones_like(probs)
    for seed in range(5):
        gen = torch.Generator(device="cuda")
        want = torch.multinomial(probs.expand(64, -1), 4, replacement=False,
                                 generator=gen.manual_seed(seed))
        got = draw_samples(mask, 64, gen.manual_seed(seed))
        split = draw_samples(mask, 64,
                             noise=draw_noise(gen.manual_seed(seed), 64, n))
        assert torch.equal(got, want) and torch.equal(split, want)


def test_launches_count_replays(card):
    """A captured program that runs the NMS-select kernel: the warm-up
    counts its launch, the capture none, each replay one."""
    from gisnav_tpu_torch.features.nms_kernel import nms_select
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.graph import FrameGraph

    heat = torch.rand((96, 256), generator=card, device="cuda") ** 8
    program = FrameGraph(lambda h: nms_select(h, 4), "cuda")
    reset_launches()
    first = program(heat)
    assert LAUNCHES["nms_select"] == 1 and program.launches == {
        "nms_select": 1}
    for _ in range(3):
        got = program(heat)
    assert LAUNCHES["nms_select"] == 4 and sum(LAUNCHES.values()) == 4
    for a, b in zip(got, first):
        assert torch.equal(a, b)
    assert program.capture_ms > 0 and program.pool_bytes >= 0


def test_failed_capture_raises(card):
    """A program that reads a value back to the host runs eagerly in the
    warm-up and cannot be captured: ``CaptureError``, on every call (no
    eager fallback), with the counts left as the warm-ups made them."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.graph import CaptureError, FrameGraph

    program = FrameGraph(lambda x: x * float(x.sum()), "cuda")
    x = torch.ones(8, device="cuda")
    reset_launches()
    for _ in range(2):
        with pytest.raises(CaptureError):
            program(x)
    assert program.replays == 0 and all(n == 0 for n in LAUNCHES.values())
    torch.cuda.synchronize()
    assert torch.equal(x * 2, torch.full((8,), 2.0, device="cuda"))


@pytest.mark.parametrize("fork", [True, False])
def test_multistream_on_card_equals_single_frames(card, fork):
    """harris_lg5 cached at 480x640 on path 4's scene, three streams in one
    graph a tick (forked branches or one stream): each stream's matches
    identical to the eager single frame's on the same input and noise, the
    fix within 1 mm and 10 m of the truth; a tick launches three frames'
    kernels."""
    import dataclasses

    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose_cached,
        build_models,
        build_reference_extractor,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pipeline.multistream import (
        build_multistream_pipeline,
    )
    from gisnav_tpu_torch.pnp.ransac import draw_noise
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled, params_from_jax

    n = 3
    s = render_scene(seed=6, h=480, w=640, yaws=[0.0, 90.0, 180.0],
                     map_side=800, coverage=3.0, offset_m=22.2)
    params, cfg = load_bundled("harris_lg5")
    cfg = dataclasses.replace(cfg, ortho_shape=s.ortho.shape,
                              detector_downsample=2)
    dev = "cuda"
    models = build_models(params_from_jax(params, dev), cfg)
    ref = build_reference_extractor(cfg)(
        models, torch.as_tensor(s.ortho, device=dev).float() / 255.0)
    k, aff = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in (s.k, s.crs_affine))
    batch = (torch.stack([torch.as_tensor(f, device=dev).float() / 255.0
                          for f in s.frames]),
             type(ref)(*(torch.stack([f] * n) for f in ref)),
             torch.stack([torch.as_tensor(s.dem, device=dev)] * n),
             torch.stack([k] * n), torch.stack([aff] * n))
    fn = build_multistream_pipeline(cfg, fork_streams=fork)
    gens = [torch.Generator(device=dev).manual_seed(i + 1) for i in range(n)]
    fn(models, *batch, gens)  # captures
    gens = [g.manual_seed(i + 10) for i, g in enumerate(gens)]
    reset_launches()
    out = fn(models, *batch, gens)
    assert LAUNCHES == {kk: {"stem_stage": 1, "conv_stage": 7,
                             "nms_select": 1, "fused_block": 40}.get(kk, 0)
                        * n for kk in LAUNCHES}
    frame = build_frame_to_geopose_cached(cfg)
    for i in range(n):
        gen = torch.Generator(device=dev).manual_seed(i + 10)
        want = frame(models, batch[0][i], ref, batch[2][i], k, aff,
                     noise=draw_noise(gen, cfg.num_hypotheses,
                                      cfg.max_keypoints))
        got = type(out)(*(f[i] for f in out))
        for f in ("matched_qry", "matched_ref", "match_mask", "num_matches",
                  "num_inliers", "valid"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        a, b = (geopose_to_wgs84_f64(p, s.crs_affine) for p in (got, want))
        assert haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]) < 1e-3
        lon, lat = s.truth_lonlat[i]
        assert haversine_m(lat, lon, a["lat"], a["lon"]) < 10.0


# --- every other program the JAX package jits, graphed --------------------


def _same_pose(got, want):
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64

    for f in ("matched_qry", "matched_ref", "match_mask", "num_matches",
              "num_inliers", "valid"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    aff = np.eye(4)  # any f64 affine: the raster-frame pose decides
    aff[:3, :3] = np.diag([1e-5, -1e-5, 1.0])
    a, b = (geopose_to_wgs84_f64(p, aff) for p in (got, want))
    assert haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]) < 1e-3
    assert abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]) < 1e-3


def _replays_equal_eager(fn, calls, check, sticky=()):
    """``fn`` captured on the first call's inputs, then each later call
    replayed and run eagerly on the same inputs: ``check(got, want)``."""
    from gisnav_tpu_torch.pipeline.graph import FrameGraph

    program = FrameGraph(fn, "cuda", sticky=sticky)
    program(*calls[0])
    for args in calls[1:]:
        got = program(*args)
        with torch.no_grad():
            want = fn(*(a.cuda() if isinstance(a, torch.Tensor) else a
                        for a in args))
        check(got, want)
    assert program.replays == len(calls) - 1
    return program


def _noise(seed, n, hyp=64):
    from gisnav_tpu_torch.pnp.ransac import draw_noise

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return draw_noise(gen, hyp, n)


def _scalar(v):
    return torch.tensor(np.float32(v))


def _card_inputs(s):
    dev = "cuda"

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return (f32(s.ortho) / 255.0, f32(s.dem), f32(s.k), f32(s.crs_affine))


def test_refresh_and_extraction_graphs_equal_eager(card):
    """The bucket refresh (angle and zoom as () inputs, the stack sticky)
    over three buckets and the map extraction over two maps: features,
    crop and matrix identical; the refresh's matrix within 1 f32 ulp of
    the host-built one."""
    from gisnav_tpu_torch.pipeline.geopose import (
        build_models,
        build_reference_extractor,
        build_warp_reference_extractor,
    )
    from gisnav_tpu_torch.raster.warp import crop_to_original
    from gisnav_tpu_torch.weights import params_from_jax

    params, cfg, s = _small_scene(map_side=512, coverage=2.2)
    models = build_models(params_from_jax(params, "cuda"), cfg)
    ortho, dem, _, _ = _card_inputs(s)
    refresh = build_warp_reference_extractor(cfg)

    def same(got, want):
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])

    calls = [(ortho, dem, _scalar(a), _scalar(z))
             for a, z in ((0.0, 1.1), (15.0, 0.9), (-30.0, 1.21))]
    _replays_equal_eager(lambda *a: refresh(models, *a), calls, same,
                         sticky=(0, 1))
    h, w = cfg.image_shape
    z = np.float32(1.21)
    host = crop_to_original(-30.0, 256, 256, 256 - z * (w / 2.0),
                            256 - z * (h / 2.0), z)
    m = refresh(models, ortho, dem, _scalar(-30.0).cuda(),
                _scalar(z).cuda())[2].cpu()
    assert ((m - host).abs() <= np.spacing(np.float32(host.abs().max()))
            ).all()

    extract = build_reference_extractor(cfg)
    maps = [torch.from_numpy(s.ortho), torch.from_numpy(s.ortho[::-1].copy()),
            torch.from_numpy(s.ortho)]
    _replays_equal_eager(lambda o: extract(models, o.float() / 255.0),
                         [(m_,) for m_ in maps],
                         lambda g, w_: [torch.equal(a, b) or pytest.fail()
                                        for a, b in zip(g, w_)])


@pytest.mark.parametrize("route", ["zoom", "shear"])
def test_exact_warp_graph_equals_eager(card, route):
    """The exact-warp frame with its zoom (the gather) and without one on a
    square 384 map (the 3-shear rotation, K6 2 + 1 a replay, the quadrant
    static): three yaws of one quadrant, matches and inliers identical and
    the fix within 1 mm."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose,
        build_models,
    )
    from gisnav_tpu_torch.weights import params_from_jax

    kw = (dict(map_side=512, coverage=2.2) if route == "zoom"
          else dict(map_side=384, coverage=384 / 320))
    params, cfg, s = _small_scene(**kw)
    models = build_models(params_from_jax(params, "cuda"), cfg)
    ortho, dem, k, aff = _card_inputs(s)
    fn = build_frame_to_geopose(cfg)
    q = torch.from_numpy(s.frames[0])
    zoom = [_scalar(s.alt_m / s.k[0, 0] / abs(s.crs_affine[2, 2]))] \
        if route == "zoom" else []
    calls = [(q, ortho, dem, _scalar(a), k, aff, _noise(i, 512), *zoom)
             for i, a in enumerate((20.0, 4.0, 38.5))]
    reset_launches()
    program = _replays_equal_eager(
        lambda q, o, d, a, k_, f, n, *z: fn(
            models, q.float() / 255.0, o, d, a, k_, f, noise=n,
            gsd_zoom=z[0] if z else None, quadrant=None if z else 0),
        calls, _same_pose, sticky=(1, 2))
    if route == "shear":
        assert program.launches["shear_last_axis"] == 2
        assert program.launches["shear_first_axis"] == 1
        assert LAUNCHES["shear_last_axis"] == 2 * 5  # warm-up, 2 x 2 more


def test_derotated_cached_frame_graph_equals_eager(card):
    import dataclasses

    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose_cached,
        build_models,
        build_reference_extractor,
    )
    from gisnav_tpu_torch.weights import params_from_jax

    params, cfg, s = _small_scene(map_side=512, coverage=2.2)
    cfg = dataclasses.replace(cfg, ortho_shape=(512, 512))
    models = build_models(params_from_jax(params, "cuda"), cfg)
    ortho, dem, k, aff = _card_inputs(s)
    feats = build_reference_extractor(cfg)(models, ortho)
    fn = build_frame_to_geopose_cached(cfg)
    q = torch.from_numpy(s.frames[0])
    pxy, pr = torch.zeros(2), torch.tensor(-1.0)
    calls = [(q, feats, dem, k, aff, pxy, pr, _noise(i, 512), _scalar(a))
             for i, a in enumerate((20.0, 25.0, -140.0))]
    _replays_equal_eager(
        lambda q, f, d, k_, a, x, r, n, rot: fn(
            models, q.float() / 255.0, f, d, k_, a, prior_xy=x,
            prior_radius=r, noise=n, rotation_deg=rot),
        calls, _same_pose, sticky=(1, 2))


def test_semidense_graph_equals_eager(card):
    """LoFTR's exact-warp frame (the bundled weights, 480x640, 1024
    matches): no host read left in the program, no kernel of the port."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose_semidense,
        build_models,
    )
    from gisnav_tpu_torch.pipeline.runners import SEMIDENSE_CONFIG
    from gisnav_tpu_torch.weights import LOFTR_PATH, load_npz, params_from_jax

    s = _harris_scene()
    cfg = SEMIDENSE_CONFIG
    models = build_models(params_from_jax(load_npz(LOFTR_PATH), "cuda"), cfg)
    ortho, dem, k, aff = _card_inputs(s)
    fn = build_frame_to_geopose_semidense(cfg)
    zoom = _scalar(s.alt_m / s.k[0, 0] / abs(s.crs_affine[2, 2]))
    calls = [(torch.from_numpy(s.frames[i % 2]), ortho, dem,
              _scalar(s.yaws[i % 2]), k, aff, _noise(i, 1024), zoom)
             for i in range(3)]
    reset_launches()
    _replays_equal_eager(
        lambda q, o, d, a, k_, f, n, z: fn(
            models, q.float() / 255.0, o, d, a, k_, f, noise=n, gsd_zoom=z),
        calls, _same_pose, sticky=(1, 2))
    assert not any(LAUNCHES.values())


def test_classical_graphs_equal_eager(card):
    """The classical frame's two graphs (rotate + crop keyed on its
    quadrant, the tail) against the same programs run eagerly, SIFT
    between them: fixes within 1 mm; two yaws of one quadrant replay."""
    from gisnav_tpu_torch.features.sift import (
        extract_sift_batch,
        pad_features,
    )
    from gisnav_tpu_torch.pipeline import classical
    from gisnav_tpu_torch.pipeline.geopose import PipelineConfig

    s = _harris_scene(map_side=1024)
    cfg = PipelineConfig(image_shape=(480, 640), max_keypoints=1024)
    classical.GRAPHS.clear()
    ortho = torch.as_tensor(s.ortho, device="cuda")
    dem = torch.as_tensor(s.dem, device="cuda")
    for i, yaw in ((0, 10.0), (1, 40.0), (0, -20.0)):
        gen = torch.Generator(device="cuda").manual_seed(i + 1)
        pose = classical.classical_frame_to_geopose(
            s.frames[i], ortho, dem, yaw, s.k, s.crs_affine, cfg,
            generator=gen)
        ref_img, dem_crop, m_crop = classical.warp_program((480, 640), 0)(
            ortho, dem, torch.tensor(np.float32(yaw), device="cuda"))
        raw = extract_sift_batch(torch.stack([
            torch.as_tensor(s.frames[i], device="cuda"), ref_img]), 1024)
        fq, fr = (pad_features(*r, 1024) for r in raw)
        _, _, k, aff = _card_inputs(s)
        want = classical._device_tail(cfg)(
            fq.keypoints, fq.descriptors, fq.mask, fr.keypoints,
            fr.descriptors, fr.mask, dem_crop, m_crop, k, aff,
            noise=_noise(i + 1, 1024))
        _same_pose(pose, want)
    graphs = [g for key, g in classical.GRAPHS.items()
              if key[1] == torch.device("cuda")]
    assert {g.replays for g in graphs} == {2}
    with pytest.raises(ValueError, match="sample_idx"):
        classical.classical_frame_to_geopose(
            s.frames[0], ortho, dem, 10.0, s.k, s.crs_affine, cfg,
            sample_idx=torch.zeros((64, 4), dtype=torch.int64))


@pytest.mark.parametrize("backend", ["ekf", "ukf"])
def test_filter_step_graphs_equal_eager(card, backend):
    """Each of the backend's three steps captured, replayed on new inputs
    (``dt``, ``z``, ``r_diag``, ``mask``, the threshold) and run eagerly:
    ``x`` and ``P`` within 1e-6 relative; ``jacfwd`` and the ``_ex``
    factorisations capture."""
    from gisnav_tpu_torch.fusion import ekf, ukf
    from gisnav_tpu_torch.fusion.ekf import EKFState

    fns = {"ekf": (ekf.ekf_predict, ekf.ekf_update_pose,
                   ekf.ekf_update_velocity),
           "ukf": (ukf.ukf_predict, ukf.ukf_update_pose,
                   ukf.ukf_update_velocity)}[backend]
    rng = np.random.default_rng(0)
    x = torch.tensor(np.r_[120.0, -40.0, 300.0, 0.05, -0.03, 1.2,
                           rng.normal(0, 1, 9)].astype(np.float32))
    a = rng.normal(0, 0.1, (15, 15))
    p = torch.tensor((a @ a.T + 0.5 * np.eye(15)).astype(np.float32))
    q = torch.linspace(0.01, 0.06, 15, device="cuda")
    r = torch.tensor([4.0, 4.0, 9.0, 0.003, 0.003, 0.003])

    def close(got, want):
        for g, w in zip(got, want):
            assert (g - w).abs().max() <= 1e-6 * w.abs().max() + 1e-12

    _replays_equal_eager(
        lambda x, p, dt, q: fns[0](EKFState(x, p), dt, q),
        [(x, p, _scalar(dt), q) for dt in (0.25, 0.1, 0.5)], close,
        sticky=(3,))
    for f, first in ((fns[1], 0), (fns[2], 6)):
        calls = [(x, p, x[first:first + 6] + 0.1 * i, r,
                  torch.tensor([1.0, 1, 1, 0, 1, 1]), _scalar(thr))
                 for i, thr in enumerate((0.0, 3.0, 1e-3))]
        _replays_equal_eager(
            lambda x, p, *a, f=f: f(EKFState(x, p), *a), calls, close)


@pytest.mark.parametrize("kind", ["chunk", "cached_regime", "loftr", "host"])
def test_train_graphs_equal_eager_and_draw_new_pairs(card, kind,
                                                     monkeypatch):
    """Two states from one init and two generators from one seed: three
    graphed chunks (the first the warm-up, two replays) against three eager
    ones give the same losses (1e-5 relative) and leave the generators in
    the same state; the pairs a replay draws (read from the graph's own
    memory) differ from the last replay's. The host-data step: three
    graphed steps on three batches against eager steps."""
    import dataclasses

    from gisnav_tpu_torch.train import device_data, loftr_steps, steps

    seen = []
    batch, asym = device_data.device_batch, device_data.device_batch_asymmetric

    def tapped(fn):
        def draw(*a, **kw):
            pairs = fn(*a, **kw)
            seen.append(pairs[0][0, :4, :4])
            return pairs
        return draw

    monkeypatch.setattr(device_data, "device_batch", tapped(batch))
    monkeypatch.setattr(device_data, "device_batch_asymmetric", tapped(asym))
    cfg = steps.TrainConfig(lightglue_depth=1)
    if kind == "loftr":
        cfg = loftr_steps.LoFTRTrainConfig(depth=1, max_matches=64)

    def make():
        if kind == "loftr":
            st, tx = loftr_steps.init_loftr_train_state(
                torch.Generator().manual_seed(0), cfg, "cuda")
            return st, loftr_steps.make_loftr_device_train_chunk(
                cfg, tx, 2, chunk=2)
        c = dataclasses.replace(cfg, detector_mode="harris") \
            if kind == "cached_regime" else cfg
        st, tx = steps.init_train_state(torch.Generator().manual_seed(0), c,
                                        "cuda")
        if kind == "cached_regime":
            return st, steps.make_cached_regime_chunk(
                steps.CachedRegimeConfig(lightglue_depth=1), tx, 2, chunk=2)
        if kind == "host":
            return st, steps.make_train_step(cfg, tx)
        return st, steps.make_device_train_chunk(cfg, tx, 2, chunk=2)

    (g_state, g_fn), (e_state, e_fn) = make(), make()
    if kind == "host":
        from gisnav_tpu_torch.train.data import make_homography_batch

        rng = np.random.default_rng(0)
        for _ in range(3):
            b = [torch.as_tensor(a, device="cuda") for a in
                 make_homography_batch(rng, 2, cfg.image_shape)]
            _, gm = g_fn(g_state, *b)
            _, em = g_fn.eager(e_state, *b)
            assert abs(float(gm["loss"]) - float(em["loss"])) <= \
                1e-5 * abs(float(em["loss"]))
        assert int(g_state.step) == 3
        # a state rebuilt around another step counter is captured anew
        restarted = g_state._replace(step=torch.zeros_like(g_state.step))
        g_fn(restarted, *b)
        assert int(restarted.step) == 1 and int(g_state.step) == 3
        assert len(g_fn.graphs) == 2
        return
    gens = [torch.Generator(device="cuda") for _ in range(2)]
    for g in gens:
        g.manual_seed(5)
    drawn = []
    for i in range(3):
        _, gm = g_fn(g_state, gens[0])
        if i == 0:
            tap = seen[-1]  # the capture's last pairs: the graph's memory
        replayed = tap.clone()
        _, em = g_fn.eager(e_state, gens[1])
        assert abs(float(gm["loss"]) - float(em["loss"])) <= \
            1e-5 * abs(float(em["loss"]))
        if i:  # a replay drew what the eager chunk drew
            torch.testing.assert_close(replayed, seen[-1], rtol=0,
                                       atol=1e-6)
            drawn.append(replayed)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    assert not torch.equal(drawn[0], drawn[1])
    assert int(g_state.step) == 6 and int(e_state.step) == 6
    (graph,) = g_fn.graphs.values()
    assert graph.replays == 2


def optax_adamw_f32(params, grads, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """``optax.adamw(lr, weight_decay=wd)`` applied to ``params`` once for
    each gradient list in ``grads``, in numpy f32 as optax's update runs
    (``scale_by_adam`` with the bias corrections of an int32 count, the
    decay on the old parameter, then ``-lr``), for a machine without JAX;
    ``tests/test_torch_train_losses.py`` holds it against optax."""
    f = np.float32
    ps = [np.asarray(a, np.float32) for a in params]
    mu = [np.zeros_like(a) for a in ps]
    nu = [np.zeros_like(a) for a in ps]
    for t, gs in enumerate(grads, start=1):
        bc1, bc2 = f(1) - f(b1) ** f(t), f(1) - f(b2) ** f(t)
        for i, g in enumerate(gs):
            g = np.asarray(g, np.float32)
            mu[i] = f(1 - b1) * g + f(b1) * mu[i]
            nu[i] = f(1 - b2) * (g * g) + f(b2) * nu[i]
            upd = (mu[i] / bc1) / (np.sqrt(nu[i] / bc2) + f(eps))
            ps[i] = ps[i] + f(-lr) * (upd + f(wd) * ps[i])
    return ps


def test_capturable_adamw_matches_optax(card):
    """The card's ``train.steps.AdamW`` (built ``capturable``: step count
    and bias corrections in f32 on the device) against ``optax.adamw``:
    three updates on fixed gradients, 1e-6 as the CPU's is held
    (``tests/test_torch_train_losses.py``); optax itself where JAX is
    installed, else its f32 transcription ``optax_adamw_f32``."""
    from gisnav_tpu_torch.train import steps as TS

    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(7, 5)).astype(np.float32),
          rng.normal(size=(11,)).astype(np.float32)]
    grads = [[rng.normal(size=a.shape).astype(np.float32) for a in p0]
             for _ in range(3)]
    try:
        import jax.numpy as jnp
        import optax
    except ImportError:
        want = optax_adamw_f32(p0, grads, 1e-3, 1e-2)
    else:
        tx = optax.adamw(1e-3, weight_decay=1e-2)
        jp = [jnp.asarray(a) for a in p0]
        opt = tx.init(jp)
        for g in grads:
            upd, opt = tx.update([jnp.asarray(a) for a in g], opt, jp)
            jp = optax.apply_updates(jp, upd)
        want = [np.asarray(a) for a in jp]
    tp = {"a": torch.nn.Parameter(torch.tensor(p0[0], device="cuda")),
          "b": torch.nn.Parameter(torch.tensor(p0[1], device="cuda"))}
    opt = TS.AdamW(1e-3, weight_decay=1e-2).init(tp)
    assert opt.defaults["capturable"]
    for g in grads:
        for leaf, gl in zip(TS.tree_leaves(tp), g):
            leaf.grad = torch.tensor(gl, device="cuda")
        opt.step()
    for a, b in zip(TS.tree_leaves(tp), want):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("shift", [0.41421356, -0.41421356, 0.70710678,
                                   -0.70710678, 0.0, 0.123])
def test_shear_kernels_read_their_shift_from_the_card(card, shift):
    """K6 with its shift in device memory (a graphed rotation's residual
    shears, up to tan 22.5 deg and sin 45 deg) against the plain versions,
    bit for bit, and inside a captured graph that replays new shifts."""
    from gisnav_tpu_torch.pipeline.graph import FrameGraph
    from gisnav_tpu_torch.raster.shear_kernel import (
        shear_first_axis,
        shear_first_axis_plain,
        shear_last_axis,
        shear_last_axis_plain,
    )

    img = torch.rand((2, 512, 768), generator=card, device="cuda")
    s = torch.tensor(np.float32(shift), device="cuda")
    for kernel, plain in ((shear_last_axis, shear_last_axis_plain),
                          (shear_first_axis, shear_first_axis_plain)):
        assert torch.equal(kernel(img, s, 255.0), plain(img, s, 255.0))
        assert torch.equal(kernel(img, s, 255.0), kernel(img, float(s),
                                                         255.0))
    program = FrameGraph(lambda im, a: shear_first_axis(
        shear_last_axis(im, a, 255.0), a, 383.0), "cuda", sticky=(0,))
    program(img, torch.tensor(0.3))
    got = program(img, torch.tensor(np.float32(shift)))
    want = shear_first_axis_plain(shear_last_axis_plain(img, s, 255.0), s,
                                  383.0)
    assert torch.equal(got, want)
    bad = shear_last_axis(img, torch.tensor(1.5, device="cuda"), 255.0)
    assert torch.isnan(bad).all()


def test_capture_survives_cyclic_garbage(card):
    """Old captured graphs in reference cycles, with the cyclic collector
    set to run at almost every allocation: a new program still captures
    (the collector is paused during a capture, since an old graph destroyed
    inside it breaks the capture) and replays."""
    import gc

    from gisnav_tpu_torch.pipeline.graph import FrameGraph

    x = torch.ones(8, device="cuda")

    def garbage():
        old = FrameGraph(lambda a: a * 2.0, "cuda")
        old(x)
        old(x)  # captured, then replayed
        old.cycle = old  # freed only by the cyclic collector

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        for _ in range(4):
            garbage()
        program = FrameGraph(lambda a: (a + 1.0).sum(), "cuda")
        program(x)
        assert float(program(x)) == 16.0 and program.replays == 1
    finally:
        gc.set_threshold(*thresholds)


# --- the (data, model) mesh ------------------------------------------------


def _mesh_streams(n):
    """harris_lg5 cached at 480x640 on path 4's scene, ``n`` streams from
    their own points (yaws 360 / n apart), the batch on cuda:0."""
    import dataclasses

    from gisnav_tpu_torch.pipeline.geopose import (
        build_models,
        build_reference_extractor,
    )
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled, params_from_jax

    s = render_scene(seed=6, h=480, w=640,
                     yaws=[i * 360.0 / n for i in range(n)], map_side=800,
                     coverage=3.0, offset_m=22.2)
    params, cfg = load_bundled("harris_lg5")
    cfg = dataclasses.replace(cfg, ortho_shape=s.ortho.shape,
                              detector_downsample=2)
    dev = "cuda"
    tree = params_from_jax(params, dev)
    ref = build_reference_extractor(cfg)(
        build_models(tree, cfg),
        torch.as_tensor(s.ortho, device=dev).float() / 255.0)
    k, aff = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
              for a in (s.k, s.crs_affine))
    batch = (torch.stack([torch.as_tensor(f, device=dev).float() / 255.0
                          for f in s.frames]),
             type(ref)(*(torch.stack([f] * n) for f in ref)),
             torch.stack([torch.as_tensor(s.dem, device=dev)] * n),
             torch.stack([k] * n), torch.stack([aff] * n))
    return s, cfg, tree, batch


def test_mesh_tick_on_card_tp2_vs_tp1(card):
    """A (2 x 2) mesh laid over cuda:0 slot by slot: each row replays one
    graph; TP2 within JAX's bound of TP1 (lon/lat 2e-5, ``valid`` equal),
    TP1 equal to the single-device tick, every fix within 10 m of its own
    truth, and a tick launching four frames' kernels."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.parallel import make_mesh, shard_params_tp
    from gisnav_tpu_torch.pipeline.geopose import (
        build_models,
        geopose_to_wgs84_f64,
    )
    from gisnav_tpu_torch.pipeline.multistream import (
        build_mesh_multistream_pipeline,
        build_multistream_pipeline,
        shard_stream_batch,
    )

    n = 4
    s, cfg, tree, batch = _mesh_streams(n)

    def gens():
        return [torch.Generator(device="cuda").manual_seed(i + 10)
                for i in range(n)]

    outs = {}
    for model in (1, 2):
        mesh = make_mesh(2 * model, model_parallel=model,
                         devices=[torch.device("cuda", 0)] * 4)
        rows = [build_models(t, cfg) for t in shard_params_tp(mesh, tree)]
        fn = build_mesh_multistream_pipeline(cfg)
        blocks = shard_stream_batch(mesh, batch)
        fn(mesh, rows, blocks, gens())  # captures
        reset_launches()
        outs[model] = fn(mesh, rows, blocks, gens())
        assert fn.modes == {0: "graph", 1: "graph"}
        assert LAUNCHES == {k: {"stem_stage": 1, "conv_stage": 7,
                                "nms_select": 1, "fused_block": 40}.get(k, 0)
                            * n for k in LAUNCHES}
    single = build_multistream_pipeline(cfg)
    models = build_models(tree, cfg)
    single(models, *batch, gens())
    want = single(models, *batch, gens())
    for f in ("matched_qry", "matched_ref", "num_inliers", "valid"):
        assert torch.equal(getattr(outs[1], f), getattr(want, f)), f
    torch.testing.assert_close(outs[2].lon_lat_alt[:, :2],
                               outs[1].lon_lat_alt[:, :2], rtol=0,
                               atol=2e-5)
    assert torch.equal(outs[2].valid, outs[1].valid)
    for i, (lon, lat) in enumerate(s.truth_lonlat):
        fix = geopose_to_wgs84_f64(type(outs[2])(*(f[i] for f in outs[2])),
                                   s.crs_affine)
        assert haversine_m(lat, lon, fix["lat"], fix["lon"]) < 10.0


def test_mesh_train_step_on_card_vs_replicated(card):
    """The train step on a (2 x 2) mesh over cuda:0 (one graph a step)
    against the single-device step on the whole batch (64x80, 256
    keypoints, LightGlue-1, batch 4): loss within 1e-2 relative, every
    parameter within 5 lr, the replicas equal and still sharded, and the
    gradient the update read within 2 % of the replicated step's on its
    worst leaf (relative norm; read 0.0040 on an H100 at 700 W), where
    row 0's block alone (0.55) lies beyond."""
    from gisnav_tpu_torch.parallel import make_mesh
    from gisnav_tpu_torch.parallel.mesh import shard_batch
    from gisnav_tpu_torch.parallel.tp import Sharded, gather_tree
    from gisnav_tpu_torch.train import steps as TS
    from gisnav_tpu_torch.train.data import make_homography_batch

    cfg = TS.TrainConfig(image_shape=(64, 80), max_keypoints=256,
                         lightglue_depth=1, learning_rate=3e-4)

    def fresh():
        state, tx = TS.init_train_state(torch.Generator().manual_seed(0),
                                        cfg, device="cuda")
        return state, tx

    batch = make_homography_batch(np.random.default_rng(0), 4,
                                  cfg.image_shape)
    args = tuple(torch.as_tensor(np.asarray(a), device="cuda")
                 for a in batch)
    state, tx = fresh()
    state, m = TS.make_train_step(cfg, tx)(state, *args)
    mesh = make_mesh(4, model_parallel=2,
                     devices=[torch.device("cuda", 0)] * 4)
    step = TS.make_mesh_train_step(cfg, tx)
    mstate = TS.shard_train_state(mesh, fresh()[0], tx)
    mstate, mm = step(mstate, shard_batch(mesh, args))
    assert len(step.graphs) == 1
    assert abs(float(mm["loss"]) - float(m["loss"])) <= 1e-2 * abs(
        float(m["loss"]))
    with torch.no_grad():
        rows = [gather_tree(r.params) for r in mstate.rows]
        for a, b in zip(TS.tree_leaves(rows[0]),
                        TS.tree_leaves(state.params)):
            assert float((a - b).abs().max()) < 5 * cfg.learning_rate
    want = TS.tree_leaves(TS.tree_grads(state.params))

    def worst_grad(params):
        return max(TS.relative_error(a, b) for a, b in zip(
            TS.tree_leaves(gather_tree(TS.tree_grads(params))), want))

    row0_state = fresh()[0]
    TS.make_train_step(cfg, tx).eager(row0_state,
                                      *shard_batch(mesh, args)[0])
    got = [worst_grad(r.params) for r in mstate.rows]
    print(f"gradient's worst leaf {got}, row 0's block alone "
          f"{worst_grad(row0_state.params)}")
    assert max(got) < 0.02 < worst_grad(row0_state.params)
    for row, tree in zip(mstate.rows, rows):
        assert int(row.step) == 1
        for a, b in zip(TS.tree_leaves(tree), TS.tree_leaves(rows[0])):
            assert torch.equal(a, b)
        assert isinstance(row.params["lightglue"]["final_proj"]["weight"],
                          Sharded)


def test_side_streams_skip_the_capture_stream(card):
    """PyTorch hands out a pool of 32 streams a card in turn, so a stream
    asked for later comes round to the capture stream; a program's forked
    branches never land on it."""
    from gisnav_tpu_torch.pipeline.graph import capture_stream, side_streams

    cap = capture_stream("cuda")
    assert any(torch.cuda.Stream("cuda") == cap for _ in range(64))
    streams = side_streams("cuda", 40)
    assert len(streams) == 40 and cap not in streams
    assert len({s.cuda_stream for s in streams[:31]}) == 31


def _second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    return torch.device("cuda", 1)


def _kernel_case(name, gen, dev):
    """(kernel call, plain call, tolerance) on ``dev``'s tensors."""
    def r(shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(dtype).contiguous()

    bf = torch.bfloat16
    if name in ("conv_stage", "stem_stage"):
        from gisnav_tpu_torch.features import conv

        def w(cin, cout):
            return (r((9, cin, cout), (2.0 / (9 * cin)) ** 0.5, bf),
                    r((cout,), 0.05))

        if name == "stem_stage":
            img = torch.rand((64, 96), generator=gen, device=dev)
            args = (img, *w(1, 64), *w(64, 64))
            return (lambda: conv.stem_stage(*args),
                    lambda: conv.stem_stage_plain(*args), "bf16")
        x = torch.rand((48, 80, 64), generator=gen, device=dev).to(bf)
        args = (x, *w(64, 128), *w(128, 128))
        return (lambda: conv.conv_stage(*args, pool=True),
                lambda: conv.conv_stage_plain(*args, pool=True), "bf16")
    if name in ("nms_select", "nms_cellmax"):
        from gisnav_tpu_torch.features import nms_kernel as nk

        heat = torch.rand((96, 384), generator=gen, device=dev) ** 8
        return (lambda: getattr(nk, name)(heat, 4),
                lambda: getattr(nk, name + "_plain")(heat, 4), 1e-4)
    if name == "fused_block":
        from gisnav_tpu_torch.matching.lightglue_fused import (
            fused_block,
            fused_block_plain,
        )

        n, dim = 256, 256
        x = r((2 * n, dim))
        q, k, v = (r((2 * n, dim), 1.0, bf) for _ in range(3))
        bias = torch.where(torch.rand((2, n), generator=gen, device=dev)
                           < 0.9, 0.0, -1e9).float()
        ws = [r((dim, dim), dim ** -0.5, bf), r((dim,), 0.05),
              r((dim, 2 * dim), (2 * dim) ** -0.5, bf),
              r((dim, 2 * dim), (2 * dim) ** -0.5, bf), r((2 * dim,), 0.05),
              1.0 + r((2 * dim,), 0.1), r((2 * dim,), 0.1),
              r((2 * dim, dim), (2 * dim) ** -0.5, bf), r((dim,), 0.05)]
        args = (x, q, k, v, bias, *ws)
        return (lambda: fused_block(*args, heads=4, sets=2, cross=True),
                lambda: fused_block_plain(*args, heads=4, sets=2,
                                          cross=True), 5e-2)
    if name == "masked_attention":
        from gisnav_tpu_torch.matching.attention import (
            masked_attention,
            masked_attention_plain,
        )

        q, k, v = (r((n, 4, 64)) for n in (256, 384, 384))
        mask = torch.rand((384,), generator=gen, device=dev) > 0.33
        return (lambda: masked_attention(q, k, v, mask),
                lambda: masked_attention_plain(q, k, v, mask), "rel")
    from gisnav_tpu_torch.raster import shear_kernel as sk

    # the sheared axis at least 384 long, the other a multiple of 128
    shape = (2, 256, 384) if name == "shear_last_axis" else (2, 384, 256)
    img = torch.rand(shape, generator=gen, device=dev)
    return (lambda: getattr(sk, name)(img, 0.41, 128.0),
            lambda: getattr(sk, name + "_plain")(img, 0.41, 128.0), 0.0)


@pytest.mark.parametrize("name", ["stem_stage", "conv_stage", "nms_select",
                                  "nms_cellmax", "fused_block",
                                  "masked_attention", "shear_last_axis",
                                  "shear_first_axis"])
def test_kernel_wrapper_on_second_card(card, name):
    """Each kernel wrapper on cuda:1's tensors while cuda:0 is current:
    the launch runs on the tensors' card (its attributes and grid there)
    and agrees with its plain version as on cuda:0."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches

    dev = _second_card()
    gen = torch.Generator(device=dev).manual_seed(1)
    kernel, plain, tol = _kernel_case(name, gen, dev)
    torch.cuda.set_device(0)
    reset_launches()
    got, want = kernel(), plain()
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert LAUNCHES[name] > 0
    for g, w in zip(*(o if isinstance(o, (tuple, list)) else (o,)
                      for o in (got, want))):
        assert g.device == dev
        if tol == "bf16":
            _close_bf16(g, w)
        elif tol == "rel":
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=1e-2 * float(w.abs().max()))
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=tol)
