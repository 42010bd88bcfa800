"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
The module imports neither JAX nor the JAX package, so it runs on a machine
with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as ``chip_smoke.py`` states them: conv bf16 outputs 2 ulp + 0.05
(sums in another order round to neighbouring bf16s), NMS cell maxima exact
and positions 1e-4 px, the LightGlue block 5e-2 on f32 outputs.
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


def test_runner_on_card_goes_through_every_kernel(card):
    import dataclasses

    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_bucketed_warp_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled

    scene = render_scene(seed=4, h=128, w=256, yaws=[0.0])
    params, cfg = load_bundled()
    cfg = dataclasses.replace(cfg, image_shape=(128, 256), max_keypoints=512)
    runner = make_bucketed_warp_runner(params, cfg)
    reset_launches()
    pose = runner(scene.frames[0], scene.ortho, scene.dem, 0.0, scene.k,
                  scene.crs_affine, map_stamp=1, altitude_agl=scene.alt_m)
    assert bool(pose.valid)
    assert np.isfinite(pose.lon_lat_alt.cpu().numpy()).all()
    assert LAUNCHES == {"stem_stage": 4, "conv_stage": 16, "nms_select": 2,
                        "fused_block": 36}
