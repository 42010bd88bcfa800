"""SuperPoint trunk stages of the port against the JAX package.

The port's plain versions (what a CPU tensor runs) are held against the JAX
routes on the CPU (``stem_stage``/``conv_stage`` reach their XLA references
``stem_reference``/``vgg_stage_reference`` there) and against the TPU
kernels themselves run in Pallas interpret mode. Tolerance: bf16 outputs,
1 bf16 ulp relative plus 1e-2 absolute against the XLA references (sums in
another order can round to the neighbouring bf16). Against the TPU kernels
2 ulp plus 2e-2: they round each conv sum once where the XLA reference and
the port round twice, a one-ulp step in the first conv that the second conv
sums over its 576 taps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gisnav_tpu.features import pallas_conv as pc
from gisnav_tpu_torch.features import conv as tc

torch.set_num_threads(2)

H, W = 32, 64


def _close(got, want, ulps=1, atol=1e-2):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    tol = atol + ulps * 2.0 ** -7 * np.abs(want)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (np.abs(got - want).max(), bad.sum())


def _weights(rng, cin, cout):
    w = rng.normal(0, (2.0 / (9 * cin)) ** 0.5, (3, 3, cin, cout))
    b = rng.normal(0, 0.05, cout)
    return w.astype(np.float32), b.astype(np.float32)


def _port_w(w):
    return torch.as_tensor(w.reshape(9, w.shape[2], w.shape[3])).to(
        torch.bfloat16)


@pytest.mark.parametrize("pool", [True, False])
def test_stem_stage_plain_vs_jax(pool):
    rng = np.random.default_rng(1)
    img = rng.random((H, W)).astype(np.float32)
    w1a, b1a = _weights(rng, 1, 64)
    w1b, b1b = _weights(rng, 64, 64)
    got = tc.stem_stage(torch.as_tensor(img), _port_w(w1a),
                        torch.as_tensor(b1a), _port_w(w1b),
                        torch.as_tensor(b1b), pool=pool)
    assert got.dtype == torch.bfloat16
    jargs = [jnp.asarray(a) for a in (img, w1a, b1a, w1b, b1b)]
    _close(got.float(), pc.stem_stage(*jargs, pool))
    with pltpu.force_tpu_interpret_mode():
        _close(got.float(), pc.stem_stage_pallas(*jargs, pool=pool), 2, 2e-2)


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("h,w", [(36, 52), (18, 34)])
def test_stem_stage_plain_vs_jax_ragged(h, w, pool):
    """Even sizes that are no multiple of the CUDA stem's 8x16 tile (the
    card tests hold the fused kernel against this plain version there):
    against the XLA ``stem_reference``, and against the TPU kernel in
    interpret mode where ``stem_supported`` takes the size."""
    rng = np.random.default_rng(h * w)
    img = rng.random((h, w)).astype(np.float32)
    w1a, b1a = _weights(rng, 1, 64)
    w1b, b1b = _weights(rng, 64, 64)
    got = tc.stem_stage(torch.as_tensor(img), _port_w(w1a),
                        torch.as_tensor(b1a), _port_w(w1b),
                        torch.as_tensor(b1b), pool=pool)
    assert got.shape == ((h // 2, w // 2) if pool else (h, w)) + (64,)
    jargs = [jnp.asarray(a) for a in (img, w1a, b1a, w1b, b1b)]
    _close(got.float(), pc.stem_reference(*jargs, pool=pool))
    if pc.stem_supported(h, w):
        with pltpu.force_tpu_interpret_mode():
            _close(got.float(), pc.stem_stage_pallas(*jargs, pool=pool), 2,
                   2e-2)


@pytest.mark.parametrize("cin,cmid,cout,pool", [
    (64, 64, 64, True),      # stage 2
    (64, 128, 128, True),    # stage 3
    (128, 128, 128, False),  # stage 4
    (128, 256, None, False),  # convPa / convDa
])
def test_conv_stage_plain_vs_jax(cin, cmid, cout, pool):
    rng = np.random.default_rng(cin + cmid)
    x = rng.random((H, W, cin)).astype(np.float32)
    w1, b1 = _weights(rng, cin, cmid)
    w2, b2 = _weights(rng, cmid, cout) if cout else (None, None)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    got = tc.conv_stage(
        xt, _port_w(w1), torch.as_tensor(b1),
        None if w2 is None else _port_w(w2),
        None if b2 is None else torch.as_tensor(b2), pool=pool)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw2 = None if w2 is None else jnp.asarray(w2)
    jb2 = None if b2 is None else jnp.asarray(b2)
    _close(got.float(), pc.conv_stage(jx, jnp.asarray(w1), jnp.asarray(b1),
                                      jw2, jb2, pool))
    if cin in (64, 128):
        with pltpu.force_tpu_interpret_mode():
            _close(got.float(), pc.conv_stage_pallas(
                jx, jnp.asarray(w1), jnp.asarray(b1), jw2, jb2, pool=pool),
                2, 2e-2)
