"""Gradients of the port's kernels against the JAX package's.

- K5 (``MaskedAttention``: the kernel forward, the analytic backward)
  against ``jax.vjp`` of ``masked_attention_pallas`` in Pallas interpret
  mode, which runs its ``custom_vjp`` (``_attention_bwd``): f32 and bf16
  inputs, and the pair axis against ``jax.vmap`` of the kernel. Both
  backwards are the same f32 arithmetic from the same unrounded q and k, so
  the tolerance is f32 sums in another order: 1e-4 of the largest |value|
  plus 1e-4 of the value, and one bf16 ulp (up to 2^-7 of the value)
  where a gradient is bf16.
- Shapes outside the predicate: the einsum form under autograd against
  JAX's autodiff of the JAX module's einsum branch, 2e-2 of the largest
  |gradient| (the two round the bf16 casts' cotangents at other points).
- K1, K2 and K4 (backward through the plain version) against ``jax.grad``
  through the JAX wrappers (``custom_vjp`` through the XLA mirror), with
  respect to every input: 2e-2 of the largest |gradient| of each (the port
  keeps bf16 weights and so bf16 weight gradients; one bf16 ulp is 2^-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gisnav_tpu.features import pallas_conv as pc
from gisnav_tpu.matching import lightglue as jlg
from gisnav_tpu.matching import lightglue_fused as jlf
from gisnav_tpu.matching.pallas_attention import masked_attention_pallas
from gisnav_tpu_torch.features import conv as tc
from gisnav_tpu_torch.matching import lightglue_fused as tlf
from gisnav_tpu_torch.matching.attention import (
    MaskedAttention,
    attention_with_grad,
    masked_attention,
)

torch.set_num_threads(2)


def _bf(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _attn_inputs(seed, lead, kq, kk, d=64, heads=4):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(0, 1, (*lead, n, heads, d)).astype(np.float32)
                  for n in (kq, kk, kk, kq))
    mask = rng.random((*lead, kk)) > 0.3
    return q, k, v, mask, g


def _port_grads(fn, arrays, dtypes, mask, g):
    leaves = [torch.as_tensor(a).to(dt).requires_grad_()
              for a, dt in zip(arrays, dtypes)]
    out = fn(*leaves, torch.as_tensor(mask))
    out.backward(torch.as_tensor(g))
    return out.detach(), [t.grad for t in leaves]


def _assert_grad(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    bad = np.abs(got - want) > 1e-4 * np.abs(want).max() + rel * np.abs(
        want)
    assert not bad.any(), (np.abs(got - want).max(), bad.sum())


@pytest.mark.parametrize("kq,kk,cross", [(256, 256, False),
                                         (256, 384, True),
                                         (512, 256, False)])
def test_masked_attention_grad_vs_pallas_custom_vjp(kq, kk, cross):
    """Self block: q, k f32 (after the rotary), v bf16; cross block: all
    bf16 (the gradients come back rounded to bf16)."""
    q, k, v, mask, g = _attn_inputs(kq + kk, (), kq, kk)
    if cross:
        q, k = _bf(q), _bf(k)
    v = _bf(v)
    dts = [torch.bfloat16 if cross else torch.float32] * 2 + [
        torch.bfloat16]
    out, grads = _port_grads(MaskedAttention.apply, (q, k, v), dts, mask, g)
    jdt = [jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
           for dt in dts]
    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(
            lambda a, b, c: masked_attention_pallas(a, b, c,
                                                    jnp.asarray(mask)),
            *(jnp.asarray(a).astype(t) for a, t in zip((q, k, v), jdt)))
        jgrads = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=0)
    for got, want, dt in zip(grads, jgrads, dts):
        assert got.dtype == dt
        _assert_grad(got, want, dt)


def test_masked_attention_grad_pair_axis_vs_vmap():
    """The pair axis against jax.vmap of the kernel (the JAX step's
    vmap over pairs), and each pair's forward bit-equal to its own call."""
    q, k, v, mask, g = _attn_inputs(5, (3,), 256, 256)
    v = _bf(v)
    dts = [torch.float32, torch.float32, torch.bfloat16]
    out, grads = _port_grads(MaskedAttention.apply, (q, k, v), dts, mask, g)
    for i in range(3):
        single = masked_attention(torch.as_tensor(q[i]),
                                  torch.as_tensor(k[i]),
                                  torch.as_tensor(v[i]).bfloat16(),
                                  torch.as_tensor(mask[i]))
        assert torch.equal(single, out[i])
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax.vmap(masked_attention_pallas),
                         jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v).astype(jnp.bfloat16),
                         jnp.asarray(mask))
        jgrads = vjp(jnp.asarray(g))[:3]
    for got, want, dt in zip(grads, jgrads, dts):
        _assert_grad(got, want, dt)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_attention_grad_outside_predicate_vs_jax_einsum(lead):
    """(200, 330) is outside the kernel's shapes: the port differentiates
    its einsum form, JAX its einsum branch."""
    q, k, v, mask, g = _attn_inputs(11, lead, 200, 330)
    dts = [torch.float32, torch.float32, torch.bfloat16]
    v = _bf(v)
    out, grads = _port_grads(attention_with_grad, (q, k, v), dts, mask, g)

    def jfn(a, b, c, m):
        return jlg._attention(a, b, c, m, jnp.bfloat16)

    if lead:
        jfn = jax.vmap(jfn)
    _, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, jnp.asarray(mask)),
                     jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v).astype(jnp.bfloat16))
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err


def _rel_close(got, want, rel=2e-2):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _conv_w(rng, cin, cout):
    w = rng.normal(0, (2.0 / (9 * cin)) ** 0.5, (3, 3, cin, cout))
    return _bf(w.astype(np.float32)), rng.normal(0, 0.05, cout).astype(
        np.float32)


def _port_w(w):
    return torch.as_tensor(w.reshape(9, w.shape[2], w.shape[3])).to(
        torch.bfloat16)


def _grads_torch(fn, inputs, g):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(torch.as_tensor(g).to(out.dtype))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("pool", [True, False])
def test_stem_stage_grad_vs_jax(pool):
    rng = np.random.default_rng(2)
    img = rng.random((32, 48)).astype(np.float32)
    w1a, b1a = _conv_w(rng, 1, 64)
    w1b, b1b = _conv_w(rng, 64, 64)
    hh, ww = (16, 24) if pool else (32, 48)
    g = rng.normal(0, 1, (hh, ww, 64)).astype(np.float32)
    got = _grads_torch(lambda *a: tc.stem_stage(*a, pool=pool),
                       [torch.as_tensor(img), _port_w(w1a),
                        torch.as_tensor(b1a), _port_w(w1b),
                        torch.as_tensor(b1b)], g)
    jargs = [jnp.asarray(a) for a in (img, w1a, b1a, w1b, b1b)]
    _, vjp = jax.vjp(lambda *a: pc.stem_stage(*a, pool), *jargs)
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    for i, (a, b) in enumerate(zip(got, want)):
        if i in (1, 3):  # (9, Cin, Cout) against HWIO
            b = jnp.reshape(b, a.shape)
        _rel_close(a, b)


@pytest.mark.parametrize("double,pool", [(True, True), (False, False)])
def test_conv_stage_grad_vs_jax(double, pool):
    rng = np.random.default_rng(3)
    x = np.maximum(rng.normal(0, 1, (16, 24, 64)), 0).astype(np.float32)
    x = _bf(x)
    w1, b1 = _conv_w(rng, 64, 128)
    w2, b2 = _conv_w(rng, 128, 128)
    hh, ww = (8, 12) if pool else (16, 24)
    g = rng.normal(0, 1, (hh, ww, 128)).astype(np.float32)
    tin = [torch.as_tensor(x).bfloat16(), _port_w(w1), torch.as_tensor(b1)]
    jin = [jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w1),
           jnp.asarray(b1)]
    if double:
        tin += [_port_w(w2), torch.as_tensor(b2)]
        jin += [jnp.asarray(w2), jnp.asarray(b2)]
    got = _grads_torch(lambda *a: tc.conv_stage(*a, pool=pool), tin, g)
    _, vjp = jax.vjp(lambda *a: pc.conv_stage(*a, pool=pool), *jin)
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    for i, (a, b) in enumerate(zip(got, want)):
        if i in (1, 3):
            b = jnp.reshape(b, a.shape)
        _rel_close(a, b)


def _block_inputs(seed, n, kk, sets):
    rng = np.random.default_rng(seed)

    def f(shape, scale=1.0):
        return rng.normal(0, scale, shape).astype(np.float32)

    dim = 256
    x = f((sets * n, dim))
    q, k, v = _bf(f((sets * n, dim))), _bf(f((sets * kk, dim))), _bf(
        f((sets * kk, dim)))
    bias = np.where(rng.random((sets, kk)) < 0.85, 0.0, -1e9).astype(
        np.float32)
    w = [_bf(f((dim, dim), dim ** -0.5)), f((1, dim), 0.05),
         _bf(f((dim, 2 * dim), (2 * dim) ** -0.5)),
         _bf(f((dim, 2 * dim), (2 * dim) ** -0.5)), f((1, 2 * dim), 0.05),
         1.0 + f((1, 2 * dim), 0.1), f((1, 2 * dim), 0.1),
         _bf(f((2 * dim, dim), (2 * dim) ** -0.5)), f((1, dim), 0.05)]
    return [x, q, k, v, bias, *w]


_BF = (1, 2, 3, 5, 7, 8, 12)  # bf16 positions in (x, q, k, v, bias, *w)


@pytest.mark.parametrize("sets,cross", [(1, False), (2, False), (2, True)])
def test_fused_block_grad_vs_jax(sets, cross):
    """``fused_block`` covers both JAX entries: ``fused_block`` (sets=1)
    and ``fused_block_dual`` (sets=2, self or cross)."""
    n = 256
    flat = _block_inputs(sets + 5 * cross, n, n, sets)
    g = np.random.default_rng(9).normal(0, 1, (sets * n, 256)).astype(
        np.float32)
    tin = []
    for i, a in enumerate(flat):
        t = torch.as_tensor(a)
        if i >= 5 and t.dim() == 2 and t.shape[0] == 1:
            t = t[0]
        tin.append(t.bfloat16() if i in _BF else t)
    got = _grads_torch(lambda *a: tlf.fused_block(*a, heads=4, sets=sets,
                                                  cross=cross), tin, g)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) if i in _BF
           else jnp.asarray(a) for i, a in enumerate(flat)]
    if sets == 1:
        _, vjp = jax.vjp(lambda *a: jlf.fused_block(*a, 4), *jin)
    else:
        _, vjp = jax.vjp(lambda *a: jlf.fused_block_dual(*a, 4, True, cross),
                         *jin)
    want = vjp(jnp.asarray(g))
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 4:  # the additive key bias: -1e9 entries carry no gradient
            continue
        _rel_close(a, jnp.reshape(b, a.shape))
