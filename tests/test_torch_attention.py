"""Masked attention of the port (K5) against the JAX package.

- ``masked_attention_plain`` (what a CPU tensor runs) against the TPU kernel
  ``masked_attention_pallas`` in Pallas interpret mode: atol 2e-2 on the f32
  output (both round q/k/v and the normalised probabilities to bf16 at the
  same points; sums in another order can move a bf16 probability by one ulp).
- against the einsum branch of ``lightglue._attention``, which JAX runs on
  the CPU and for unsupported shapes: same tolerance.
- the port's own einsum branch (shapes outside the predicate) against the
  JAX one: same tolerance.
- ``attention_supported`` equals ``pallas_attention_supported`` on a grid.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gisnav_tpu.matching import lightglue as jlg
from gisnav_tpu.matching.pallas_attention import (
    masked_attention_pallas,
    pallas_attention_supported,
)
from gisnav_tpu_torch.matching import lightglue as tlg
from gisnav_tpu_torch.matching.attention import (
    attention_supported,
    masked_attention,
    masked_attention_plain,
)

torch.set_num_threads(2)


def _inputs(seed, kq, kk, d, heads=4):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (n, heads, d)).astype(np.float32)
               for n in (kq, kk, kk))
    mask = rng.random(kk) > 0.33
    return q, k, v, mask


@pytest.mark.parametrize("kk,d", [(128, 32), (128, 64), (384, 32),
                                  (384, 64)])
def test_plain_vs_pallas_interpret(kk, d):
    q, k, v, mask = _inputs(kk + d, 256, kk, d)
    got = masked_attention(*(torch.as_tensor(a) for a in (q, k, v, mask)))
    assert got.dtype == torch.float32 and got.shape == (256, 4, d)
    with pltpu.force_tpu_interpret_mode():
        ref = masked_attention_pallas(*(jnp.asarray(a)
                                        for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("kq,kk", [(256, 384), (200, 330)])
def test_vs_jax_einsum_branch(kq, kk):
    """(256, 384) is inside the predicate (the port runs the kernel's plain
    version), (200, 330) outside it (the port runs its einsum branch)."""
    q, k, v, mask = _inputs(kq, kq, kk, 64)
    ref = jlg._attention(*(jnp.asarray(a) for a in (q, k, v, mask)),
                         jnp.bfloat16)
    t = [torch.as_tensor(a) for a in (q, k, v, mask)]
    assert attention_supported(kq, kk, 64) == (kq == 256)
    np.testing.assert_allclose(tlg._attention(*t).numpy(), np.asarray(ref),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(masked_attention_plain(*t).numpy(),
                               np.asarray(ref), atol=2e-2, rtol=0)


def test_all_keys_masked_is_finite():
    q, k, v, _ = _inputs(3, 256, 128, 64)
    out = masked_attention(torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v),
                           torch.zeros(128, dtype=torch.bool))
    assert torch.isfinite(out).all()


def test_predicate_equals_jax():
    grid = itertools.product((128, 256, 384, 512, 768, 1792, 2048, 3584),
                             (64, 128, 192, 384, 1792, 4096, 8192, 16384,
                              32768), (16, 32, 64, 96, 128, 256))
    n = 0
    for kq, kk, d in grid:
        assert attention_supported(kq, kk, d) == \
            pallas_attention_supported(kq, kk, d), (kq, kk, d)
        n += attention_supported(kq, kk, d)
    assert n > 20


def test_unsupported_shape_raises():
    q, k, v, mask = (torch.as_tensor(a) for a in _inputs(4, 192, 128, 64))
    with pytest.raises(ValueError, match="unsupported"):
        masked_attention(q, k, v, mask)


@pytest.mark.parametrize("kq,kk,heads,want", [
    (1792, 1792, 4, 4), (1792, 3584, 4, 4), (3584, 3584, 4, 2),
    (3584, 1792, 4, 2), (256, 128, 4, 2), (256, 1024, 1, 8),
    (8192, 4096, 4, 1)])
def test_key_splits_fill_the_card(kq, kk, heads, want):
    """The kernel's key split on a 132-SM card: at least three 4-warp blocks
    an SM where the keys allow (so over 8 warps an SM at 1792 x 3584), a
    power of two up to 8, never more splits than 64-key tiles."""
    from gisnav_tpu_torch.matching.attention import key_splits

    splits = key_splits(kq, kk, heads, 132)
    assert splits == want
    assert splits <= kk // 64
    blocks = (kq // 64) * heads * splits
    assert blocks * 4 >= 8 * 132 or splits in (8, kk // 64)


@pytest.mark.parametrize("splits", [2, 4, 8])
def test_split_key_merge_is_the_unsplit_softmax(splits):
    """The kernel's arithmetic over split keys, written out in PyTorch: each
    split's (max, sum) merged as m = max m_s, l = sum l_s exp(m_s - m), P
    rounded to bf16 with the merged statistics, the splits' P.V added. Equals
    the plain version up to single bf16 flips of a probability (an f32 ulp in
    the merged sum can move a p of ~1e-2 across a rounding point: one bf16
    ulp, 4e-5, times |v| up to ~4; atol 2e-4, a hundredth of the kernel
    tolerance), so splitting the keys keeps the reference's rounding of P."""
    q, k, v, mask = (torch.as_tensor(a) for a in _inputs(5, 256, 512, 32))
    bf = torch.bfloat16
    qh, kh, vh = (t.to(bf).float().transpose(0, 1) for t in (q, k, v))
    logits = qh @ kh.transpose(1, 2) * 32 ** -0.5 + torch.where(
        mask, 0.0, -1e9)
    parts = logits.chunk(splits, dim=-1)
    m_s = torch.stack([p.amax(-1) for p in parts])
    l_s = torch.stack([torch.exp(p - p.amax(-1, keepdim=True)).sum(-1)
                       for p in parts])
    m = m_s.amax(0)
    l = (l_s * torch.exp(m_s - m)).sum(0)
    out = sum((torch.exp(p - m[..., None]) / l[..., None]).to(bf).float() @ vv
              for p, vv in zip(parts, vh.chunk(splits, dim=1)))
    want = masked_attention_plain(q, k, v, mask)
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), want.numpy(),
                               rtol=0, atol=2e-4)
