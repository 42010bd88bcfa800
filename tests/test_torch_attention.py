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
