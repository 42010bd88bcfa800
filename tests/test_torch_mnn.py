"""The port's classical matcher (``matching/mnn.py``) against the JAX
package's, on the same numpy inputs.

- ``root_sift`` to 1e-6;
- ``mnn_ratio_match``: equal ``matches0`` and distances to 1e-5, on seeded
  float descriptors (RootSIFT of random SIFT-like vectors: unit length,
  the float descriptors this system matches, so the f32 distance matrix
  ``|a|^2 + |b|^2 - 2 a.b`` cancels terms of about 1, not of about the
  squared norm of raw vectors) and on integer-valued SIFT-like descriptors with
  planted ties (duplicated train rows, so the first and second neighbour
  tie, and duplicated query rows, so the mutual check sees ties), masked
  and unmasked, with ``mutual`` true and false. Integer descriptors make
  every distance exact in f32, so ties break by index in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.matching import mnn as jmnn
from gisnav_tpu_torch.matching import mnn as tmnn

torch.set_num_threads(2)


def _float_descs(seed, k0=300, k1=260):
    rng = np.random.default_rng(seed)
    d1 = rng.uniform(0, 60, (k1, 128)).astype(np.float32)
    d0 = rng.uniform(0, 60, (k0, 128)).astype(np.float32)
    # half of the queries are noisy copies of train rows: real matches
    d0[: k0 // 2] = d1[rng.integers(0, k1, k0 // 2)] + rng.uniform(
        0, 8, (k0 // 2, 128)).astype(np.float32)
    return (np.asarray(jmnn.root_sift(jnp.asarray(d0))),
            np.asarray(jmnn.root_sift(jnp.asarray(d1))))


def _tied_sift_descs(seed, k0=300, k1=260):
    rng = np.random.default_rng(seed)
    d1 = np.round(rng.uniform(0, 60, (k1, 128))).astype(np.float32)
    d1[k1 // 2:k1 // 2 + 20] = d1[:20]  # train ties: equal first and second
    d0 = d1[rng.integers(0, k1, k0)] + np.round(
        rng.uniform(-2, 2, (k0, 128))).astype(np.float32)
    d0[:20] = d1[:20]  # exact copies of tied train rows
    d0[20:40] = d0[40:60]  # query ties for the mutual check
    return np.clip(d0, 0, 255), d1


def test_root_sift():
    d = np.round(np.random.default_rng(0).uniform(0, 255, (64, 128))
                 ).astype(np.float32)
    d[0] = 0.0  # the L1 floor
    got = tmnn.root_sift(torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmnn.root_sift(
        jnp.asarray(d))), atol=1e-6)


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["float", "tied_sift"])
def test_mnn_ratio_match(kind, masked, mutual):
    d0, d1 = {"float": _float_descs, "tied_sift": _tied_sift_descs}[kind](3)
    m0 = m1 = None
    if masked:
        rng = np.random.default_rng(5)
        m0, m1 = rng.random(len(d0)) > 0.2, rng.random(len(d1)) > 0.2
    want, want_d = jmnn.mnn_ratio_match(
        jnp.asarray(d0), jnp.asarray(d1),
        None if m0 is None else jnp.asarray(m0),
        None if m1 is None else jnp.asarray(m1), mutual=mutual)
    got, got_d = tmnn.mnn_ratio_match(
        torch.as_tensor(d0), torch.as_tensor(d1),
        None if m0 is None else torch.as_tensor(m0),
        None if m1 is None else torch.as_tensor(m1), mutual=mutual)
    want = np.asarray(want)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-5)
    # the inputs exercise what they are meant to: matches and rejections,
    # and with ties, rows whose best two distances are equal
    n = (want >= 0).sum()
    assert 20 <= n < len(d0), n
    if kind == "tied_sift":
        t0 = torch.as_tensor(d0)
        dist = torch.cdist(t0, torch.as_tensor(d1)).square()
        two = dist.topk(2, largest=False).values
        assert int((two[:, 0] == two[:, 1]).sum()) >= 10
