"""Fused LightGlue of the port against the JAX package.

- ``fused_block_plain`` (what a CPU tensor runs) against ``_block_reference``
  / ``_block_reference_dual`` and against the TPU kernel ``_block_pallas`` in
  Pallas interpret mode, self and cross: atol 2e-2 on the f32 outputs (both
  sides round at the same bf16 points; summing in another order can move a
  rounded value by one bf16 ulp).
- The port's fused forward with the bundled learned_lg9 weights against
  ``lightglue_fused_forward`` on the CPU at K = 512: ``matches0`` must agree
  on more than 98 % of the keypoints (the gate of the JAX package's own
  fused-vs-flax parity test). The weights are trained at depth 9; cut to
  depth 2 their match scores stay low, so those cases keep every mutual
  argmax (threshold 0).
- The CUDA attention launch's arithmetic written out in PyTorch (each set's
  key half, the keys split over a cluster with per-split statistics merged
  in split order, P rounded to bf16 with the merged statistics, partial P.V
  summed in split order and rounded once) against ``_block_plain``'s msg,
  and the key splits the wrapper chooses at the path shapes.
- ``fused_block_plain(sets=1)`` with unequal query and key counts against
  the older layout's TPU kernel ``_old_lgf._block_pallas`` in interpret mode
  (its body is the ``sets=1`` case of the current kernel's): atol 2e-2.
- The module route (``lightglue.LightGlue``) against the flax module
  ``LightGlue(...).apply`` on the same tree at K = 256 / 384, outside the
  fused predicate, where the attention runs the kernel's plain version:
  ``matches0`` agreement of at least 98 %, scores within 0.05.
- ``LightGlueMatcher`` picks the route ``apply_lightglue`` would pick on an
  accelerator: fused where ``fused_lightglue_supported`` holds, the module
  route elsewhere; the predicate equals the JAX one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gisnav_tpu.matching import _old_lgf as jold
from gisnav_tpu.matching import lightglue as jlg
from gisnav_tpu.matching import lightglue_fused as jlf
from gisnav_tpu.weights import LEARNED_LG9_PATH, load_npz
from gisnav_tpu_torch.matching import lightglue as tlg
from gisnav_tpu_torch.matching import lightglue_fused as tlf
from gisnav_tpu_torch.matching.attention import key_splits
from gisnav_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

DIM = 256


def _block_inputs(seed, n, kk, sets):
    """``n`` query rows and ``kk`` keys per set."""
    rng = np.random.default_rng(seed)

    def f(shape, scale=1.0):
        return (rng.normal(0, scale, shape)).astype(np.float32)

    def bf(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    x = f((sets * n, DIM))
    q = bf(f((sets * n, DIM)))
    k, v = bf(f((sets * kk, DIM))), bf(f((sets * kk, DIM)))
    bias = np.where(rng.random((sets, kk)) < 0.85, 0.0, -1e9).astype(
        np.float32)
    w = [bf(f((DIM, DIM), DIM ** -0.5)), f((1, DIM), 0.05),
         bf(f((DIM, 2 * DIM), (2 * DIM) ** -0.5)),
         bf(f((DIM, 2 * DIM), (2 * DIM) ** -0.5)), f((1, 2 * DIM), 0.05),
         1.0 + f((1, 2 * DIM), 0.1), f((1, 2 * DIM), 0.1),
         bf(f((2 * DIM, DIM), (2 * DIM) ** -0.5)), f((1, DIM), 0.05)]
    return x, q, k, v, bias, w


_BF = (1, 2, 3, 5, 7, 8, 12)  # bf16 positions in (x, q, k, v, bias, *w)


def _jax_args(args):
    x, q, k, v, bias, w = args
    flat = [x, q, k, v, bias, *w]
    return [jnp.asarray(a).astype(jnp.bfloat16) if i in _BF
            else jnp.asarray(a) for i, a in enumerate(flat)]


def _torch_args(args):
    x, q, k, v, bias, w = args
    flat = [x, q, k, v, bias, *w]
    out = []
    for i, a in enumerate(flat):
        t = torch.as_tensor(np.array(a))
        if i >= 5 and t.dim() == 2 and t.shape[0] == 1:
            t = t[0]
        out.append(t.to(torch.bfloat16) if i in _BF else t)
    return out


@pytest.mark.parametrize("sets,cross", [(1, False), (2, False), (2, True)])
def test_block_plain_vs_jax(sets, cross):
    n = 512
    args = _block_inputs(sets + 3 * cross, n, n, sets)
    got = tlf.fused_block(*_torch_args(args), heads=4, sets=sets,
                          cross=cross).numpy()
    ja = _jax_args(args)
    if sets == 1:
        ref = jlf._block_reference(*ja, heads=4)
    else:
        ref = jlf._block_reference_dual(*ja, heads=4, cross=cross)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-2, rtol=0)
    with pltpu.force_tpu_interpret_mode():
        ker = jlf._block_pallas(*ja, heads=4, sets=sets, cross=cross)
    np.testing.assert_allclose(got, np.asarray(ker), atol=2e-2, rtol=0)


def _split_attention(q, k, v, bias, heads, sets, cross, splits):
    """The fused block's attention launch in PyTorch, as the kernel computes
    it: query set s attends key half s ^ cross; the 64-key tiles are cut
    into ``splits`` ranges (tiles * p // splits ...), each range's row max
    and sum of exp are merged in split order (m = max, l = l e^(m - m') +
    l' e^(m' - m)), P = bf16(exp(logit - m) * (1 / l)), and the ranges'
    partial P.V are added in split order and rounded to bf16 once."""
    n, dim = q.shape
    kq, kk = n // sets, k.shape[0] // sets
    dh = dim // heads
    tiles = kk // 64
    edges = [64 * (tiles * p // splits) for p in range(splits + 1)]
    out = []
    for s in range(sets):
        ks = s ^ int(cross)
        qh, kh, vh = (t.float().reshape(-1, heads, dh).transpose(0, 1)
                      for t in (q[s * kq:(s + 1) * kq],
                                k[ks * kk:(ks + 1) * kk],
                                v[ks * kk:(ks + 1) * kk]))
        logits = (qh @ kh.transpose(1, 2)) * dh ** -0.5 + bias[ks]
        parts = [logits[..., a:b] for a, b in zip(edges, edges[1:])]
        m = l = None
        for part in parts:
            mp = part.amax(-1)
            lp = torch.exp(part - mp[..., None]).sum(-1)
            if m is None:
                m, l = mp, lp
            else:
                mn = torch.maximum(m, mp)
                l = l * torch.exp(m - mn) + lp * torch.exp(mp - mn)
                m = mn
        inv_l = 1.0 / l
        o = torch.zeros((heads, kq, dh))
        for (a, b), part in zip(zip(edges, edges[1:]), parts):
            p = tlf._r(torch.exp(part - m[..., None]) * inv_l[..., None])
            o = o + p @ vh[:, a:b]
        out.append(tlf._r(o.transpose(0, 1).reshape(kq, dim)))
    return torch.cat(out)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("sets,cross", [(1, False), (2, False), (2, True)])
def test_split_cluster_attention_is_the_plain_msg(monkeypatch, sets, cross,
                                                  splits):
    """The split arithmetic equals the msg that ``_block_plain`` rounds
    (caught at its second ``_r`` call a set) within one bf16 ulp of msg (the
    split sums add in another order than the plain matmul, which can round
    msg to the neighbouring bf16) plus 2e-4: an f32 ulp in the merged sum
    can move a probability of ~1e-2 across a bf16 rounding point, one bf16
    ulp (4e-5) times |v| up to ~4."""
    n = 512
    x, q, k, v, bias, *w = _torch_args(_block_inputs(7 * sets + cross, n,
                                                     n, sets))
    seen = []
    r = tlf._r
    monkeypatch.setattr(tlf, "_r", lambda t: (seen.append(t), r(t))[1])
    tlf.fused_block_plain(x, q, k, v, bias, *w, heads=4, sets=sets,
                          cross=cross)
    monkeypatch.setattr(tlf, "_r", r)
    assert len(seen) == 7 * sets  # p, msg, m2, x, y, gelu, fc2 a set
    want = r(torch.cat([seen[7 * s + 1] for s in range(sets)]))
    got = _split_attention(q, k, v, bias, 4, sets, cross, splits)
    assert got.shape == want.shape == (sets * n, DIM)
    err = (got - want).abs()
    tol = 2.0 ** -7 * want.abs() + 2e-4
    assert not (err > tol).any(), float(err.max())


@pytest.mark.parametrize("n,kk,want", [
    (4096, 2048, 2),   # dual stage, 2 x 2048 keypoints
    (2048, 2048, 4),   # cached path, 2048 query / 2048 keys
    (2048, 4096, 4),   # 2048 query x 4096 reference keypoints
    (4096, 2048, 2),   # 4096 x 2048
    (4096, 4096, 2),   # 4096 x 4096
    (1024, 512, 8),    # the CPU tests' dual shape, 2 x 512
])
def test_block_key_splits_at_path_shapes(n, kk, want):
    """The fused block's attention launch splits the keys of a set as
    ``key_splits(n, kk, heads, sms)`` with ``n`` the query rows of all sets:
    on a 132-SM card at least three 4-warp blocks an SM where the keys
    allow, a power of two up to 8 (one thread-block cluster holds the splits
    of a row block), never more splits than 64-key tiles."""
    splits = key_splits(n, kk, 4, 132)
    assert splits == want
    assert splits in (1, 2, 4, 8) and splits <= kk // 64
    blocks = (n // 64) * 4 * splits
    assert blocks >= 3 * 132 or splits in (8, kk // 64)


@pytest.fixture(scope="module")
def lg_params():
    tree = load_npz(LEARNED_LG9_PATH)
    return tree["lightglue"], params_from_jax(tree)["lightglue"]


def _match_inputs(seed, k0, k1):
    """Set 1 is a rotated, shifted, noisy and shuffled copy of set 0 plus
    distractors, so the assignment has real matches to find."""
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform(0, (640, 480), (k0, 2)).astype(np.float32)
    d0 = rng.normal(0, 1, (k0, DIM)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    a = np.radians(7.0)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    n_common = min(k0, k1) * 3 // 4
    perm = rng.permutation(k0)[:n_common]
    kp1 = rng.uniform(0, (640, 480), (k1, 2)).astype(np.float32)
    d1 = rng.normal(0, 1, (k1, DIM)).astype(np.float32)
    kp1[:n_common] = (kp0[perm] - 320) @ rot.T + 320 + 5.0
    d1[:n_common] = d0[perm] + rng.normal(0, 0.3, (n_common, DIM))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    m0 = rng.random(k0) > 0.05
    m1 = rng.random(k1) > 0.05
    return kp0, d0, m0, kp1, d1.astype(np.float32), m1


@pytest.mark.parametrize("depth,k0,k1", [(2, 512, 512), (9, 512, 512),
                                         (2, 512, 1024)])
def test_fused_forward_vs_jax(lg_params, depth, k0, k1):
    jparams, tparams = lg_params
    kp0, d0, m0, kp1, d1, m1 = _match_inputs(depth, k0, k1)
    size = (480, 640)
    thr = 0.1 if depth == 9 else 0.0
    ref = jlf.lightglue_fused_forward(
        jparams, jnp.asarray(kp0), jnp.asarray(d0), jnp.asarray(m0), size,
        jnp.asarray(kp1), jnp.asarray(d1), jnp.asarray(m1), size,
        depth=depth, filter_threshold=thr)
    model = tlf.LightGlue(tparams, depth=depth, filter_threshold=thr)
    got = model(*(torch.as_tensor(a) for a in (kp0, d0, m0)), size,
                *(torch.as_tensor(a) for a in (kp1, d1, m1)), size)
    ref_m0 = np.asarray(ref.matches0)
    assert (ref_m0 >= 0).sum() > k0 // 8  # real matches exist
    agree = (got.matches0.numpy() == ref_m0).mean()
    assert agree > 0.98, agree
    assert np.abs(got.scores.numpy() - np.asarray(ref.scores)).max() < 0.05


@pytest.mark.parametrize("n,kk", [(512, 1024), (1024, 512)])
def test_block_plain_sets1_vs_old_layout_kernel(n, kk):
    args = _block_inputs(n, n, kk, 1)
    got = tlf.fused_block(*_torch_args(args), heads=4, sets=1).numpy()
    with pltpu.force_tpu_interpret_mode():
        ker = jold._block_pallas(*_jax_args(args), heads=4)
    np.testing.assert_allclose(got, np.asarray(ker), atol=2e-2, rtol=0)


@pytest.mark.parametrize("depth,k0,k1", [(2, 256, 256), (9, 256, 256),
                                         (2, 256, 384), (9, 256, 384)])
def test_module_route_vs_flax_module(lg_params, depth, k0, k1):
    jparams, tparams = lg_params
    kp0, d0, m0, kp1, d1, m1 = _match_inputs(depth + k1, k0, k1)
    size = (480, 640)
    thr = 0.1 if depth == 9 else 0.0
    assert not jlf.fused_lightglue_supported(k0, k1, 256, 4)
    ref = jlg.LightGlue(depth=depth, filter_threshold=thr).apply(
        jparams, jnp.asarray(kp0), jnp.asarray(d0), jnp.asarray(m0), size,
        jnp.asarray(kp1), jnp.asarray(d1), jnp.asarray(m1), size)
    model = tlg.LightGlue(tparams, depth=depth, filter_threshold=thr)
    got = model(*(torch.as_tensor(a) for a in (kp0, d0, m0)), size,
                *(torch.as_tensor(a) for a in (kp1, d1, m1)), size)
    ref_m0 = np.asarray(ref.matches0)
    assert (ref_m0 >= 0).sum() > k0 // 8  # real matches exist
    agree = (got.matches0.numpy() == ref_m0).mean()
    assert agree >= 0.98, agree
    assert np.abs(got.scores.numpy() - np.asarray(ref.scores)).max() < 0.05


def test_matcher_dispatch_as_apply_lightglue(lg_params, monkeypatch):
    _, tparams = lg_params
    matcher = tlg.LightGlueMatcher(tparams, depth=1)
    for k0 in (256, 512, 768, 1024, 1792, 2048):
        for k1 in (512, 1536, 3584, 4096):
            fused = jlf.fused_lightglue_supported(k0, k1, 256, 4)
            assert tlf.fused_lightglue_supported(k0, k1, 256, 4) == fused
            assert matcher.route(k0, k1) == ("fused" if fused else "module")
    # the forward goes where route() says
    calls = []
    monkeypatch.setattr(tlf, "fused_block", lambda x, *a, **kw: (
        calls.append("fused"), x)[1])
    monkeypatch.setattr(tlg, "_attention", lambda q, k, v, m: (
        calls.append("module"), torch.zeros_like(q.float()))[1])
    for k0, k1 in ((512, 512), (256, 384)):
        kp0, d0, m0, kp1, d1, m1 = _match_inputs(1, k0, k1)
        calls.clear()
        matcher(*(torch.as_tensor(a) for a in (kp0, d0, m0)), (480, 640),
                *(torch.as_tensor(a) for a in (kp1, d1, m1)), (480, 640))
        assert set(calls) == {matcher.route(k0, k1)}
