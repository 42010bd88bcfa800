"""The port's tensor-parallel mesh against the JAX package's, on the CPU.

The port's mesh is laid over ``[cpu] * 8`` and the JAX one over the eight
virtual CPU devices of the conftest.

- ``shard_params_tp`` of the bundled ``learned_lg9`` and ``loftr`` trees
  (Dense, LayerNorm, SuperPoint's folded convs, LoFTR's OIHW convs): every
  leaf JAX shards is a ``Sharded`` whose shard j of row i equals JAX's
  ``addressable_shards`` entry of ``devices[i, j]`` exactly (a Dense
  weight's shard transposed to JAX's (in, out) layout), and every leaf JAX
  replicates is a plain tensor on the row's first device.
- ``parallel.tp.product`` with every Dense body of the port (bf16, f32,
  (in, out) affine), with a sharded, plain or no bias, against the
  unsharded product (to the rounding of a narrower product), and its
  gradient reaching each shard (to the order of a sum's terms; the input's
  gradient, a sum over the slices, to its rounding).
- LightGlue, fused and module route, at depth 2: TP2 equal to TP1 (the CPU
  forms each output column's sum in the same order) and against JAX's
  forward on a (4 x 2) mesh with the gate of ``tests/test_torch_lightglue.py``
  (``matches0`` agreement above 98 %, scores within 0.05).
- The multistream tick over the port's (4 x 2) mesh: 8 streams of
  ``harris_lg5`` at 480x640 (512 keypoints, pooled by 2) over path 4's
  800 px map, each from its own point 22.2 m off the map's centre,
  against JAX's jitted ``build_multistream_pipeline`` on its (4 x 2) mesh
  with the same RANSAC draws (JAX's samples for each stream's key on the
  port's match mask): each stream valid where JAX's is, match counts within
  10 % + 1, its fix within 10 m of its own truth and within 2.5 m of JAX's
  fix horizontally and in altitude (measured 0.000-1.922 m and
  0.000-1.524 m: stream 1 keeps 50 matches to JAX's 48), and more than
  10 m from the next stream's truth, so the order is kept; the mesh with a
  model axis of 1 equal to the single-device tick bit for bit; TP2 within
  JAX's own bound of TP1 (``atol=2e-5`` on lon/lat, ``valid`` equal).
- The train step over the (4 x 2) mesh against JAX's step on its mesh
  with the tolerances of ``tests/test_train_parallel.py``: loss within
  ``rtol=1e-2``, every parameter within 5 lr; the replicas equal after the
  update and the sharded leaves still sharded. As Adam's first step moves
  every parameter by about lr whatever its gradient, the gradient the
  update read is held too, leaf by leaf: against the replicated step's and
  JAX's ``jax.grad`` over the whole batch on its mesh, with gates that the
  gradient of one row's block alone fails.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.parallel import mesh as jmesh
from gisnav_tpu.pipeline.runners import load_bundled as j_load_bundled
from gisnav_tpu_torch.parallel import make_mesh, shard_params_tp
from gisnav_tpu_torch.parallel.tp import Sharded, gather_tree, product
from gisnav_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

CPUS = [torch.device("cpu")] * 8


def _jax_mesh(model):
    return jmesh.make_mesh(8, model_parallel=model,
                           devices=jax.devices("cpu"))


def _port_leaf(tree, keys):
    """The port's leaf at a JAX path: no ``params`` level, ``kernel`` and
    ``scale`` named ``weight``."""
    keys = [k for k in keys if k != "params"]
    node = tree
    for k in keys[:-1]:
        node = node[k]
    return node["weight" if keys[-1] in ("kernel", "scale") else keys[-1]]


@pytest.mark.parametrize("bundle", ["learned_lg9", "loftr"])
@pytest.mark.parametrize("model", [2, 4])
def test_shard_params_tp_equals_jax_addressable_shards(model, bundle):
    jtree, _ = j_load_bundled(bundle)
    jm = _jax_mesh(model)
    jsharded = jmesh.shard_params_tp(jm, jtree)
    rows = shard_params_tp(make_mesh(8, model_parallel=model, devices=CPUS),
                           params_from_jax(jtree))
    assert len(rows) == 8 // model
    n_sharded = 0
    for path, arr in jax.tree_util.tree_flatten_with_path(jsharded)[0]:
        keys = [p.key for p in path]
        for i, row in enumerate(rows):
            leaf = _port_leaf(row, keys)
            if arr.sharding.is_fully_replicated:
                assert isinstance(leaf, torch.Tensor), keys
                continue
            assert isinstance(leaf, Sharded) and len(leaf.shards) == model
            shards = {s.device: np.asarray(s.data)
                      for s in arr.addressable_shards}
            for j, got in enumerate(leaf.shards):
                got = got.numpy()
                if keys[-1] == "kernel" and got.ndim == 2:
                    got = got.T  # Linear (out, in) -> Dense (in, out)
                np.testing.assert_array_equal(
                    got, shards[jm.devices[i, j]], err_msg=str(keys))
            n_sharded += i == 0
    # every Dense kernel but a head of one output (learned_lg9's
    # matchability), the even biases, LayerNorm and conv biases: 196 and 119
    assert n_sharded > {"learned_lg9": 150, "loftr": 100}[bundle]


def test_shard_params_tp_replicates_and_keeps_dtype():
    params = {"lightglue": {"fc": {"weight": torch.ones(6, 4),
                                   "bias": torch.zeros(6)}}}
    mesh = make_mesh(8, model_parallel=2, devices=CPUS)
    (row, *_) = shard_params_tp(mesh, params)
    fc = row["lightglue"]["fc"]
    assert isinstance(fc["weight"], Sharded) and fc["weight"].axis == 0
    assert fc["weight"].shape == (6, 4) and fc["weight"].sizes == [3, 3]
    assert torch.equal(fc["weight"].gather(), torch.ones(6, 4))
    assert torch.equal(gather_tree(row)["lightglue"]["fc"]["bias"],
                       torch.zeros(6))
    # 6 output features do not divide over 4 slots: JAX's fallback
    (row4, *_) = shard_params_tp(make_mesh(8, model_parallel=4,
                                           devices=CPUS), params)
    assert isinstance(row4["lightglue"]["fc"]["weight"], torch.Tensor)


def _bf16(x, w, b):
    return (x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T
            ).to(torch.bfloat16) + b.to(torch.bfloat16)


def _f32(x, w, b):
    return x @ w.T + b


def _in_out(x, w, b):
    return x @ w + b


@pytest.mark.parametrize("body,layout", [(_bf16, "out_in"),
                                         (_f32, "out_in"),
                                         (_in_out, "in_out")])
@pytest.mark.parametrize("bias", ["sharded", "plain"])
@pytest.mark.parametrize("model", [2, 4])
def test_tp_product_and_gradient(body, layout, bias, model):
    gen = torch.Generator().manual_seed(model)
    x = torch.randn(3, 5, 16, generator=gen, requires_grad=True)
    w = torch.randn(8, 16, generator=gen) * 0.25
    b = torch.randn(8, generator=gen)
    if layout == "in_out":
        w = w.T.contiguous()
    axis = 1 if layout == "in_out" else 0
    ws = Sharded.split(w, CPUS[:model], axis)
    ws = ws.map(lambda t: t.detach().requires_grad_())
    bs = Sharded.split(b, CPUS[:model], 0).map(
        lambda t: t.detach().requires_grad_()) if bias == "sharded" \
        else b.clone().requires_grad_()
    got = product(x, ws, bs, body)
    wf, bf = w.clone().requires_grad_(), b.clone().requires_grad_()
    xf = x.detach().clone().requires_grad_()
    want = body(xf, wf, bf)
    # a narrower product may take another BLAS route (two columns a shard
    # at 4 slots): its f32 sums to their rounding, bf16 to one ulp
    tol = 8e-3 if body is _bf16 else 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    g = torch.randn(got.shape, generator=gen).to(got.dtype)
    got.backward(g)
    want.backward(g)
    # the input's gradient sums over the output slices: in bf16 each
    # slice's part is rounded before the sum (as a sharded contraction's
    # partial sums are), in f32 the order alone moves it
    err = float((x.grad - xf.grad).norm() / xf.grad.norm())
    assert err < (1e-2 if body is _bf16 else 1e-6), err
    # a weight's and a bias's gradient sum over the 15 rows, which a
    # narrower slice may add in another order
    for j, s in enumerate(ws.shards):
        torch.testing.assert_close(s.grad, wf.grad.chunk(model, axis)[j],
                                   rtol=1e-5, atol=1e-6)
    bgrad = torch.cat([s.grad for s in bs.shards]) if bias == "sharded" \
        else bs.grad
    torch.testing.assert_close(bgrad, bf.grad, rtol=1e-5, atol=1e-6)


def test_tp_product_without_bias_and_unsharded_weight():
    x = torch.randn(4, 6)
    w = torch.randn(6, 10)
    ws = Sharded.split(w, CPUS[:2], 1)
    assert torch.equal(product(x, ws, None, lambda x, w, _: x @ w), x @ w)
    # a plain weight with a sharded bias: one product, the bias gathered
    b = Sharded.split(torch.arange(10.0), CPUS[:2], 0)
    assert torch.equal(product(x, w, b, _in_out), x @ w + torch.arange(10.0))


@pytest.fixture(scope="module")
def lg_tree():
    from gisnav_tpu.weights import LEARNED_LG9_PATH, load_npz

    return {"lightglue": load_npz(LEARNED_LG9_PATH)["lightglue"]}


@pytest.mark.parametrize("route,k0,k1", [("fused", 512, 512),
                                         ("module", 256, 384)])
def test_lightglue_tp2_vs_tp1_and_jax_tp2(lg_tree, route, k0, k1):
    from gisnav_tpu.matching import lightglue as jlg
    from gisnav_tpu.matching import lightglue_fused as jlf
    from gisnav_tpu_torch.matching import lightglue as tlg
    from gisnav_tpu_torch.matching import lightglue_fused as tlf

    from tests.test_torch_lightglue import _match_inputs

    depth, size = 2, (480, 640)
    kp0, d0, m0, kp1, d1, m1 = _match_inputs(depth + k1, k0, k1)
    tree = params_from_jax(lg_tree)
    cls = tlf.LightGlue if route == "fused" else tlg.LightGlue
    assert (route == "fused") == tlf.fused_lightglue_supported(k0, k1, 256, 4)
    outs = {}
    for model in (1, 2):
        (row, *_) = shard_params_tp(make_mesh(8, model_parallel=model,
                                              devices=CPUS), tree)
        assert isinstance(row["lightglue"]["self_0"]["Wqkv"]["weight"],
                          Sharded) == (model == 2)
        outs[model] = cls(row["lightglue"], depth=depth,
                          filter_threshold=0.0)(
            *(torch.as_tensor(a) for a in (kp0, d0, m0)), size,
            *(torch.as_tensor(a) for a in (kp1, d1, m1)), size)
    assert torch.equal(outs[2].matches0, outs[1].matches0)
    torch.testing.assert_close(outs[2].scores, outs[1].scores, rtol=0,
                               atol=1e-6)

    jparams = jmesh.shard_params_tp(_jax_mesh(2), lg_tree)["lightglue"]
    args = [jnp.asarray(a) for a in (kp0, d0, m0, kp1, d1, m1)]
    if route == "fused":
        ref = jax.jit(lambda p, a0, b0, c0, a1, b1, c1:
                      jlf.lightglue_fused_forward(
                          p, a0, b0, c0, size, a1, b1, c1, size,
                          depth=depth, filter_threshold=0.0))(jparams, *args)
    else:
        module = jlg.LightGlue(depth=depth, filter_threshold=0.0)
        ref = jax.jit(lambda p, a0, b0, c0, a1, b1, c1: module.apply(
            p, a0, b0, c0, size, a1, b1, c1, size))(jparams, *args)
    ref_m0 = np.asarray(ref.matches0)
    assert (ref_m0 >= 0).sum() > k0 // 8  # real matches exist
    agree = (outs[2].matches0.numpy() == ref_m0).mean()
    assert agree > 0.98, agree
    assert np.abs(outs[2].scores.numpy() - np.asarray(ref.scores)).max() \
        < 0.05


STREAM_YAWS = [i * 45.0 for i in range(8)]


@pytest.fixture(scope="module")
def streams():
    """8 streams of ``harris_lg5`` in cached mode at 480x640 over path 4's
    800 px map, camera i 22.2 m from the map's centre along yaw i (17 m
    and more apart); the batch in stream order."""
    from gisnav_tpu_torch.pipeline import geopose as tgp
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled

    s = render_scene(seed=6, h=480, w=640, yaws=STREAM_YAWS, map_side=800,
                     coverage=3.0, offset_m=22.2)
    params, cfg = load_bundled("harris_lg5")
    cfg = dataclasses.replace(cfg, ortho_shape=s.ortho.shape,
                              detector_downsample=2)
    tree = params_from_jax(params)
    ref = tgp.build_reference_extractor(cfg)(
        tgp.build_models(tree, cfg),
        torch.as_tensor(s.ortho.astype(np.float32)) / 255.0)
    n = len(STREAM_YAWS)
    k32, aff32 = (np.asarray(a, np.float32) for a in (s.k, s.crs_affine))
    batch = (
        torch.as_tensor(np.stack(s.frames).astype(np.float32)) / 255.0,
        type(ref)(*(torch.stack([f] * n) for f in ref)),
        torch.stack([torch.as_tensor(s.dem)] * n),
        torch.stack([torch.as_tensor(k32)] * n),
        torch.stack([torch.as_tensor(aff32)] * n))
    return s, cfg, tree, batch


def _mesh_tick(cfg, tree, batch, model, draws):
    from gisnav_tpu_torch.pipeline.geopose import build_models
    from gisnav_tpu_torch.pipeline.multistream import (
        build_mesh_multistream_pipeline,
        shard_stream_batch,
    )

    mesh = make_mesh(8, model_parallel=model, devices=CPUS)
    rows = [build_models(t, cfg) for t in shard_params_tp(mesh, tree)]
    fn = build_mesh_multistream_pipeline(cfg)
    out = fn(mesh, rows, shard_stream_batch(mesh, batch), draws)
    assert fn.modes == {i: "cpu" for i in range(8 // model)}
    return out


def _gens():
    return [torch.Generator().manual_seed(i + 1) for i in range(8)]


def _fixes(s, out, to_wgs84):
    return [to_wgs84(jax.tree.map(lambda a: a[i], out), s.crs_affine)
            for i in range(8)]


def test_multistream_mesh_tp1_tp2_vs_single_device_and_jax(streams):
    from gisnav_tpu.pipeline import geopose as jgp
    from gisnav_tpu.pipeline import multistream as jms
    from gisnav_tpu.pipeline import runners as jruns
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline import geopose as tgp
    from gisnav_tpu_torch.pipeline.multistream import (
        build_multistream_pipeline,
    )

    from tests.test_torch_geometry import jax_ransac_sample

    s, cfg, tree, batch = streams
    single = build_multistream_pipeline(cfg)(tgp.build_models(tree, cfg),
                                             *batch, _gens())
    tp1 = _mesh_tick(cfg, tree, batch, 1, _gens())
    for name, a, b in zip(single._fields, tp1, single):
        assert torch.equal(a, b), name  # each stream its single-device self

    j_params, j_cfg = jruns.load_bundled("harris_lg5")
    j_cfg = dataclasses.replace(j_cfg, ortho_shape=s.ortho.shape,
                                detector_downsample=2)
    jm = _jax_mesh(2)
    j_sharded = jmesh.shard_params_tp(jm, j_params)
    j_ref = jax.jit(jgp.build_reference_extractor(j_cfg))(
        j_params, jnp.asarray(s.ortho, jnp.float32) / 255.0)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    j_batch = jms.shard_stream_batch(jm, (
        jnp.asarray(batch[0].numpy()),
        jax.tree.map(lambda a: jnp.broadcast_to(a, (8,) + a.shape), j_ref),
        *(jnp.asarray(t.numpy()) for t in batch[2:]), keys))
    j_out = jax.jit(jms.build_multistream_pipeline(j_cfg))(j_sharded,
                                                           *j_batch)
    draws = [lambda mask, _, key=key: jax_ransac_sample(key, mask.numpy())
             for key in keys]
    tp2 = _mesh_tick(cfg, tree, batch, 2, draws)
    tp1 = _mesh_tick(cfg, tree, batch, 1, draws)
    # JAX's own TP2-vs-TP1 bound (tests/test_multistream.py)
    np.testing.assert_allclose(tp2.lon_lat_alt[:, :2].numpy(),
                               tp1.lon_lat_alt[:, :2].numpy(), atol=2e-5)
    assert torch.equal(tp2.valid, tp1.valid)
    fixes = _fixes(s, tp2, tgp.geopose_to_wgs84_f64)
    j_fixes = _fixes(s, jax.tree.map(np.asarray, j_out),
                     jgp.geopose_to_wgs84_f64)
    for i, (lon, lat) in enumerate(s.truth_lonlat):
        p, r = type(tp2)(*(f[i] for f in tp2)), jax.tree.map(
            lambda a: np.asarray(a)[i], j_out)
        pf, rf = fixes[i], j_fixes[i]
        assert bool(p.valid) == bool(r.valid) is True, i
        n = int(r.num_matches)
        assert abs(int(p.num_matches) - n) <= 0.1 * n + 1, i
        for fix in (pf, rf):
            assert haversine_m(lat, lon, fix["lat"], fix["lon"]) < 10.0, i
        print(f"stream {i}: port-vs-JAX "
              f"{haversine_m(pf['lat'], pf['lon'], rf['lat'], rf['lon']):.3f}"
              f" m, {abs(pf['alt_ellipsoid'] - rf['alt_ellipsoid']):.3f} m "
              f"alt; matches {int(p.num_matches)}/{n}")
        assert haversine_m(pf["lat"], pf["lon"], rf["lat"], rf["lon"]) < 2.5
        assert abs(pf["alt_ellipsoid"] - rf["alt_ellipsoid"]) < 2.5
        # read through the next stream's truth, the fix is off the gate:
        # the order of the streams is kept
        nlon, nlat = s.truth_lonlat[(i + 1) % 8]
        assert haversine_m(nlat, nlon, pf["lat"], pf["lon"]) > 10.0


def _grads(params):
    """The gradient of a port tree (a mesh row's gathered whole) in the JAX
    layout, flat."""
    from gisnav_tpu_torch.train.steps import tree_grads
    from gisnav_tpu_torch.weights import params_to_jax

    from tests.test_torch_train_steps import _flat

    return _flat(params_to_jax(gather_tree(tree_grads(params))))


def _worst_rel(got, want):
    """The worst leaf's ``|got - want| / |want|`` (Frobenius norms)."""
    assert set(got) == set(want)
    return max(float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
               for k, w in want.items())


def test_train_step_on_mesh_vs_jax_and_replicated():
    """``tests/test_train_parallel.py``'s TP2 step (64x80 pairs, 64
    keypoints, LightGlue-1, lr 3e-4, batch 8) on a (4 x 2) mesh: the port's
    mesh step against JAX's jitted step on its mesh and against the port's
    replicated (single-device) step on the whole batch; its averaged
    gradient, read after the step, against JAX's ``jax.grad`` over the
    whole batch on its mesh and against the replicated step's."""
    from gisnav_tpu.train import steps as JS
    from gisnav_tpu.train.data import make_homography_batch
    from gisnav_tpu_torch.parallel.mesh import shard_batch
    from gisnav_tpu_torch.train import steps as TS
    from gisnav_tpu_torch.weights import params_to_jax

    from tests.test_torch_train_steps import _flat, _loss_fn

    cfg = dict(image_shape=(64, 80), max_keypoints=64, lightglue_depth=1,
               learning_rate=3e-4)
    lr = cfg["learning_rate"]
    jcfg, tcfg = JS.TrainConfig(**cfg), TS.TrainConfig(**cfg)
    jstate, jtx = JS.init_train_state(jax.random.PRNGKey(0), jcfg)
    batch = make_homography_batch(np.random.default_rng(42), 8,
                                  cfg["image_shape"])
    jm = _jax_mesh(2)
    js = jstate._replace(params=jmesh.shard_params_tp(jm, jstate.params))
    jbatch = jmesh.shard_batch(jm, tuple(jnp.asarray(a) for a in batch))
    jstep = JS.make_train_step(jcfg, jtx)
    jnew, jm_metrics = jax.jit(jstep)(js, *jbatch)
    want = jax.tree.map(np.asarray, jnew.params)
    _, jgrads = jax.jit(jax.value_and_grad(_loss_fn(jstep), has_aux=True))(
        js.params, *jbatch)
    jgrads = _flat(jax.tree.map(np.asarray, jgrads))

    def fresh():
        params = TS.master_params(jax.tree.map(np.asarray, jstate.params),
                                  "cpu")
        tx = TS.AdamW(tcfg.learning_rate, tcfg.weight_decay)
        return TS.TrainState(params, tx.init(params),
                             torch.zeros((), dtype=torch.int64)), tx

    args = tuple(torch.tensor(np.asarray(a)) for a in batch)
    state, tx = fresh()
    state, m = TS.make_train_step(tcfg, tx)(state, *args)
    mesh = make_mesh(8, model_parallel=2, devices=CPUS)
    mstate = TS.shard_train_state(mesh, fresh()[0], tx)
    blocks = shard_batch(mesh, args)
    mstate, mm = TS.make_mesh_train_step(tcfg, tx)(mstate, blocks)

    loss = float(mm["loss"])
    np.testing.assert_allclose(loss, float(jm_metrics["loss"]), rtol=1e-2)
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-2)
    # the gradient the update read, the same on every row, against the
    # replicated step's (worst of 55 leaves measured 0.0027, SuperPoint's
    # conv2b) and JAX's global mean (0.0751, final_proj's bias, where the
    # replicated step itself reads 0.0751); the gradient of row 0's block
    # alone, a mean that missed three rows, reads 0.70 and 0.71
    grads = [_grads(r.params) for r in mstate.rows]
    assert all(g.keys() == grads[0].keys() and all(
        np.array_equal(g[k], grads[0][k]) for k in g) for g in grads)
    replicated_grads = _grads(state.params)
    to_replicated = _worst_rel(grads[0], replicated_grads)
    to_jax = _worst_rel(grads[0], jgrads)
    row0_state, _ = fresh()
    TS.make_train_step(tcfg, tx)(row0_state, *blocks[0])
    row0 = [_worst_rel(_grads(row0_state.params), ref)
            for ref in (replicated_grads, jgrads)]
    print(f"worst leaf: {to_replicated:.3g} to the replicated step, "
          f"{to_jax:.3g} to JAX; row 0's block alone {row0}")
    assert to_replicated < 0.01 and to_jax < 0.1
    assert row0[0] > 0.01 and row0[1] > 0.1  # a fault the gates see
    rows = [gather_tree(r.params) for r in mstate.rows]
    got = params_to_jax(rows[0])
    replicated = params_to_jax(state.params)
    for ref in (want, replicated):
        worst = max(float(np.max(np.abs(a - b))) for a, b in zip(
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)))
        assert worst < 5 * lr, worst
    # the replicas stay equal, keep their sharding and count one step
    for row, tree in zip(mstate.rows, rows):
        assert int(row.step) == 1
        for a, b in zip(TS.tree_leaves(tree), TS.tree_leaves(rows[0])):
            assert torch.equal(a, b)
        fp = row.params["lightglue"]["final_proj"]["weight"]
        assert isinstance(fp, Sharded) and len(fp.shards) == 2
        assert all(isinstance(s, torch.nn.Parameter) for s in fp.shards)
