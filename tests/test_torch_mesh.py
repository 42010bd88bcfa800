"""The port's device mesh against the JAX package's ``parallel/mesh.py``.

``make_mesh`` shapes and errors as ``tests/test_train_parallel.py`` checks
them (over eight CPU devices, as the JAX tests run on eight virtual CPU
devices), ``shard_batch``'s placement, ``_tp_spec`` against the JAX one on
every leaf of the bundled ``learned_lg9`` tree, ``shard_params_tp``
replicating with a model axis of 1 and output-sharding above it (the
shards against JAX's: ``tests/test_torch_mesh_tp.py``).
"""
import jax
import numpy as np
import pytest
import torch

from gisnav_tpu.parallel import mesh as jmesh
from gisnav_tpu.pipeline.runners import load_bundled as j_load_bundled
from gisnav_tpu_torch.parallel import (
    make_mesh,
    shard_batch,
    shard_params_tp,
)
from gisnav_tpu_torch.parallel.mesh import _tp_spec
from gisnav_tpu_torch.parallel.tp import Sharded
from gisnav_tpu_torch.pipeline.multistream import shard_stream_batch

CPUS = [torch.device("cpu")] * 8


def _jax_cpus():
    """The eight virtual CPU devices the conftest gives JAX."""
    devs = jax.devices("cpu")
    assert len(devs) == 8
    return devs


@pytest.mark.parametrize("n,model,shape", [
    (8, 2, {"data": 4, "model": 2}), (8, 1, {"data": 8, "model": 1}),
    (None, 4, {"data": 2, "model": 4}), (6, 3, {"data": 2, "model": 3})])
def test_make_mesh_shapes(n, model, shape):
    mesh = make_mesh(n, model_parallel=model, devices=CPUS)
    assert mesh.shape == shape
    assert mesh.devices.shape == tuple(shape.values())
    jm = jmesh.make_mesh(n, model_parallel=model, devices=_jax_cpus())
    assert dict(jm.shape) == shape


@pytest.mark.parametrize("n,model,match", [
    (9, 1, "requested 9 devices, have 8"),
    (8, 3, "not divisible by model=3")])
def test_make_mesh_errors(n, model, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(n, model_parallel=model, devices=CPUS)
    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(n, model_parallel=model, devices=_jax_cpus())


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


@pytest.mark.parametrize("shard", [shard_batch, shard_stream_batch])
def test_shard_batch_places_blocks_on_data_slices(shard):
    mesh = make_mesh(8, model_parallel=2, devices=CPUS)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    feats = (torch.arange(8 * 2).reshape(8, 2), torch.ones(8, 5))
    blocks = shard(mesh, {"x": x, "feats": feats})
    assert len(blocks) == 4
    for i, blk in enumerate(blocks):
        assert blk["x"].device == mesh.devices[i, 0]
        np.testing.assert_array_equal(blk["x"].numpy(), x[2 * i:2 * i + 2])
        assert torch.equal(blk["feats"][0], feats[0][2 * i:2 * i + 2])
        assert isinstance(blk["feats"], tuple)
    with pytest.raises(ValueError, match="do not divide"):
        shard(mesh, {"x": x[:6]})
    with pytest.raises(ValueError, match="disagree"):
        shard(mesh, {"x": x, "y": x[:4]})


def test_tp_spec_equals_jax_on_bundled_tree():
    params, _ = j_load_bundled("learned_lg9")
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) > 100
    kinds = set()
    for path, value in leaves:
        path_str = "/".join(str(p) for p in path)
        ours = _tp_spec(path_str, value, "model")
        theirs = jmesh._tp_spec(path_str, value, "model")
        assert ours == tuple(theirs), path_str
        kinds.add(ours)
    assert kinds == {(None, "model"), ("model",), ()}


def test_shard_params_tp_replicates():
    params = {"lightglue": {"fc": {"kernel": np.ones((4, 6), np.float32),
                                   "bias": torch.zeros(6)}}}
    mesh = make_mesh(4, devices=CPUS)
    trees = shard_params_tp(mesh, params)
    assert len(trees) == 4
    for tree, dev in zip(trees, mesh.devices[:, 0]):
        assert tree["lightglue"]["fc"]["kernel"].device == dev
        assert torch.equal(tree["lightglue"]["fc"]["kernel"],
                           torch.ones(4, 6))
    # a model axis of 2 output-shards the JAX-layout kernel (in, out)
    trees = shard_params_tp(make_mesh(8, model_parallel=2, devices=CPUS),
                            params)
    assert len(trees) == 4
    kernel = trees[0]["lightglue"]["fc"]["kernel"]
    assert isinstance(kernel, Sharded) and kernel.axis == 1
    assert [tuple(s.shape) for s in kernel.shards] == [(4, 3), (4, 3)]
    assert torch.equal(kernel.gather(), torch.ones(4, 6))
