"""Host-side behaviour of the port's training against the JAX package's.

- ``init_pipeline_params``: the JAX init's keys and shapes, and each
  leaf's statistics: kernels a normal of std sqrt(1 / fan_in) truncated at
  2 std (the sample std within 10 % of JAX's where a leaf has 1,000 values
  or more; no value beyond the cut), biases zero, LayerNorm scales one.
- Checkpoints: a round trip is bit-equal, only the newest three steps are
  kept, ``load_params(like=...)`` restores devices and dtypes and raises on
  another structure.
- ``train()`` on the CPU with the host generator: the params move and the
  checkpoints are written; ``init_params`` of another architecture raises
  ``ValueError``; LoFTR with host data raises as the JAX loop does.
- ``python -m gisnav_tpu_torch train`` raises without CUDA unless
  ``--device cpu``; through the CLI on the CPU with ``--out``; and a bundle written by ``save_npz`` read back by the JAX
  package's ``load_npz`` bit for bit and served by ``run --weights``.
"""
import argparse
import os

import jax
import numpy as np
import pytest
import torch

from gisnav_tpu.pipeline.geopose import PipelineConfig as JPC
from gisnav_tpu.pipeline.geopose import init_pipeline_params as jinit
from gisnav_tpu.weights import load_npz as jax_load_npz
from gisnav_tpu_torch import weights
from gisnav_tpu_torch.cli import build_app
from gisnav_tpu_torch.cli import main as cli_main
from gisnav_tpu_torch.pipeline.geopose import PipelineConfig
from gisnav_tpu_torch.pipeline.geopose import init_pipeline_params
from gisnav_tpu_torch.train import checkpoint
from gisnav_tpu_torch.train.loftr_steps import LoFTRTrainConfig
from gisnav_tpu_torch.train.loop import train
from gisnav_tpu_torch.train.steps import TrainConfig, tree_leaves

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("mode", ["learned", "harris"])
def test_init_pipeline_params_statistics(mode):
    kw = dict(image_shape=(64, 80), max_keypoints=64, lightglue_depth=2,
              detector_mode=mode)
    got = _flat(init_pipeline_params(torch.Generator().manual_seed(0),
                                     PipelineConfig(**kw)))
    want = _flat(jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0),
                                                JPC(**kw))))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if key.endswith("kernel"):
            fan_in = int(np.prod(w.shape[:-1]))
            assert np.abs(g).max() <= 2 * (1.0 / fan_in) ** 0.5 / \
                0.87962566103423978 + 1e-7, key
            if w.size >= 1000:
                assert abs(g.std() / w.std() - 1.0) < 0.1, key
        elif key.endswith("scale"):
            np.testing.assert_array_equal(g, 1.0)
        else:
            np.testing.assert_array_equal(g, 0.0)


def test_checkpoint_round_trip_and_keep_three(tmp_path):
    tree = {"a": {"w": torch.randn(3, 4)},
            "b": torch.randn(5).to(torch.bfloat16)}
    for step in (10, 20, 30, 40):
        checkpoint.save_params(str(tmp_path), step, tree)
    assert sorted(os.listdir(tmp_path)) == ["20", "30", "40"]
    assert checkpoint.latest_step(str(tmp_path)) == 40
    back = checkpoint.load_params(str(tmp_path), like=tree)
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(tree_leaves(tree), tree_leaves(back)))
    with pytest.raises(ValueError):
        checkpoint.load_params(str(tmp_path), like={"a": tree["a"]})
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.load_params(str(tmp_path / "none"))


SMALL = TrainConfig(image_shape=(64, 80), max_keypoints=64,
                    lightglue_depth=1)


def test_train_on_cpu_with_host_data(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    params = train(steps=2, batch_size=2, config=SMALL, ckpt_dir=ckpt,
                   ckpt_every=1, device="cpu")
    assert checkpoint.latest_step(ckpt) == 2
    saved = checkpoint.load_params(ckpt, like=params)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(saved)))
    first = checkpoint.load_params(ckpt, step=1)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                     tree_leaves(saved)))


def test_train_init_params_structure_error():
    bundle = weights.load_bundled("harris_lg5")[0]  # LightGlue-5, harris
    with pytest.raises(ValueError, match="structure"):
        train(steps=1, batch_size=1, config=SMALL, init_params=bundle,
              device="cpu")
    with pytest.raises(NotImplementedError):
        train(steps=1, batch_size=1, config=LoFTRTrainConfig(),
              device="cpu")


def test_train_cli_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["train", "--steps", "1"])


def test_train_cli_on_cpu_and_bundle_round_trip(tmp_path):
    out = str(tmp_path / "trained.npz")
    assert cli_main(["train", "--device", "cpu", "--steps", "1", "--batch",
                     "1", "--image-shape", "64", "80", "--max-keypoints",
                     "64", "--depth", "1", "--out", out]) == 0
    tree = jax_load_npz(out)
    assert sorted(tree) == ["lightglue", "superpoint"]
    assert "convPa" in tree["superpoint"]["params"]

    # a bundle through the port's tree and save_npz: the JAX package reads
    # back the same f16 values, and `run --weights` serves it
    bundle = weights.load_bundled("harris_lg5")[0]
    path = str(tmp_path / "harris.npz")
    weights.save_npz(path, weights.params_to_jax(
        weights.params_from_jax(bundle, master=True)))
    got, want = _flat(jax_load_npz(path)), _flat(bundle)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    args = argparse.Namespace(protocol="uorb", params=None,
                              namespace="gisnav", gis_rate=1.0,
                              backend="deep", weights=path,
                              deep_mode="cached", device="cpu")
    assert build_app(args).pose._deep_runner is not None
