"""The port's weight loading against the JAX package's.

``gisnav_tpu_torch.weights`` restores the bundled npz without flax and turns
JAX-layout trees into the port's tensors; values must be identical.
"""
import numpy as np
import pytest
import torch

from gisnav_tpu import weights as jw
from gisnav_tpu.pipeline.runners import infer_config_from_params as j_infer
from gisnav_tpu_torch import weights as tw

torch.set_num_threads(2)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


@pytest.fixture(scope="module")
def trees():
    return tw.load_npz(tw.LEARNED_LG9_PATH), jw.load_npz(jw.LEARNED_LG9_PATH)


def test_load_npz_matches_jax_loader(trees):
    port, ref = _flatten(trees[0]), _flatten(trees[1])
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(port[key], np.asarray(ref[key]),
                                      err_msg=key)


@pytest.mark.parametrize("with_params_level", [True, False])
def test_params_from_jax_layouts(trees, with_params_level):
    tree = trees[0]
    if not with_params_level:
        tree = {k: v["params"] for k, v in tree.items()}
    port = tw.params_from_jax(tree)
    sp_ref = trees[0]["superpoint"]["params"]
    for name, leaf in sp_ref.items():
        k = leaf["kernel"]
        got = port["superpoint"][name]["weight"]
        assert got.dtype == torch.bfloat16
        if k.shape[:2] == (3, 3):
            assert tuple(got.shape) == (9, k.shape[2], k.shape[3])
            want = k.reshape(9, k.shape[2], k.shape[3])
        else:
            assert tuple(got.shape) == (k.shape[3], k.shape[2])
            want = k[0, 0].T
        np.testing.assert_array_equal(
            got.float().numpy(),
            torch.as_tensor(want).to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(port["superpoint"][name]["bias"].numpy(),
                                      leaf["bias"])
    lg_ref = trees[0]["lightglue"]["params"]
    wqkv = port["lightglue"]["self_0"]["Wqkv"]["weight"]
    assert tuple(wqkv.shape) == (768, 256)
    np.testing.assert_array_equal(wqkv.numpy(),
                                  lg_ref["self_0"]["Wqkv"]["kernel"].T)
    norm = port["lightglue"]["cross_3"]["ffn"]["norm"]
    np.testing.assert_array_equal(norm["weight"].numpy(),
                                  lg_ref["cross_3"]["ffn"]["norm"]["scale"])
    assert tuple(port["lightglue"]["posenc"]["Wr"]["weight"].shape) == (32, 2)


def test_infer_config_from_params(trees):
    cfg = tw.infer_config_from_params(trees[0])
    assert cfg.lightglue_depth == 9 and cfg.detector_mode == "learned"
    ref = j_infer(trees[1])
    assert (cfg.lightglue_depth, cfg.detector_mode) == (
        ref.lightglue_depth, ref.detector_mode)
    with pytest.raises(ValueError):
        tw.infer_config_from_params({"superpoint": {}})


def test_load_bundled():
    tree, cfg = tw.load_bundled("learned_lg9")
    assert "lightglue" in tree and cfg.lightglue_depth == 9
    with pytest.raises(ValueError):
        tw.load_bundled("harris_lg5")
