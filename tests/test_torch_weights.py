"""The port's weight loading against the JAX package's.

``gisnav_tpu_torch.weights`` restores the bundled npz without flax and turns
JAX-layout trees into the port's tensors; values must be identical. All
three bundles load with the JAX package's configs, field by field, and the
bundles move with ``GISNAV_TPU_WEIGHTS_DIR`` as the JAX package's do.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gisnav_tpu import weights as jw
from gisnav_tpu.pipeline import runners as jruns
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
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_infer(trees[1]))
    harris = tw.load_npz(tw.PRETRAINED_PATH)
    assert dataclasses.asdict(tw.infer_config_from_params(harris)) == \
        dataclasses.asdict(j_infer(jw.load_npz(jw.PRETRAINED_PATH)))
    with pytest.raises(ValueError):
        tw.infer_config_from_params({"superpoint": {}})


def test_load_bundled():
    tree, cfg = tw.load_bundled("learned_lg9")
    assert "lightglue" in tree and cfg.lightglue_depth == 9
    tree, cfg = tw.load_bundled("harris_lg5")
    assert "convPa" not in tree["superpoint"]["params"]
    assert (cfg.lightglue_depth, cfg.detector_mode) == (5, "harris")
    with pytest.raises(ValueError):
        tw.load_bundled("sift")


@pytest.mark.parametrize("name", ["harris_lg5", "learned_lg9", "loftr"])
def test_load_bundled_vs_jax(name):
    tree, cfg = tw.load_bundled(name)
    j_tree, j_cfg = jruns.load_bundled(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    port, ref = _flatten(tree), _flatten(j_tree)
    assert sorted(port) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(port[key], np.asarray(ref[key]),
                                      err_msg=key)
    # the default bundle is the JAX package's
    if name == "harris_lg5":
        default = tw.load_bundled()
        assert dataclasses.asdict(default[1]) == dataclasses.asdict(j_cfg)


def test_weights_dir_from_environment(tmp_path):
    """``GISNAV_TPU_WEIGHTS_DIR``, read at import as in the JAX package,
    moves the three paths; a bundle missing there raises
    FileNotFoundError."""
    script = (
        "import json\n"
        "from gisnav_tpu_torch import weights as w\n"
        "try:\n"
        "    w.load_bundled('harris_lg5')\n"
        "    missing = False\n"
        "except FileNotFoundError:\n"
        "    missing = True\n"
        "print(json.dumps([w.WEIGHTS_DIR, w.PRETRAINED_PATH,\n"
        "                  w.LEARNED_LG9_PATH, w.LOFTR_PATH, missing]))\n")
    env = dict(os.environ, GISNAV_TPU_WEIGHTS_DIR=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    wdir, *paths, missing = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert wdir == str(tmp_path) and missing
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in (jw.PRETRAINED_PATH,
                                      jw.LEARNED_LG9_PATH, jw.LOFTR_PATH)]
    assert all(os.path.dirname(p) == str(tmp_path) for p in paths)
    # without the variable the paths are the repo's bundles
    assert os.path.exists(tw.PRETRAINED_PATH) and os.path.exists(
        tw.LOFTR_PATH)
