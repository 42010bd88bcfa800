"""The port's checkpoint converters against the JAX package's.

- On the synthetic torch-layout state dicts of ``tests/test_convert.py``
  (numpy arrays and torch tensors, with and without a module prefix, with
  and without LightGlue's input projection): the port's trees equal the JAX
  converters' trees array for array, and both raise on the same faults.
- A checkpoint written in the official torch layout from the bundled
  ``learned_lg9`` weights (the inverse of the conversion), saved with
  ``torch.save`` and read back by the loaders: the tree equals the bundle,
  and it runs through the port's SuperPoint (against the JAX SuperPoint on
  a rendered 128x160 frame: 90 % of the JAX keypoints to 1e-3 px and 98 %
  to 0.5 px, the pipeline test's gate; measured 92.5 % and 100 % of 80)
  and the port's module-route LightGlue at
  depth 2 (against the flax module: ``matches0`` agreement of at least 98 %,
  scores within 0.05, as ``tests/test_torch_lightglue.py`` holds it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.features import convert as jfc
from gisnav_tpu.features.superpoint import SuperPoint as JSuperPoint
from gisnav_tpu.matching import convert as jmc
from gisnav_tpu.matching import lightglue as jlg
from gisnav_tpu_torch.features import convert as tfc
from gisnav_tpu_torch.features.superpoint import SuperPoint
from gisnav_tpu_torch.matching import convert as tmc
from gisnav_tpu_torch.matching import lightglue as tlg
from gisnav_tpu_torch.utils.world import render_scene
from gisnav_tpu_torch.weights import load_bundled, params_from_jax

from tests.test_convert import _fake_lightglue_state, _fake_superpoint_state
from tests.test_torch_lightglue import _match_inputs

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


def _assert_same_tree(got, want):
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("prefix,as_tensor", [("", False), ("net.", True)])
def test_superpoint_tree_equals_jax(prefix, as_tensor):
    state = _fake_superpoint_state(np.random.default_rng(0))
    state = {prefix + k: torch.as_tensor(v) if as_tensor else v
             for k, v in state.items()}
    _assert_same_tree(tfc.superpoint_params_from_torch(state),
                      jfc.superpoint_params_from_torch(state))


def test_superpoint_missing_layer_raises():
    state = _fake_superpoint_state(np.random.default_rng(1))
    del state["conv3b.weight"]
    with pytest.raises(KeyError, match="conv3b"):
        tfc.superpoint_params_from_torch(state)
    assert tfc.SUPERPOINT_LAYERS == jfc.SUPERPOINT_LAYERS


@pytest.mark.parametrize("depth,take,input_proj", [(2, 2, True),
                                                   (3, 2, True),
                                                   (2, 1, False)])
def test_lightglue_tree_equals_jax(depth, take, input_proj):
    state = _fake_lightglue_state(np.random.default_rng(depth), depth=depth)
    if not input_proj:
        del state["input_proj.weight"], state["input_proj.bias"]
    state = {k: torch.as_tensor(v) for k, v in state.items()}
    _assert_same_tree(tmc.lightglue_params_from_torch(state, depth=take),
                      jmc.lightglue_params_from_torch(state, depth=take))


def test_lightglue_faults_raise():
    state = _fake_lightglue_state(np.random.default_rng(2), depth=2)
    with pytest.raises(ValueError, match="depth"):
        tmc.lightglue_params_from_torch(state, depth=5)
    with pytest.raises(KeyError, match="transformers"):
        tmc.lightglue_params_from_torch({"input_proj.weight": np.eye(2)})
    del state["transformers.1.cross_attn.to_v.weight"]
    with pytest.raises(KeyError, match="to_v"):
        tmc.lightglue_params_from_torch(state, depth=2)


def _torch_layout(tree, heads=4):
    """The official torch state dicts of a JAX-layout deep tree: the
    inverse of both conversions (Wqkv columns interleaved again)."""
    sp = {}
    for name, leaf in tree["superpoint"]["params"].items():
        sp[f"net.{name}.weight"] = torch.as_tensor(
            np.transpose(leaf["kernel"], (3, 2, 0, 1)).copy())
        sp[f"net.{name}.bias"] = torch.as_tensor(leaf["bias"])
    lgp = tree["lightglue"]["params"]
    lg = {}

    def lin(prefix, node):
        lg[f"{prefix}.weight"] = torch.as_tensor(node["kernel"].T.copy())
        if "bias" in node:
            lg[f"{prefix}.bias"] = torch.as_tensor(node["bias"])

    def ffn(prefix, node):
        lin(f"{prefix}.0", node["fc1"])
        lg[f"{prefix}.1.weight"] = torch.as_tensor(node["norm"]["scale"])
        lg[f"{prefix}.1.bias"] = torch.as_tensor(node["norm"]["bias"])
        lin(f"{prefix}.3", node["fc2"])

    lin("input_proj", lgp["input_proj"])
    lin("posenc.Wr", lgp["posenc"]["Wr"])
    depth = sum(1 for k in lgp if k.startswith("self_"))
    for i in range(depth):
        p, s, c = f"transformers.{i}", lgp[f"self_{i}"], lgp[f"cross_{i}"]
        k = s["Wqkv"]["kernel"]
        dh = k.shape[1] // 3 // heads
        lin(f"{p}.self_attn.Wqkv", {
            "kernel": k.reshape(-1, heads, 3, dh).transpose(0, 1, 3, 2)
            .reshape(k.shape),
            "bias": s["Wqkv"]["bias"].reshape(heads, 3, dh)
            .transpose(0, 2, 1).reshape(-1)})
        lin(f"{p}.self_attn.out_proj", s["out_proj"])
        ffn(f"{p}.self_attn.ffn", s["ffn"])
        for name in ("to_qk", "to_v", "to_out"):
            lin(f"{p}.cross_attn.{name}", c[name])
        ffn(f"{p}.cross_attn.ffn", c["ffn"])
        # one assignment head a layer, as the official model has
        for name in ("final_proj", "matchability"):
            lin(f"log_assignment.{i}.{name}", lgp[name])
    return sp, lg


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tree, _ = load_bundled("learned_lg9")
    sp, lg = _torch_layout(tree)
    root = tmp_path_factory.mktemp("ckpt")
    torch.save({"state_dict": sp}, root / "superpoint.pth")
    torch.save(lg, root / "lightglue.pth")
    return tree, root


def test_loaders_restore_the_bundle(checkpoint):
    tree, root = checkpoint
    sp = tfc.load_superpoint_checkpoint(str(root / "superpoint.pth"))
    _assert_same_tree(sp, tree["superpoint"])
    _assert_same_tree(sp, jfc.load_superpoint_checkpoint(
        str(root / "superpoint.pth")))
    lg = tmc.load_lightglue_checkpoint(str(root / "lightglue.pth"), depth=9)
    _assert_same_tree(lg, tree["lightglue"])
    _assert_same_tree(lg, jmc.load_lightglue_checkpoint(
        str(root / "lightglue.pth"), depth=9))


def test_converted_superpoint_runs_as_jax(checkpoint):
    _, root = checkpoint
    sp = tfc.load_superpoint_checkpoint(str(root / "superpoint.pth"))
    img = render_scene(seed=5, h=128, w=160, yaws=[10.0]).frames[0].astype(
        np.float32) / 255.0
    got = SuperPoint(params_from_jax({"superpoint": sp})["superpoint"],
                     256)(torch.as_tensor(img))
    want = JSuperPoint(max_keypoints=256).apply(sp, jnp.asarray(img))
    a = got.keypoints[got.mask].numpy()
    b = np.asarray(want.keypoints)[np.asarray(want.mask)]
    assert len(b) > 40
    d = np.linalg.norm(b[:, None] - a[None], axis=-1).min(axis=1)
    assert (d < 1e-3).mean() >= 0.9 and (d < 0.5).mean() >= 0.98


def test_converted_lightglue_runs_as_jax(checkpoint):
    _, root = checkpoint
    lg = tmc.load_lightglue_checkpoint(str(root / "lightglue.pth"), depth=2)
    kp0, d0, m0, kp1, d1, m1 = _match_inputs(3, 256, 256)
    size = (480, 640)
    ref = jlg.LightGlue(depth=2, filter_threshold=0.0).apply(
        lg, *(jnp.asarray(a) for a in (kp0, d0, m0)), size,
        *(jnp.asarray(a) for a in (kp1, d1, m1)), size)
    model = tlg.LightGlue(params_from_jax({"lightglue": lg})["lightglue"],
                          depth=2, filter_threshold=0.0)
    got = model(*(torch.as_tensor(a) for a in (kp0, d0, m0)), size,
                *(torch.as_tensor(a) for a in (kp1, d1, m1)), size)
    ref_m0 = np.asarray(ref.matches0)
    assert (ref_m0 >= 0).sum() > 256 // 8
    assert (got.matches0.numpy() == ref_m0).mean() >= 0.98
    assert np.abs(got.scores.numpy() - np.asarray(ref.scores)).max() < 0.05
