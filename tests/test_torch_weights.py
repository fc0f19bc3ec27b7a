"""Weight conversion from the JAX package's flax tree to the port, on
the repo's bench weights (``fixtures/bench_weights_f16.npz``: 161 keys,
DLA-34-FPN-EMM with the S2D stem)."""

import os

import numpy as np
import pytest
import torch

from siammot_tpu.utils.checkpoint import _unflatten as jax_unflatten
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils.checkpoint import _unflatten
from siammot_tpu_torch.utils.weights import jax_to_torch, load_npz

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "bench_weights_f16.npz")


@pytest.fixture(scope="module")
def flat():
    return load_npz(FIXTURE)


def test_every_key_is_consumed_once_with_matching_shapes(flat):
    assert len(flat) == 161
    sd = jax_to_torch(flat)
    assert len(sd) == 161
    net = SiamMOT(get_cfg(), device="cpu").build_net()
    want = net.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    n_params = sum(v.numel() for v in sd.values())
    assert 23.5e6 < n_params < 24.5e6


def test_layouts(flat):
    sd = jax_to_torch(flat)
    k = flat["params/body/level2/tree1/conv1/kernel"]        # HWIO
    np.testing.assert_array_equal(
        sd["body.level2.tree1.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = flat["params/box/feature_extractor/fc6/kernel"]      # [in, out]
    np.testing.assert_array_equal(
        sd["box.feature_extractor.fc6.weight"].numpy(), d.T)
    p = flat["params/emm/predictor/cls_tower_conv/kernel"]  # stays HWIO
    np.testing.assert_array_equal(
        sd["emm.predictor.cls_tower_conv.kernel"].numpy(), p)
    np.testing.assert_array_equal(
        sd["body.stem.s2d_base_bn.scale"].numpy(),
        flat["params/body/stem/s2d_base_bn/scale"])


def test_cast_params_loads_strict_in_compute_dtype(flat):
    model = SiamMOT(get_cfg(), device="cpu")
    net = model.cast_params(jax_to_torch(flat))
    assert net.body.level2.tree1.conv1.weight.dtype == torch.bfloat16
    assert net.body.stem.s2d_base_bn.scale.dtype == torch.bfloat16
    bad = jax_to_torch(flat)
    bad.pop("rpn.conv.bias")
    with pytest.raises(RuntimeError):
        model.cast_params(bad)


def test_unknown_leaf_is_rejected():
    with pytest.raises(KeyError):
        jax_to_torch({"params/fpn/inner1/gamma": np.zeros(3, np.float32)})


def test_unflatten_matches_jax(flat):
    small = dict(list(flat.items())[:12])
    want = jax_unflatten(small)
    got = _unflatten(small)

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert a[k] is b[k]
    same(got, want)
