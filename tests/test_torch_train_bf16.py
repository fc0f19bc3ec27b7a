"""The bf16 training gap: the port's DLA-MINI training slice in bfloat16
against ``jax.value_and_grad`` of the JAX ``forward_train``.

The batch, weights, configuration and replayed sampler draws are those of
``test_torch_train_slice.py``, with ``TPU.COMPUTE_DTYPE bfloat16`` (f32
masters, bf16 forward and backward).  bf16 rounds at other places in the
two frameworks (cuDNN/oneDNN add a conv's bias before rounding, flax
after; reductions of bf16 cotangents run in other orders), so the
yardstick is the JAX step's own bf16 gap: both bf16 steps are measured
against the JAX step in f32.

Checked: every loss of the port within 2e-2 relative of the f32
reference (the JAX bf16 step's own gap is up to 5.7e-3 on this batch,
the port's up to 1.1e-2); every parameter gradient within 8x the JAX
bf16 step's gap on that leaf (as a share of the leaf's largest f32
gradient), plus 1e-3 absolute for the two EMM tower conv biases, whose
one-channel GroupNorm groups cancel them (their f32 gradients are
rounding noise, as the f32 slice test notes); and the median share over
all leaves within 1.5x of the JAX bf16 step's median.

``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_bf16.py``
prints the gap per loss and per
gradient leaf.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from siammot_tpu.configs.defaults import get_cfg as jax_get_cfg
from siammot_tpu.core.structures import Boxes as JaxBoxes
from siammot_tpu.models.siammot import SiamMOT as JaxSiamMOT
from siammot_tpu_torch.configs.defaults import get_cfg
from siammot_tpu_torch.core.structures import Boxes
from siammot_tpu_torch.models.siammot import SiamMOT
from siammot_tpu_torch.utils.weights import jax_to_torch
from test_torch_train_slice import B, G, H, OVERRIDES, W, _batch
from torch_port_util import (flatten_params, random_flax_params,
                             train_draws, unflatten_params)

BF16 = ["TPU.COMPUTE_DTYPE", "bfloat16"]
LOSS_RTOL = 2e-2
GRAD_RATIO = 8.0
GRAD_FLOOR = 1e-3
MEDIAN_RATIO = 1.5


def measure():
    """(losses, gradient gaps): per loss (f32 reference, JAX bf16, port
    bf16); per parameter leaf (largest |f32 gradient|, JAX bf16 gap, port
    bf16 gap), each gap a max abs difference to the f32 gradient."""
    rng = np.random.RandomState(0)
    images, boxes, ids, labels, valid, sizes = _batch(rng)
    jgt = JaxBoxes(boxes=jnp.asarray(boxes), scores=jnp.ones((B, G)),
                   ids=jnp.asarray(ids), labels=jnp.asarray(labels),
                   valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(7)
    flat = None
    jax_runs = {}
    for name, extra in (("f32", []), ("bf16", BF16)):
        jcfg = jax_get_cfg()
        jcfg.merge_from_list(OVERRIDES + extra)
        jmodel = JaxSiamMOT(jcfg)
        if flat is None:
            flat = random_flax_params(jmodel, (H, W), seed=1)
            jparams = jax.tree.map(jnp.asarray, unflatten_params(flat))

        def total(p, jmodel=jmodel):
            losses = jmodel.forward_train(p, key, jnp.asarray(images), jgt,
                                          image_size=(W, H),
                                          frame_sizes=jnp.asarray(sizes))
            return sum(losses.values()), losses

        (_, jl), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
            jparams)
        jax_runs[name] = ({k: float(v) for k, v in jl.items()},
                          jax_to_torch(flatten_params(jg)))

    cfg = get_cfg()
    cfg.merge_from_list(OVERRIDES + BF16)
    model = SiamMOT(cfg, device="cpu")
    net = model.build_master(jax_to_torch(flat))
    gt = Boxes(boxes=torch.from_numpy(boxes), scores=torch.ones(B, G),
               ids=torch.from_numpy(ids), labels=torch.from_numpy(labels),
               valid=torch.from_numpy(valid))
    draws = train_draws(key, B,
                        sum(len(a) for a in model.anchors_for((H, W))),
                        cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + G, G)
    losses = model.forward_train(net, draws, torch.from_numpy(images), gt,
                                 (W, H), torch.from_numpy(sizes))
    sum(losses.values()).backward()
    assert draws.done()

    (l32, g32), (l16, g16) = jax_runs["f32"], jax_runs["bf16"]
    loss_rows = {k: (l32[k], l16[k], losses[k].item()) for k in l32}
    grad_rows = {}
    for name, p in net.named_parameters():
        ref = g32[name]
        got = p.grad if p.grad is not None else torch.zeros_like(ref)
        grad_rows[name] = (float(ref.abs().max()),
                           float((g16[name] - ref).abs().max()),
                           float((got - ref).abs().max()))
    return loss_rows, grad_rows


@pytest.fixture(scope="module")
def gaps():
    return measure()


def test_bf16_losses_within_the_bf16_gap(gaps):
    losses, _ = gaps
    assert len(losses) == 7
    for k, (ref, jax_bf16, port) in losses.items():
        assert np.isfinite(port), k
        assert abs(port - ref) <= LOSS_RTOL * abs(ref), (k, ref, port)
        assert abs(jax_bf16 - ref) <= LOSS_RTOL * abs(ref), (k, ref,
                                                              jax_bf16)


def test_bf16_gradients_within_the_bf16_gap(gaps):
    _, grads = gaps
    shares_jax, shares_port = [], []
    for name, (scale, gap_jax, gap_port) in grads.items():
        if scale == 0.0:
            assert gap_port == 0.0, name
            continue
        assert np.isfinite(gap_port), name
        assert gap_port <= GRAD_RATIO * gap_jax + GRAD_FLOOR * (
            scale < GRAD_FLOOR), (name, scale, gap_jax, gap_port)
        shares_jax.append(gap_jax / scale)
        shares_port.append(gap_port / scale)
    assert len(shares_port) > 60
    assert np.median(shares_port) <= MEDIAN_RATIO * np.median(shares_jax)


if __name__ == "__main__":
    losses, grads = measure()
    print("loss: f32 reference, JAX bf16 (rel gap), port bf16 (rel gap)")
    for k, (ref, j, p) in sorted(losses.items()):
        print(f"  {k}: {ref:.6f}, {j:.6f} ({abs(j - ref) / abs(ref):.2e}),"
              f" {p:.6f} ({abs(p - ref) / abs(ref):.2e})")
    print("gradient leaf: max |f32 grad|, JAX bf16 gap / it, port bf16 "
          "gap / it")
    rows = sorted(grads.items(), key=lambda kv: -kv[1][2] / max(kv[1][0],
                                                                 1e-30))
    for name, (s, j, p) in rows:
        if s:
            print(f"  {name}: {s:.3e}, {j / s:.3e}, {p / s:.3e}")
    js = [j / s for s, j, p in grads.values() if s]
    ps = [p / s for s, j, p in grads.values() if s]
    print(f"median share: JAX bf16 {np.median(js):.3e}, port bf16 "
          f"{np.median(ps):.3e} over {len(ps)} leaves")
