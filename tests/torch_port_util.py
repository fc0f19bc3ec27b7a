"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np

import jax

MINI = ["MODEL.BACKBONE.CONV_BODY", "DLA-MINI-FPN",
        "MODEL.DLA.DLA_STAGE2_OUT_CHANNELS", 16,
        "MODEL.DLA.DLA_STAGE3_OUT_CHANNELS", 32,
        "MODEL.DLA.DLA_STAGE4_OUT_CHANNELS", 64,
        "MODEL.DLA.DLA_STAGE5_OUT_CHANNELS", 64,
        "MODEL.DLA.BACKBONE_OUT_CHANNELS", 32,
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
        "TPU.COMPUTE_DTYPE", "float32", "TPU.POOLER_DTYPE", "float32"]


def random_flax_params(jmodel, image_hw, seed):
    """Seeded numpy weights in the JAX model's flat tree layout
    (``{"params/...": ndarray}``, as ``fixtures/bench_weights_f16.npz``
    stores them): kernels ~ N(0, 1/fan_in), norm scales ~ 1, biases small.
    Only the tree's shapes come from flax (``jax.eval_shape``)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, image_hw), jax.random.PRNGKey(0))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                walk(v, key)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                flat[key] = rng.randn(*v.shape) / np.sqrt(fan_in)
            elif k == "scale":
                flat[key] = 1.0 + 0.05 * rng.randn(*v.shape)
            else:
                flat[key] = 0.05 * rng.randn(*v.shape)

    walk(shapes["params"], "params")
    return {k: v.astype(np.float32) for k, v in flat.items()}


def unflatten_params(flat):
    """``{"params/a/b": v}`` -> the ``{"params": {"a": {"b": v}}}`` tree."""
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
