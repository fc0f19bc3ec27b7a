"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

import numpy as np

import jax
import torch

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
    shapes = jax.eval_shape(
        lambda r: jmodel.init_params(r, image_hw), jax.random.PRNGKey(0))
    return draw_params(shapes, seed)


def random_module_params(module, x_shape, seed):
    """The same draws for a flax module applied to one input of
    ``x_shape`` (f32)."""
    shapes = jax.eval_shape(
        lambda r: module.init(r, jax.numpy.zeros(x_shape)),
        jax.random.PRNGKey(0))
    return draw_params(shapes, seed)


def draw_params(shapes, seed):
    """Seeded draws over a ``{"params": ...}`` tree of shapes, flat."""
    rng = np.random.RandomState(seed)
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


def flatten_params(tree, prefix=""):
    """The ``{"params": {"a": {"b": v}}}`` tree -> ``{"params/a/b": v}``
    numpy arrays (for a gradient tree too: it has the parameters' layout)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v, np.float32)
    return flat


class Replay:
    """The port's ``draw(shape)`` callable over pre-drawn uniform blocks:
    each call pops the next block and checks its shape."""

    def __init__(self, blocks):
        self.blocks = [np.asarray(b, np.float32) for b in blocks]

    def __call__(self, shape):
        arr = self.blocks.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, tuple(shape))
        return torch.from_numpy(arr)

    def done(self):
        return not self.blocks


def balanced_uniforms(keys, n):
    """The (pos, neg) uniform blocks [B, n] that ``balanced_sample`` draws
    for each key: ``split`` into (rng_p, rng_n), then ``uniform``."""
    pairs = [jax.random.split(k) for k in keys]
    return [np.stack([np.asarray(jax.random.uniform(p[w], (n,)))
                      for p in pairs]) for w in range(2)]


def track_uniforms(keys, n_props, n_gt):
    """The (pos, hard negative, neg) blocks the EMM sampler draws for each
    key: ``split(rng, 3)``, then ``uniform`` over each pool."""
    triples = [jax.random.split(k, 3) for k in keys]
    return [np.stack([np.asarray(jax.random.uniform(t[w], (n,)))
                      for t in triples])
            for w, n in enumerate((n_props, n_gt * n_props, n_props))]


def train_draws(key, b, n_anchors, n_props, n_gt):
    """The JAX training step's sampler priorities in the port's order:
    ``forward_train`` splits its key into 3*B per-image keys (RPN, box
    head, EMM sampler), and the port draws per pool for the whole
    batch."""
    rngs = jax.random.split(key, 3 * b)
    return Replay(balanced_uniforms(rngs[:b], n_anchors)
                  + balanced_uniforms(rngs[b:2 * b], n_props)
                  + track_uniforms(rngs[2 * b:], n_props, n_gt))
