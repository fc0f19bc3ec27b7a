"""Target matcher and balanced sampler (port of ``siammot_tpu.core.matcher``).

Fixed-shape forms of maskrcnn-benchmark's ``Matcher`` and
``BalancedPositiveNegativeSampler``, with any leading batch dimensions.
Matcher sentinels as in the reference: -1 = below the low threshold
(background), -2 = between the thresholds (ignored).

The JAX samplers rank ``jax.random.uniform`` priorities with a stable
argsort.  Here the priorities come from a ``draw(shape)`` callable
(:func:`uniform_draws` by default, a ``torch.Generator`` on the step's
device), so a test can hand both packages the same numbers.  Entries
outside the mask get priority 2.0 and sort last.
"""

from __future__ import annotations

import torch

BELOW_LOW_QUALITY = -1
BETWEEN_THRESHOLDS = -2


def draw_seed(seed: int, iteration: int, rank: int = 0) -> int:
    """The seed of an iteration's sampler draws on a data-parallel rank:
    rank 0 keeps ``seed * 1_000_003 + iteration`` (one process draws as it
    always has), rank r adds ``r * 2**48``, so no two (iteration, rank)
    pairs of a run share a seed while iterations stay below 2**48.  The
    JAX step folds the device index into its key instead
    (``siammot_tpu/parallel/mesh.py:197``)."""
    return seed * 1_000_003 + iteration + rank * (1 << 48)


def uniform_draws(device, seed: int):
    """``draw(shape)`` -> U[0, 1) float32 priorities on ``device`` from a
    generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(shape):
        return torch.rand(shape, generator=gen, device=device)

    return draw


def match_targets(quality: torch.Tensor, gt_valid: torch.Tensor,
                  pred_valid: torch.Tensor, high_threshold: float,
                  low_threshold: float,
                  allow_low_quality_matches: bool = False) -> torch.Tensor:
    """maskrcnn ``Matcher.__call__`` over padded sets.

    quality [..., G, P] (IoU); gt_valid [..., G]; pred_valid [..., P].
    Returns matches [..., P] int32: the matched gt index, or -1 / -2.
    Invalid predictions get -1.
    """
    q = torch.where(gt_valid[..., :, None] & pred_valid[..., None, :],
                    quality, torch.full_like(quality, -1.0))
    matched_vals = q.amax(dim=-2)
    # first maximal index, as jnp.argmax
    matches = q.argmax(dim=-2).to(torch.int32)
    below = torch.full_like(matches, BELOW_LOW_QUALITY)
    out = torch.where(matched_vals < low_threshold, below, matches)
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    out = torch.where(between, torch.full_like(out, BETWEEN_THRESHOLDS), out)
    if allow_low_quality_matches:
        highest_per_gt = q.amax(dim=-1)
        # predictions tied with a gt's best quality are force-matched, to
        # their own argmax gt (the reference's update semantics)
        is_best = (q == highest_per_gt[..., None]) & gt_valid[..., None]
        force = is_best.any(dim=-2) & pred_valid
        out = torch.where(force, matches, out)
    return torch.where(pred_valid, out, below)


def rank_sample(priority: torch.Tensor, mask: torch.Tensor,
                limit) -> torch.Tensor:
    """Keep the ``limit`` (per row) masked entries of lowest priority: the
    JAX ``argsort`` + rank + ``rank < limit`` pick."""
    pri = torch.where(mask, priority, torch.full_like(priority, 2.0))
    order = torch.argsort(pri, dim=-1, stable=True)
    ar = torch.arange(pri.shape[-1], device=pri.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ar)
    if not torch.is_tensor(limit):
        limit = torch.tensor(limit, device=pri.device)
    return mask & (rank < limit[..., None])


def balanced_sample(draw, pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                    batch_size: int, positive_fraction: float):
    """maskrcnn ``BalancedPositiveNegativeSampler`` for each row of [..., N]
    masks: up to ``batch_size * positive_fraction`` random positives, the
    rest of the batch negatives.  Draws the positives' priorities first,
    then the negatives'.  Returns (sampled_pos, sampled_neg)."""
    num_pos_target = int(batch_size * positive_fraction)
    num_pos = pos_mask.sum(-1).clamp(max=num_pos_target)
    sampled_pos = rank_sample(draw(pos_mask.shape), pos_mask, num_pos)
    num_neg = torch.minimum(neg_mask.sum(-1), batch_size - num_pos)
    sampled_neg = rank_sample(draw(neg_mask.shape), neg_mask, num_neg)
    return sampled_pos, sampled_neg
