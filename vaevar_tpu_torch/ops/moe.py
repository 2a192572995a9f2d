"""Mixture-of-experts routing (switch-style top-1), on tensors.

Port of vaevar_tpu/ops/moe.py: the router's z-loss and load-balancing loss,
top-1 routing with multiplicative jitter, the per-expert capacity mask and
the dense one-hot combine. Every expert runs on every token (a stacked
(E, in, out) product in the caller) and the combine zeroes the slots a token
was not routed to, so nothing is sorted or gathered and every shape is
static.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vaevar_tpu_torch.utils import jax_random


def router_z_loss(router_logits) -> torch.Tensor:
    """mean(logsumexp(logits)^2), in f32."""
    return (torch.logsumexp(router_logits.float(), dim=-1) ** 2).mean()


def load_balancing_loss(router_probs, expert_index, num_experts: int) -> torch.Tensor:
    """num_experts^2 * mean over (..., e) of frac_tokens_e * mean_prob_e,
    both averaged over the token axis (-2)."""
    mask = F.one_hot(expert_index.long(), num_experts).float()
    tokens_per_expert = mask.mean(dim=-2)
    prob_per_expert = router_probs.float().mean(dim=-2)
    return (tokens_per_expert * prob_per_expert).mean() * num_experts ** 2


def top1_route(attr, classifier, rng=None, jitter_noise: float = 1e-2):
    """Top-1 expert choice. attr: (..., attr_dim) router input; classifier:
    attr -> (..., num_experts) logits. With `rng`, attr is first scaled by
    uniform noise in [1 - jitter_noise, 1 + jitter_noise): a torch.Generator
    draws torch's noise, a JAX key (a pair of ints, utils/jax_random.py)
    replays jax.random.uniform's (bit for bit for a float32 attr). Returns
    (expert_index, router_probs, router_logits); the index is the first of
    equal maxima, as jnp.argmax's."""
    if rng is not None and jitter_noise > 0:
        low, high = 1.0 - jitter_noise, 1.0 + jitter_noise
        if isinstance(rng, torch.Generator):
            noise = torch.empty(attr.shape, dtype=torch.float32, device=rng.device)
            noise = noise.uniform_(low, high, generator=rng).to(attr.device)
        else:
            noise = jax_random.uniform(rng, attr.shape, low, high, device=attr.device)
        attr = attr * noise.to(attr.dtype)
    logits = classifier(attr)
    probs = torch.softmax(logits.float(), dim=-1)
    return probs.argmax(dim=-1), probs, logits


def capacity_mask(expert_index, num_experts: int, capacity_factor: float,
                  drop_tokens: bool = True) -> torch.Tensor:
    """(tokens, num_experts) 0/1 routing mask. With drop_tokens, expert e
    keeps its first floor(capacity_factor * tokens / num_experts) tokens in
    token order (position by cumsum) and drops the rest; the floor is taken
    in float32, as JAX takes it."""
    one_hot = F.one_hot(expert_index.long(), num_experts).float()
    if not drop_tokens:
        return one_hot
    n_tokens = expert_index.shape[-1]
    cap = float(np.floor(np.float32(capacity_factor * n_tokens / num_experts)))
    position_in_expert = torch.cumsum(one_hot, dim=-2) * one_hot
    return one_hot * (position_in_expert <= cap)


def moe_combine(expert_outputs, routing_mask, route_probs, x, is_scale_prob: bool = True):
    """Combine per-expert outputs into the token stream, in f32.

    expert_outputs: (E, tokens, d_out), every expert on every token;
    routing_mask: (tokens, E); route_probs: (tokens,) top router prob; x:
    (tokens, d_in), which a dropped token passes through only when
    d_in == d_out. Every token is scaled by its prob, or, without
    is_scale_prob, by p / p.detach(): 1 in value, with p's gradient."""
    combined = torch.einsum("etd,te->td", expert_outputs.float(), routing_mask.float())
    if x.shape[-1] == combined.shape[-1]:
        routed = routing_mask.sum(-1, keepdim=True)  # 1 if routed, else 0
        combined = combined + (1.0 - routed) * x.float()
    p = route_probs[:, None]
    out = combined * p if is_scale_prob else combined * (p / p.detach())
    return out.to(x.dtype)
