"""Token sampling: greedy / temperature / top-k / top-p.

Reference: ``agentainer_tpu/engine/sampling.py`` (``sample``,
``sample_step``, ``APPROX_SEG``). Filters are masks over the full vocab so
one call serves a batch mixing greedy and filtered lanes; the exact path
pays ONE descending sort shared by the top-k threshold and the top-p
cumulative. The opt-in ``approx_topk`` path (the reference's ``_approx``)
takes both from the ``APPROX_SEG`` largest logits instead of a sort: the
reference's ``jax.lax.approx_max_k`` is exact top-k off the TPU, and here it
is ``torch.topk``, so the keep sets equal the reference's on the CPU.

Random draws come from an explicit ``torch.Generator`` (Gumbel-max over the
scaled logits). They cannot reproduce JAX's threefry stream: across the two
frameworks only greedy tokens and the top-k/top-p keep sets are identical.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
# the approximate sampler's segment (the reference's): top_k clamps to it,
# and top-p renormalizes over its mass
APPROX_SEG = 128


def filter_logits(
    logits: torch.Tensor,  # [B, V] float32
    top_k: torch.Tensor,  # [B] int, <= 0 → disabled
    top_p: torch.Tensor,  # [B] float, >= 1 → disabled
    approx_topk: bool = False,
) -> torch.Tensor:
    """Per-lane top-k then top-p: dropped tokens become NEG_INF, kept ones
    keep their logit untouched. A lane whose filters are off is returned
    unchanged. ``approx_topk`` reads both thresholds off the ``APPROX_SEG``
    largest logits (descending) instead of the sorted row: top_k clamps to
    the segment, and the top-p cutoff to its last entry, so a flat
    distribution keeps the segment."""
    V = logits.shape[-1]
    if approx_topk:
        desc = torch.topk(logits, min(V, APPROX_SEG), dim=-1, sorted=True).values
    else:
        # ONE shared descending sort: the top-k threshold reads it at k - 1,
        # and masking it below kth reproduces sort(filtered) for the top-p
        # cumulative
        desc = torch.sort(logits, dim=-1, descending=True).values
    n = desc.shape[-1]
    k_eff = top_k.long().clamp(1, n)
    kth = torch.gather(desc, 1, (k_eff - 1)[:, None])  # [B, 1]
    k_on = (top_k > 0)[:, None]
    neg = torch.full_like(logits, NEG_INF)
    filtered = torch.where(k_on & (logits < kth), neg, logits)
    sorted_logits = torch.where(k_on & (desc < kth), NEG_INF, desc)

    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp(max=n - 1)  # [B]
    cutoff_logit = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
    p_on = (top_p < 1.0)[:, None]
    return torch.where(p_on & (filtered < cutoff_logit), neg, filtered)


def _draw(filtered: torch.Tensor, temperature: torch.Tensor, generator, noise=None) -> torch.Tensor:
    """Gumbel-max draw from softmax(filtered / temperature) per lane, from
    uniforms drawn off ``generator`` or given as ``noise`` (same shape)."""
    scaled = filtered / torch.clamp(temperature, min=1e-6)[:, None]
    u = noise if noise is not None else torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(scaled + gumbel, dim=-1)


def sample(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator | None,
    temperature: torch.Tensor | float = 0.0,  # scalar or [B]
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Token ids [B] with one filter setting for the whole batch;
    temperature may be per lane so one batch mixes greedy and sampled."""
    b = logits.shape[0]
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    if temperature.ndim == 0:
        temperature = temperature.expand(b)
    return sample_step(
        logits,
        generator,
        temperature,
        torch.full((b,), int(top_k), device=logits.device),
        torch.full((b,), float(top_p), device=logits.device),
    )


def sample_step(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B] float32, 0 → greedy
    top_k: torch.Tensor,  # [B] int, <= 0 → disabled
    top_p: torch.Tensor,  # [B] float32, >= 1 → disabled
    *,
    all_greedy: bool | None = None,
    approx_topk: bool = False,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-lane sampler: every filter is a per-lane ARRAY, so one call
    serves a batch mixing greedy, temperature, top-k and top-p lanes.

    The all-greedy batch (the dominant agentic case) takes a fast path:
    argmax only, no sort and no draw — exact, since argmax is invariant
    under the filters. The reference decides that on the device
    (``lax.cond``); eager PyTorch would need a host sync to read the flag,
    so callers that know it on the host (the engine does: it owns the
    lanes' sampling parameters) pass ``all_greedy``; None reads it from
    ``temperature``. ``approx_topk`` (static) filters over the
    ``APPROX_SEG`` segment (``filter_logits``); greedy lanes are unaffected.
    ``noise`` ([B, V] uniforms in [0, 1)) replaces the generator's draw: the
    fused decode loop draws a whole loop's uniforms before it starts, as the
    reference splits one key per iteration before its loop."""
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy is None:
        all_greedy = bool((temperature <= 0.0).all())
    if all_greedy:
        return greedy
    filtered = filter_logits(logits, top_k, top_p, approx_topk)
    sampled = _draw(filtered, temperature, generator, noise)
    return torch.where(temperature <= 0.0, greedy, sampled)
