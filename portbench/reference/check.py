"""The comparison that decides ``correct`` for a served model: the gap by
which a served token's logit lies below the reference's best at its
position, and whether it lies below the mean of the reference's logits
there (a token no better than one drawn at random); the same read for the
token a control puts first."""

from __future__ import annotations

import torch


def served_gaps(ref: torch.Tensor, tokens: list[int]) -> torch.Tensor:
    """``ref [n, V]`` (row i scores served token i): the reference's best
    logit minus the served token's, per token."""
    idx = torch.tensor(tokens, device=ref.device)
    return ref.max(-1).values - ref.gather(-1, idx[:, None])[:, 0]


def control_gaps(ref: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
    """The gap of the token the control puts first, at each row."""
    return served_gaps(ref, control.argmax(-1).tolist())


def below_mean(ref: torch.Tensor, tokens: list[int]) -> torch.Tensor:
    """Per token: whether the reference scores it under its row's mean logit."""
    idx = torch.tensor(tokens, device=ref.device)
    return ref.gather(-1, idx[:, None])[:, 0] < ref.mean(-1)
