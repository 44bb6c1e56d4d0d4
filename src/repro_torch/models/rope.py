"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE."""
from __future__ import annotations

from typing import Tuple

import torch


def _inv_freqs(half: int, theta: float, device) -> torch.Tensor:
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    # theta filled on the device: a host tensor copied to the card would
    # synchronise, which a CUDA graph capture refuses
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), exps)


def _rotate(x: torch.Tensor, sin: torch.Tensor,
            cos: torch.Tensor) -> torch.Tensor:
    """Rotate-half on split halves: pairs are (x[:D/2], x[D/2:])."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] -> rotated x (pairs = halves)."""
    half = x.shape[-1] // 2
    ang = positions.float()[..., None] * _inv_freqs(half, theta, x.device)
    return _rotate(x, torch.sin(ang)[:, :, None, :],
                   torch.cos(ang)[:, :, None, :])


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, ...],
                theta: float = 1_000_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: [B, S, H, D]; positions3: [B, S, 3] (t, h, w) positions;
    sections: per-axis number of frequency PAIRS, sum(sections) == D//2.
    Text tokens use identical (t,h,w), which reduces to standard RoPE.
    """
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, x.shape[-1])
    # pick which position axis drives each frequency band
    axis_id = torch.cat([torch.full((s,), i, dtype=torch.long,
                                    device=x.device)
                         for i, s in enumerate(sections)])      # [half]
    pos = torch.gather(positions3.float(), -1,
                       axis_id.expand(positions3.shape[:2] + (half,)))
    ang = pos * _inv_freqs(half, theta, x.device)               # [B,S,half]
    return _rotate(x, torch.sin(ang)[:, :, None, :],
                   torch.cos(ang)[:, :, None, :])


def position_encode(x: torch.Tensor, positions: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Dispatch the RoPE flavour from a ModelConfig."""
    if cfg.mrope_sections:
        if positions.dim() == 2:    # text-only: (t,h,w) all equal
            positions3 = positions[..., None].expand(positions.shape + (3,))
        else:
            positions3 = positions
        return apply_mrope(x, positions3, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)
