"""NT-Xent (SimCLR) contrastive loss (port of :mod:`t2igan.losses.ntxent`):
for anchor i the denominator is every column but itself, so

    loss_i = logsumexp_{j != i}(sim_ij / t) - sim_{i, partner} / t
"""

from __future__ import annotations

import torch

from t2igan_torch.ops.kernels.memory_read import NEG_INF


def nt_xent_loss(z_i: torch.Tensor, z_j: torch.Tensor,
                 temperature: float = 0.5) -> torch.Tensor:
    """z_i, z_j [B, D] paired embeddings; the mean over the 2B anchors."""
    b = z_i.shape[0]
    z = torch.cat([z_i, z_j], dim=0).float()
    zn = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                         min=1e-8)
    sim = (zn @ zn.T) / temperature
    n = 2 * b
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    denom = torch.logsumexp(sim.masked_fill(eye, NEG_INF), dim=-1)
    rows = torch.arange(n, device=z.device)
    pos = sim[rows, (rows + b) % n]
    return torch.mean(denom - pos)
