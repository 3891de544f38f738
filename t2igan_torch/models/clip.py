"""CLIP ViT-B/32 text tower (port of the text half of
:mod:`t2igan.models.clip`).

Semantics kept from the JAX package:

* multi-head attention with one fused qkv projection, q scaled by
  ``head_dim ** -0.5``, f32 logits plus an additive bias and an f32 softmax;
* the bias is the causal fill plus the padding fill, both -3.4e38, so a
  padded key above the diagonal sums to -inf in f32, as it does in JAX;
* token ids are clamped into the vocabulary;
* the sentence vector is the final-LayerNorm state at the first <eos>,
  through the text projection.

The vision tower and the region head are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

NEG = -3.4e38  # ~ finfo(float32).min, as in the JAX package


@dataclasses.dataclass(frozen=True)
class ClipTowerConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    mlp_dim: int
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """Defaults are exactly openai/clip-vit-base-patch32."""

    vocab_size: int = 49408
    max_positions: int = 77
    eos_token_id: int = 49407
    projection_dim: int = 512
    image_size: int = 224
    patch_size: int = 32
    region_dim: int = 512
    text: ClipTowerConfig = ClipTowerConfig(512, 12, 8, 2048)
    vision: ClipTowerConfig = ClipTowerConfig(768, 12, 12, 3072)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    """HF ``CLIPAttention`` semantics: scaled q, additive bias, f32
    softmax.  ``qkv_proj`` holds q, k and v stacked on its output rows."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = self.qkv_proj(x).reshape(b, l, 3, h, hd)
        q = qkv[:, :, 0] * (hd ** -0.5)
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, l, d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Pre-norm block: LN -> MHA -> +res; LN -> MLP(quick_gelu) -> +res."""

    def __init__(self, cfg: ClipTowerConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = MultiHeadAttention(d, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, d)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class TextTower(nn.Module):
    """CLIP text transformer producing (word_states, eos_pooled)."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        c = cfg.text
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_positions, c.hidden_size))
        self.layers = nn.ModuleList(EncoderLayer(c)
                                    for _ in range(c.num_layers))
        self.final_layer_norm = nn.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor]):
        b, l = input_ids.shape
        input_ids = input_ids.clamp(0, self.cfg.vocab_size - 1)
        x = self.token_embedding(input_ids) + self.position_embedding[:l]
        dev = x.device
        causal = torch.triu(torch.full((l, l), NEG, dtype=torch.float32,
                                       device=dev), diagonal=1)
        bias = causal[None, None]
        if attention_mask is not None:
            pad = torch.where(attention_mask[:, None, None, :] > 0,
                              torch.zeros((), device=dev),
                              torch.full((), NEG, device=dev))
            bias = bias + pad  # NEG + NEG overflows to -inf, as in JAX
        for layer in self.layers:
            x = layer(x, bias)
        x = self.final_layer_norm(x)
        # Pool at the first <eos> position (argmax returns the first max).
        eos_pos = torch.argmax((input_ids == self.cfg.eos_token_id).int(),
                               dim=-1)
        pooled = x[torch.arange(b, device=dev), eos_pos]
        return x, pooled


class ClipWithRegionHead(nn.Module):
    """The joint encoder's text side: the text tower and the text
    projection.  The vision tower, visual projection and region head of the
    JAX module are not ported yet."""

    def __init__(self, cfg: ClipConfig = ClipConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = TextTower(cfg)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.projection_dim, bias=False)

    def encode_text_verbose(self, input_ids: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None):
        """(word_embs [B, L, D], sent_emb [B, projection_dim]): the raw
        final-LN hidden states and the projected <eos> state."""
        words, pooled = self.text_model(input_ids, attention_mask)
        return words, self.text_projection(pooled)


@torch.no_grad()
def init_clip_text_(model: ClipWithRegionHead,
                    generator: torch.Generator) -> ClipWithRegionHead:
    """Random weights from ``generator``, with the JAX package's
    initializer families: N(0, 0.02) embeddings, lecun-normal dense
    kernels, zero biases, unit LayerNorms."""
    for name, p in model.named_parameters():
        if name.endswith("embedding.weight") or name.endswith(
                "position_embedding"):
            nn.init.normal_(p, 0.0, 0.02, generator=generator)
        elif "layer_norm" in name and name.endswith("weight"):
            nn.init.ones_(p)
        elif name.endswith("bias"):
            nn.init.zeros_(p)
        else:
            nn.init.normal_(p, 0.0, p.shape[1] ** -0.5, generator=generator)
    return model

