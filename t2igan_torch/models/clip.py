"""CLIP ViT-B/32 text and vision towers with the region head (port of
:mod:`t2igan.models.clip`).

Semantics kept from the JAX package:

* multi-head attention with one fused qkv projection, q scaled by
  ``head_dim ** -0.5``, f32 logits plus an additive bias and an f32 softmax;
* the bias is the causal fill plus the padding fill, both -3.4e38, so a
  padded key above the diagonal sums to -inf in f32, as it does in JAX;
* token ids are clamped into the vocabulary;
* the sentence vector is the final-LayerNorm state at the first <eos>,
  through the text projection;
* the patch embedding is space-to-depth plus one matmul with a
  [p, p, C, D] kernel, the JAX package's layout;
* image regions are the vision tower's last hidden states (before the
  post-LayerNorm) through ``linear_subr``; the image vector is the
  post-LayerNormed CLS state through the visual projection.
"""

from __future__ import annotations

import dataclasses
import math
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
        self.head_dim = dim // num_heads
        self.qkv_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, _ = x.shape
        h, hd = self.num_heads, self.head_dim  # this rank's heads under TP
        qkv = self.qkv_proj(x).reshape(b, l, 3, h, hd)
        q = qkv[:, :, 0] * (hd ** -0.5)
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(
            b, l, h * hd)
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


class PatchEmbed(nn.Module):
    """ViT patch embedding as space-to-depth and one matmul; ``kernel`` is
    [p, p, C, D], as the JAX module's (and a stride-p conv's HWIO)."""

    def __init__(self, channels: int, hidden: int, patch: int):
        super().__init__()
        self.patch = patch
        self.kernel = nn.Parameter(torch.empty(patch, patch, channels,
                                               hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> [B, (H/p)(W/p), D]."""
        b, h, w, cc = x.shape
        p = self.patch
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} is not a multiple of the "
                             f"patch size {p}")
        x = x.reshape(b, h // p, p, w // p, p, cc).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * cc)
        return x @ self.kernel.reshape(p * p * cc, -1)


class VisionTower(nn.Module):
    """CLIP ViT producing (last_hidden [B, 1+P, D], post-LN CLS [B, D])."""

    def __init__(self, cfg: ClipConfig):
        super().__init__()
        c = cfg.vision
        self.patch_embedding = PatchEmbed(3, c.hidden_size, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.empty(c.hidden_size))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(torch.empty(n_pos,
                                                           c.hidden_size))
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(c)
                                    for _ in range(c.num_layers))
        self.post_layernorm = nn.LayerNorm(c.hidden_size,
                                           eps=c.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor):
        """pixel_values: [B, H, W, 3] NHWC."""
        patches = self.patch_embedding(pixel_values)
        b, _, d = patches.shape
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, d)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding[:x.shape[1]].to(x.dtype)
        x = self.pre_layrnorm(x)
        for layer in self.layers:
            x = layer(x)
        return x, self.post_layernorm(x[:, 0])


class ClipWithRegionHead(nn.Module):
    """The joint encoder: CLIP's text and vision towers, their projections,
    the ``linear_subr`` region head and ``logit_scale``."""

    def __init__(self, cfg: ClipConfig = ClipConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = TextTower(cfg)
        self.vision_model = VisionTower(cfg)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.projection_dim, bias=False)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size,
                                           cfg.projection_dim, bias=False)
        self.linear_subr = nn.Linear(cfg.vision.hidden_size, cfg.region_dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_text_verbose(self, input_ids: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None):
        """(word_embs [B, L, D], sent_emb [B, projection_dim]): the raw
        final-LN hidden states and the projected <eos> state."""
        words, pooled = self.text_model(input_ids, attention_mask)
        return words, self.text_projection(pooled)

    def encode_image_verbose(self, pixel_values: torch.Tensor):
        """(region_enc [B, 1+P, region_dim], image_enc [B, projection_dim])
        from NHWC pixels: ``linear_subr`` of the last hidden states and the
        visual projection of the post-LN CLS state."""
        hidden, pooled = self.vision_model(pixel_values)
        return self.linear_subr(hidden), self.visual_projection(pooled)


@torch.no_grad()
def init_clip_(model: ClipWithRegionHead,
               generator: torch.Generator) -> ClipWithRegionHead:
    """Random weights from ``generator``, with the JAX package's
    initializer families: N(0, 0.02) embeddings, lecun-normal dense and
    patch kernels (std ``fan_in ** -0.5``), zero biases, unit LayerNorms,
    ``logit_scale = log(1 / 0.07)``."""
    for name, p in model.named_parameters():
        if name == "logit_scale":
            p.fill_(math.log(1.0 / 0.07))
        elif name.endswith(("embedding.weight", "position_embedding",
                            "class_embedding")):
            nn.init.normal_(p, 0.0, 0.02, generator=generator)
        elif "norm" in name.split(".")[-2] and name.endswith("weight"):
            nn.init.ones_(p)
        elif name.endswith("bias"):
            nn.init.zeros_(p)
        else:
            fan_in = p[..., 0].numel() if p.dim() == 4 else p.shape[1]
            nn.init.normal_(p, 0.0, fan_in ** -0.5, generator=generator)
    return model

