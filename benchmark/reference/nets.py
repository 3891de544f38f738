"""The plain reference of the models: CLIP ViT-B/32 with the region head,
the cascaded DM-GAN generator and the spectral-norm discriminators.

Copied, frozen, from the port at commit c2e05f1:
``t2igan_torch/models/clip.py``, ``models/generator.py``,
``models/discriminator.py``, ``ops/spectral.py``, ``ops/attention.py``
(``l2_normalize``), ``ops/image.py`` and the plain memory read of
``ops/kernels/memory_read.py`` (``memory_read_plain``).  Every kernel call
is replaced by its plain form, the data-parallel and fused-tail branches
are gone, and every product (convolution, linear, matmul, einsum) goes
through a :class:`Numerics`, which keeps it in f32 or rounds its operands
to a lower precision for the control.  Parameter and buffer names are the
port's, so one state dict loads into both.

It imports nothing of the port.  TF32 must be off while it runs
(:func:`benchmark.reference.exact`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG = -3.4e38       # CLIP's causal and padding fill
NEG_INF = -1e9      # the memory read's and the losses' padding fill
FP8_MAX = 448.0     # largest finite float8_e4m3fn


class Numerics:
    """How the reference computes its products.  ``operands`` None: in
    f32.  ``"tf32"``, ``"bf16"`` or ``"fp8"``: both operands of every
    product are rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero, as the tensor cores' conversion), to bfloat16, or to float8
    e4m3 under a per-tensor scale (its largest magnitude at 448), before an
    f32 product: the control, the reference one precision below the
    configuration's.  Sums stay f32, as a tensor core's do."""

    def __init__(self, operands: Optional[str] = None):
        if operands not in (None, "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown operand precision {operands!r}")
        self.operands = operands

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in f32, its value rounded to the operand precision; the
        gradient passes the rounding unchanged (the backward's products
        take the rounded operands and f32 gradients)."""
        t = t.float()
        if self.operands is None:
            return t
        with torch.no_grad():
            if self.operands == "tf32":
                bits = t.detach().contiguous().view(torch.int32)
                r = ((bits + 0x1000) & -0x2000).view(torch.float32)
            elif self.operands == "bf16":
                r = t.to(torch.bfloat16).float()
            else:
                scale = FP8_MAX / t.abs().amax().clamp(min=1e-30)
                r = (t * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (r - t).detach() if t.requires_grad else r

    def linear(self, x, weight, bias=None):
        return F.linear(self.q(x), self.q(weight),
                        None if bias is None else bias.float())

    def conv(self, x, weight, bias=None, stride=1, padding=1):
        return F.conv2d(self.q(x), self.q(weight),
                        None if bias is None else bias.float(), stride,
                        padding)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


# ------------------------------------------------------------------ CLIP --

@dataclasses.dataclass(frozen=True)
class Tower:
    hidden_size: int
    num_layers: int
    num_heads: int
    mlp_dim: int
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class ClipWidths:
    vocab_size: int
    max_positions: int
    eos_token_id: int
    projection_dim: int
    image_size: int
    patch_size: int
    region_dim: int
    text: Tower
    vision: Tower

    @classmethod
    def from_json(cls, d: dict) -> "ClipWidths":
        d = dict(d)
        return cls(**{**d, "text": Tower(**d["text"]),
                      "vision": Tower(**d["vision"])})


def layer_norm(x, mod: nn.LayerNorm):
    return F.layer_norm(x.float(), mod.normalized_shape, mod.weight.float(),
                        mod.bias.float(), mod.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, bias, n: Numerics):
        b, l, d = x.shape
        h = self.heads
        hd = d // h
        qkv = n.linear(x, self.qkv_proj.weight, self.qkv_proj.bias)
        qkv = qkv.reshape(b, l, 3, h, hd)
        q = qkv[:, :, 0] * (hd ** -0.5)
        logits = n.einsum("bqhd,bkhd->bhqk", q, qkv[:, :, 1])
        if bias is not None:
            logits = logits + bias
        w = torch.softmax(logits, dim=-1)
        out = n.einsum("bhqk,bkhd->bqhd", w, qkv[:, :, 2]).reshape(b, l, d)
        return n.linear(out, self.out_proj.weight, self.out_proj.bias)


class Layer(nn.Module):
    def __init__(self, c: Tower):
        super().__init__()
        d = c.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.self_attn = Attention(d, c.num_heads)
        self.layer_norm2 = nn.LayerNorm(d, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(d, c.mlp_dim)
        self.fc2 = nn.Linear(c.mlp_dim, d)

    def forward(self, x, bias, n: Numerics):
        x = x + self.self_attn(layer_norm(x, self.layer_norm1), bias, n)
        h = n.linear(layer_norm(x, self.layer_norm2), self.fc1.weight,
                     self.fc1.bias)
        h = h * torch.sigmoid(1.702 * h)
        return x + n.linear(h, self.fc2.weight, self.fc2.bias)


class TextTower(nn.Module):
    def __init__(self, cfg: ClipWidths):
        super().__init__()
        c = cfg.text
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_positions, c.hidden_size))
        self.layers = nn.ModuleList(Layer(c) for _ in range(c.num_layers))
        self.final_layer_norm = nn.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps)

    def forward(self, ids, mask, n: Numerics):
        b, l = ids.shape
        ids = ids.long().clamp(0, self.cfg.vocab_size - 1)
        x = (self.token_embedding.weight[ids].float()
             + self.position_embedding[:l].float())
        dev = x.device
        bias = torch.triu(torch.full((l, l), NEG, device=dev), 1)[None, None]
        if mask is not None:
            bias = bias + torch.where(mask[:, None, None, :] > 0,
                                      torch.zeros((), device=dev),
                                      torch.full((), NEG, device=dev))
        for layer in self.layers:
            x = layer(x, bias, n)
        x = layer_norm(x, self.final_layer_norm)
        eos = torch.argmax((ids == self.cfg.eos_token_id).int(), dim=-1)
        return x, x[torch.arange(b, device=dev), eos]


class PatchEmbed(nn.Module):
    def __init__(self, channels: int, hidden: int, patch: int):
        super().__init__()
        self.patch = patch
        self.kernel = nn.Parameter(torch.empty(patch, patch, channels,
                                               hidden))

    def forward(self, x, n: Numerics):
        b, h, w, c = x.shape
        p = self.patch
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return n.q(x) @ n.q(self.kernel.reshape(p * p * c, -1))


class VisionTower(nn.Module):
    def __init__(self, cfg: ClipWidths):
        super().__init__()
        c = cfg.vision
        self.patch_embedding = PatchEmbed(3, c.hidden_size, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.empty(c.hidden_size))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(torch.empty(n_pos,
                                                           c.hidden_size))
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(Layer(c) for _ in range(c.num_layers))
        self.post_layernorm = nn.LayerNorm(c.hidden_size,
                                           eps=c.layer_norm_eps)

    def forward(self, pixels, n: Numerics):
        patches = self.patch_embedding(pixels, n)
        b, _, d = patches.shape
        x = torch.cat([self.class_embedding.float().expand(b, 1, d),
                       patches], dim=1)
        x = layer_norm(x + self.position_embedding[:x.shape[1]].float(),
                       self.pre_layrnorm)
        for layer in self.layers:
            x = layer(x, None, n)
        return x, layer_norm(x[:, 0], self.post_layernorm)


class Clip(nn.Module):
    def __init__(self, cfg: ClipWidths):
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

    def encode_text(self, ids, mask, n: Numerics):
        words, pooled = self.text_model(ids, mask, n)
        return words, n.linear(pooled, self.text_projection.weight)

    def encode_image(self, pixels, n: Numerics):
        hidden, pooled = self.vision_model(pixels, n)
        return (n.linear(hidden, self.linear_subr.weight,
                         self.linear_subr.bias),
                n.linear(pooled, self.visual_projection.weight))


# ------------------------------------------------------------- generator --

def l2_normalize(x, dim=-1, eps=1e-8):
    return x / (torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)) + eps)


def resize_nearest(x, size: int):
    """NHWC nearest resize, source pixel floor((i + 0.5) * in / out)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def memory_read(q_map, key, value, pad_mask, n: Numerics):
    """Each pixel of q_map [B, H, W, C] attends over the slots of key/value
    [B, L, C]; -1e9 at padding (pad_mask True)."""
    b, h, w, c = q_map.shape
    logits = n.einsum("bqc,blc->bql", q_map.reshape(b, h * w, c), key)
    logits = logits.masked_fill(pad_mask[:, None, :], NEG_INF)
    read = n.einsum("bql,blc->bqc", torch.softmax(logits, -1), value)
    return read.reshape(b, h, w, c)


class BatchNorm(nn.Module):
    """flax's BatchNorm: eps 1e-5, momentum 0.9, biased batch variance
    max(0, E[x^2] - E[x]^2)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool):
        shape = [1, -1] + [1] * (x.dim() - 2)
        if train:
            dims = [d for d in range(x.dim()) if d != 1]
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - mean.view(shape)) * mul.view(shape) \
            + self.bias.float().view(shape)


def conv3x3(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv3x3(cin, 2 * cout)
        self.bn = BatchNorm(2 * cout)

    def forward(self, x, train, n: Numerics):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return F.glu(self.bn(n.conv(x, self.conv.weight), train), dim=1)


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = conv3x3(c, 2 * c)
        self.bn1 = BatchNorm(2 * c)
        self.conv2 = conv3x3(c, c)
        self.bn2 = BatchNorm(c)

    def forward(self, x, train, n: Numerics):
        h = F.glu(self.bn1(n.conv(x, self.conv1.weight), train), dim=1)
        return x + self.bn2(n.conv(h, self.conv2.weight), train)


class CANet(nn.Module):
    def __init__(self, nef: int, cond: int):
        super().__init__()
        self.cond = cond
        self.fc = nn.Linear(nef, 4 * cond)

    def forward(self, sent, eps, n: Numerics):
        x = F.glu(n.linear(sent, self.fc.weight, self.fc.bias), dim=-1)
        mu, logvar = x[:, :self.cond], x[:, self.cond:]
        return mu + torch.exp(0.5 * logvar) * eps.float(), mu, logvar


class InitStage(nn.Module):
    def __init__(self, ngf: int, in_dim: int):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Linear(in_dim, ngf * 4 * 4 * 2, bias=False)
        self.bn = BatchNorm(ngf * 4 * 4 * 2)
        self.upsample = nn.ModuleList(UpBlock(ngf // 2 ** i,
                                              ngf // 2 ** (i + 1))
                                      for i in range(4))

    def forward(self, z, c, train, n: Numerics):
        x = n.linear(torch.cat([c, z.float()], -1), self.fc.weight)
        x = F.glu(self.bn(x, train), dim=-1).reshape(x.shape[0], self.ngf,
                                                     4, 4)
        for up in self.upsample:
            x = up(x, train, n)
        return x


class NextStage(nn.Module):
    def __init__(self, ngf: int, nef: int, num_residual: int):
        super().__init__()
        self.A = nn.Linear(nef, 1, bias=False)
        self.B = nn.Linear(ngf, 1, bias=False)
        self.M_w = nn.Linear(nef, 2 * ngf)
        self.M_r = nn.Linear(ngf, 2 * ngf)
        self.key = nn.Linear(2 * ngf, ngf)
        self.value = nn.Linear(2 * ngf, ngf)
        self.response_gate = nn.Conv2d(2 * ngf, 1, 1)
        self.residual = nn.ModuleList(ResBlock(2 * ngf)
                                      for _ in range(num_residual))
        self.upsample = UpBlock(2 * ngf, ngf)

    def forward(self, h, words, pad_mask, train, n: Numerics):
        h_avg = h.mean(dim=(2, 3)).detach()
        gate = torch.sigmoid(n.linear(words, self.A.weight)
                             + n.linear(h_avg, self.B.weight)[:, None, :])
        m_w = F.relu(n.linear(words, self.M_w.weight, self.M_w.bias))
        m_r = F.relu(n.linear(h_avg, self.M_r.weight, self.M_r.bias))
        memory = m_w * gate + m_r[:, None, :] * (1.0 - gate)
        key = F.relu(n.linear(memory, self.key.weight, self.key.bias))
        value = F.relu(n.linear(memory, self.value.weight, self.value.bias))
        read = memory_read(h.permute(0, 2, 3, 1), key, value, pad_mask, n)
        read = read.permute(0, 3, 1, 2)
        gate_r = torch.sigmoid(n.conv(torch.cat([h, read], 1),
                                      self.response_gate.weight,
                                      self.response_gate.bias, padding=0))
        h = h * (1.0 - gate_r) + gate_r * read
        h = torch.cat([h, h], dim=1)
        for block in self.residual:
            h = block(h, train, n)
        return self.upsample(h, train, n)


class Head(nn.Module):
    def __init__(self, ngf: int):
        super().__init__()
        self.conv = conv3x3(ngf, 3)

    def forward(self, h, n: Numerics):
        return torch.tanh(n.conv(h, self.conv.weight))


class Generator(nn.Module):
    def __init__(self, gf_dim: int, nef: int, condition_dim: int, z_dim: int,
                 branch_num: int, num_residual: int):
        super().__init__()
        self.ca_net = CANet(nef, condition_dim)
        self.init_stage = InitStage(gf_dim * 16, condition_dim + z_dim)
        self.next_stages = nn.ModuleList(
            NextStage(gf_dim, nef, num_residual)
            for _ in range(branch_num - 1))
        self.image_heads = nn.ModuleList(Head(gf_dim)
                                         for _ in range(branch_num))

    def forward(self, z, sent, words, pad_mask, eps, train, n: Numerics):
        """Images [B, s, s, 3] per pyramid size, mu, logvar."""
        c, mu, logvar = self.ca_net(sent.float(), eps, n)
        h = self.init_stage(z, c, train, n)
        words = words.float()
        imgs = [self.image_heads[0](h, n)]
        for stage, head in zip(self.next_stages, self.image_heads[1:]):
            h = stage(h, words, pad_mask, train, n)
            imgs.append(head(h, n))
        return [i.permute(0, 2, 3, 1) for i in imgs], mu, logvar


# -------------------------------------------------------- discriminators --

def l2n(v, eps=1e-12):
    return v / (torch.linalg.vector_norm(v) + eps)


class SNConv(nn.Module):
    """Conv with weight / sigma, one power iteration from the stored u
    (weight flattened in (kh, kw, in) order); u and v stored only with
    ``update``.  sigma in f32 from the parameters, as the port's."""

    def __init__(self, cin, cout, k, stride=1, padding=1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("u", torch.empty(cout))
        self.register_buffer("v", torch.empty(k * k * cin))

    def forward(self, x, update, n: Numerics):
        w2d = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0],
                                                      -1)
        with torch.no_grad():
            v = l2n(w2d.T @ self.u)
            u = l2n(w2d @ v)
            if update:
                self.u.copy_(u)
                self.v.copy_(v)
        weight = self.weight / torch.dot(u, w2d @ v)
        return n.conv(x, weight, self.bias, self.stride, self.padding)


class SNBlock(nn.Module):
    def __init__(self, cin, cout, k, stride):
        super().__init__()
        self.conv = SNConv(cin, cout, k, stride, 1)

    def forward(self, x, update, n):
        return F.leaky_relu(self.conv(x, update, n), 0.2)


class Encode16x(nn.Module):
    def __init__(self, ndf):
        super().__init__()
        ch = [3, ndf, 2 * ndf, 4 * ndf, 8 * ndf]
        self.blocks = nn.ModuleList(SNBlock(a, b, 4, 2)
                                    for a, b in zip(ch, ch[1:]))


class Trunk(nn.Module):
    def __init__(self, ndf, size):
        super().__init__()
        self.encode = Encode16x(ndf)
        down, blocks = [], []
        if size >= 128:
            down.append(SNBlock(8 * ndf, 16 * ndf, 4, 2))
            if size == 128:
                blocks.append(SNBlock(16 * ndf, 8 * ndf, 3, 1))
        if size >= 256:
            down.append(SNBlock(16 * ndf, 32 * ndf, 4, 2))
            blocks += [SNBlock(32 * ndf, 16 * ndf, 3, 1),
                       SNBlock(16 * ndf, 8 * ndf, 3, 1)]
        self.down = nn.ModuleList(down)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, update, n):
        h = x.permute(0, 3, 1, 2)
        for block in [*self.encode.blocks, *self.down, *self.blocks]:
            h = block(h, update, n)
        return h


class Logits(nn.Module):
    def __init__(self, ndf, nef, cond):
        super().__init__()
        self.nef = nef
        self.joint = SNBlock(8 * ndf + nef, 8 * ndf, 3, 1) if cond else None
        self.conv = nn.Conv2d(8 * ndf, 1, 4, stride=4)

    def forward(self, h, c, n):
        if self.joint is not None:
            c = c.float()[:, :, None, None].expand(h.shape[0], self.nef, 4, 4)
            h = self.joint(torch.cat([h, c], 1), False, n)
        return n.conv(h, self.conv.weight, self.conv.bias, 4, 0).reshape(-1)


class Discriminator(nn.Module):
    """Trunk (NCHW code), conditional and unconditional heads."""

    def __init__(self, ndf, nef, size):
        super().__init__()
        self.trunk = Trunk(ndf, size)
        self.cond_head = Logits(ndf, nef, True)
        self.uncond_head = Logits(ndf, nef, False)


def build(widths: dict, clip: ClipWidths):
    """(Clip, Generator, [Discriminator per pyramid size]) at the
    configuration's widths, parameters uninitialised."""
    g = widths
    gen = Generator(g["GF_DIM"], g["EMBEDDING_DIM"], g["CONDITION_DIM"],
                    g["Z_DIM"], g["BRANCH_NUM"], g["R_NUM"])
    sizes = [g["BASE_SIZE"] * 2 ** i for i in range(g["BRANCH_NUM"])]
    ds = [Discriminator(g["DF_DIM"], g["EMBEDDING_DIM"], s) for s in sizes]
    return Clip(clip), gen, ds


def pyramid(widths: dict) -> List[int]:
    return [widths["BASE_SIZE"] * 2 ** i for i in range(widths["BRANCH_NUM"])]
