"""Cascaded DM-GAN generator (64 -> 128 -> 256 px).

Port of :mod:`t2igan.models.generator`.  With ``train=False`` batch
normalisation uses its running statistics; with ``train=True`` it
normalises with the batch statistics and updates the running ones as flax
does (:class:`BatchNorm`), and the memory read passes gradients through
the backward kernel.  The conditioning noise ``ca_eps`` always comes from
the caller.

Layout: feature maps are NCHW in ``torch.channels_last`` memory, so
``h.permute(0, 2, 3, 1)`` hands the memory-read kernel a contiguous
[B, H, W, C] query map without a copy.  :class:`GNet` keeps the JAX
package's layout at its edges: word sequences [B, L, D], images out as
[B, s, s, 3].

The JAX package's ``GAN.UPBLOCK`` variants, ``GAN.PHASED_TAIL`` and
``GAN.PHASED_TAIL_TRAIN`` are output-equivalent rewrites of one function
for XLA; the port computes that function in its plain form, nearest-2x
upsample then conv3x3 (then BN, GLU, RGB conv, tanh), for every setting.

``GAN.FUSED_TAIL`` (``fused_tail=True``) sends each refinement stage's
eval-mode tail (ResBlocks, UpBlock and, at the last stage, the RGB head)
through the fused tail kernel (:mod:`t2igan_torch.ops.kernels.reschain`)
on weights folded by the modules' ``fold()``, as the JAX package does;
the folded and laid-out weights are kept on the stage until a weight
changes.  Training keeps the module chain.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from t2igan_torch.ops.attention import memory_read
from t2igan_torch.ops.image import upsample_nearest_2x
from t2igan_torch.ops.kernels import reschain
from t2igan_torch.parallel.mesh import sum_autograd
from t2igan_torch.utils.profiling import span

UPBLOCK_VARIANTS = ("dilated", "naive", "subpixel")


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gated linear unit: ``a * sigmoid(b)`` over the two halves of ``dim``
    (one fused ``F.glu`` pass)."""
    return F.glu(x, dim=dim)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


def hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's weight [Cout, Cin, kh, kw] as the JAX kernel layout
    [kh, kw, Cin, Cout] (a view)."""
    return conv.weight.permute(2, 3, 1, 0)


# The data-parallel mesh whose batch the train-mode BatchNorms normalise
# over; see :func:`global_batch_stats`.
_STATS_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "batch_stats_mesh", default=None)


@contextlib.contextmanager
def global_batch_stats(mesh):
    """Within this block (in this thread or task) every train-mode
    :class:`BatchNorm` takes its statistics over ``mesh``'s global batch
    (a :class:`t2igan_torch.parallel.mesh.DataMesh`; None or a mesh
    without a group changes nothing)."""
    token = _STATS_MESH.set(mesh)
    try:
        yield
    finally:
        _STATS_MESH.reset(token)


class BatchNorm(nn.Module):
    """Batch normalisation over dim 1 with eps 1e-5 and momentum 0.9, as
    the JAX package's flax ``nn.BatchNorm``.

    ``train=False``: ``(x - running_mean) / sqrt(running_var + eps) *
    weight + bias`` in one ``F.batch_norm`` pass.  ``train=True``: the
    batch mean and the biased variance ``max(0, E[x^2] - E[x]^2)`` in f32
    (flax's ``_compute_stats``) normalise ``x``, and the running statistics
    become ``0.9 * running + 0.1 * batch``.  ``F.batch_norm(training=True)``
    would put the unbiased variance, n / (n - 1) larger, into
    ``running_var``.  The output has ``x``'s dtype.

    Inside :func:`global_batch_stats` the train-mode statistics are those
    of the global batch (PARITY D10): each rank's mean and ``E[x^2]``,
    weighted by its share ``n / N`` of the rows, are summed over ranks in
    f32 by an autograd all_reduce, whose backward sums the statistics'
    gradients over ranks.  ``torch.nn.SyncBatchNorm`` would put the
    unbiased variance into ``running_var`` (ROADMAP F3).  At a share of 1
    (one rank) the arithmetic is the single-process one, bit for bit.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        dims = [d for d in range(x.dim()) if d != 1]
        xf = x.float()
        mean = xf.mean(dims)
        mesh = _STATS_MESH.get()
        if mesh is None or not mesh.distributed:
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        else:
            # Rows are split evenly (ranks_for_batch), so n / N = 1 / W.
            share = torch.stack([mean, (xf * xf).mean(dims)]) / mesh.world
            mean, mean_sq = sum_autograd(share, mesh.group).unbind()
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
            self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def fold(self):
        """Eval mode as an f32 per-channel affine ``(scale, shift)``:
        ``scale = weight * rsqrt(running_var + eps)``, ``shift = bias -
        running_mean * scale``."""
        scale = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                  + self.eps)
        return scale, self.bias.float() - self.running_mean.float() * scale


class UpBlock(nn.Module):
    """Nearest-2x upsample, conv3x3 -> 2F, BN, GLU -> F channels."""

    def __init__(self, in_features: int, features: int,
                 variant: str = "dilated"):
        super().__init__()
        if variant not in UPBLOCK_VARIANTS:
            raise ValueError(f"unknown UpBlock variant {variant!r}; expected "
                             f"one of {UPBLOCK_VARIANTS}")
        self.conv = conv3x3(in_features, 2 * features)
        self.bn = BatchNorm(2 * features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return glu(self.bn(self.conv(upsample_nearest_2x(x)), train))

    def fold(self):
        """(kernel HWIO, scale, shift) of the eval-mode block."""
        return (hwio(self.conv), *self.bn.fold())


class ResBlock(nn.Module):
    """conv3x3 -> 2F, BN, GLU, conv3x3 -> F, BN, plus the input."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = conv3x3(features, 2 * features)
        self.bn1 = BatchNorm(2 * features)
        self.conv2 = conv3x3(features, features)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = glu(self.bn1(self.conv1(x), train))
        return x + self.bn2(self.conv2(h), train)

    def fold(self):
        """(k1, scale1, shift1, k2, scale2, shift2) of the eval-mode block,
        kernels HWIO: one ``rb_params`` entry of the fused tail."""
        return (hwio(self.conv1), *self.bn1.fold(), hwio(self.conv2),
                *self.bn2.fold())


class CANet(nn.Module):
    """Conditioning augmentation: sentence embedding -> (c, mu, logvar),
    with ``c = mu + exp(logvar / 2) * eps``."""

    def __init__(self, nef: int, condition_dim: int):
        super().__init__()
        self.condition_dim = condition_dim
        self.fc = nn.Linear(nef, 4 * condition_dim)

    def forward(self, sent_emb: torch.Tensor, eps: torch.Tensor):
        x = glu(self.fc(sent_emb), dim=-1)
        mu, logvar = x[:, :self.condition_dim], x[:, self.condition_dim:]
        return mu + torch.exp(0.5 * logvar) * eps, mu, logvar


class InitStageG(nn.Module):
    """[c, z] -> [B, ngf/16, 64, 64] seed feature map."""

    def __init__(self, ngf: int, in_dim: int, upblock: str = "dilated"):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Linear(in_dim, ngf * 4 * 4 * 2, bias=False)
        self.bn = BatchNorm(ngf * 4 * 4 * 2)
        self.upsample = nn.ModuleList(
            UpBlock(ngf // 2 ** i, ngf // 2 ** (i + 1), upblock)
            for i in range(4))

    def forward(self, z_code: torch.Tensor, c_code: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = glu(self.bn(self.fc(torch.cat([c_code, z_code], dim=-1)), train),
                dim=-1)
        # Channel-major, as torch's view(B, ngf, 4, 4): already NCHW.
        x = x.reshape(x.shape[0], self.ngf, 4, 4)
        x = x.contiguous(memory_format=torch.channels_last)
        for up in self.upsample:
            x = up(x, train)
        return x


class NextStageG(nn.Module):
    """Dynamic-memory refinement stage: memory write, memory read, response
    gate, ``num_residual`` ResBlocks and a 2x UpBlock.  Sub-module names
    follow the JAX module (``A``, ``B``, ``M_w``, ``M_r``, ``key``,
    ``value``, ``response_gate``).  With ``fused_tail`` the eval-mode
    tail runs as the fused tail kernel.  Under a profiler each forward is
    the span ``t2igan.g.stage``."""

    def __init__(self, ngf: int, nef: int, num_residual: int = 2,
                 upblock: str = "dilated", fused_tail: bool = False):
        super().__init__()
        self.fused_tail = fused_tail
        self._tail_key, self._tail_ops = None, None  # see _tail_operands
        self.A = nn.Linear(nef, 1, bias=False)
        self.B = nn.Linear(ngf, 1, bias=False)
        self.M_w = nn.Linear(nef, 2 * ngf)
        self.M_r = nn.Linear(ngf, 2 * ngf)
        self.key = nn.Linear(2 * ngf, ngf)
        self.value = nn.Linear(2 * ngf, ngf)
        self.response_gate = nn.Conv2d(2 * ngf, 1, 1)
        self.residual = nn.ModuleList(ResBlock(2 * ngf)
                                      for _ in range(num_residual))
        self.upsample = UpBlock(2 * ngf, ngf, upblock)

    def forward(self, h_code: torch.Tensor, word_embs: torch.Tensor,
                pad_mask: Optional[torch.Tensor], return_attn: bool = True,
                train: bool = False,
                rgb_kernel: Optional[torch.Tensor] = None):
        """h_code [B, ngf, H, W]; word_embs [B, L, nef]; pad_mask [B, L]
        bool, True at padding.  Returns (h [B, ngf, 2H, 2W], attn
        [B, H, W, L] or None).  With ``rgb_kernel`` (the last stage's
        head, HWIO; fused eval tail only) the first output is the RGB
        image [B, 3, 2H, 2W] in [-1, 1] instead, and the 2x feature map is
        never returned."""
        with span("t2igan.g.stage"):
            h_code = h_code.contiguous(memory_format=torch.channels_last)
            # Memory writing: a per-word gate between word and image features.
            # The pooled state passes no gradient, as in the JAX package.
            h_avg = h_code.mean(dim=(2, 3)).detach()                 # [B, ngf]
            gate = torch.sigmoid(self.A(word_embs) + self.B(h_avg)[:, None, :])
            m_w = F.relu(self.M_w(word_embs))                    # [B, L, 2ngf]
            m_r = F.relu(self.M_r(h_avg))                           # [B, 2ngf]
            memory = m_w * gate + m_r[:, None, :] * (1.0 - gate)
            # Key addressing and value reading.
            key = F.relu(self.key(memory))
            value = F.relu(self.value(memory))
            read, attn = memory_read(h_code.permute(0, 2, 3, 1), key, value,
                                     pad_mask, return_attn=return_attn)
            mem_out = read.permute(0, 3, 1, 2)
            # Key response: a per-pixel gate over [h, read].
            gate_r = torch.sigmoid(self.response_gate(
                torch.cat([h_code, mem_out], dim=1)))
            h_new = h_code * (1.0 - gate_r) + gate_r * mem_out
            h_new = torch.cat([h_new, h_new], dim=1)
            if self.fused_tail and not train:
                return self._fused_tail(h_new, rgb_kernel), attn
            if rgb_kernel is not None:
                raise ValueError("rgb_kernel is taken by the fused eval tail "
                                 "only")
            for block in self.residual:
                h_new = block(h_new, train)
            return self.upsample(h_new, train), attn

    def _fused_tail(self, h_new: torch.Tensor,
                    rgb_kernel: Optional[torch.Tensor]) -> torch.Tensor:
        """ResBlocks, UpBlock (and the RGB head) in one fused-tail call on
        the NHWC view of the channels-last map; the result comes back as
        an NCHW view."""
        x = h_new.permute(0, 2, 3, 1)
        out = reschain.fused_tail(x, self._tail_operands(rgb_kernel, x.dtype),
                                  want_h=rgb_kernel is None)
        return out.permute(0, 3, 1, 2)

    def _tail_operands(self, rgb_kernel: Optional[torch.Tensor],
                       dtype: torch.dtype) -> reschain.TailOperands:
        """The tail's folded and laid-out weights, rebuilt only when one of
        its parameters or buffers (or the head's kernel) changed: keyed on
        each one's ``(data_ptr, _version)``, which ``load_state_dict``, the
        optimizer, EMA copies and ``.to()`` all move."""
        tensors = [*self.residual.parameters(), *self.residual.buffers(),
                   *self.upsample.parameters(), *self.upsample.buffers()]
        if rgb_kernel is not None:
            tensors.append(rgb_kernel)
        key = (dtype, rgb_kernel is not None,
               tuple((t.data_ptr(), t._version) for t in tensors))
        if self._tail_key != key:
            with torch.no_grad():
                self._tail_ops = reschain.lay_out_operands(
                    [b.fold() for b in self.residual], *self.upsample.fold(),
                    rgb_kernel, dtype)
            self._tail_key = key
        return self._tail_ops


class GetImageG(nn.Module):
    """Feature map -> RGB in [-1, 1]: conv3x3 -> 3, tanh."""

    def __init__(self, ngf: int):
        super().__init__()
        self.conv = conv3x3(ngf, 3)

    def forward(self, h_code: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv(h_code))

    def fold(self) -> torch.Tensor:
        """The head's kernel HWIO [3, 3, ngf, 3], for the fused tail."""
        return hwio(self.conv)


class GNet(nn.Module):
    """Cascaded generator.

    ``gf_dim`` = GAN.GF_DIM, ``nef`` = TEXT.EMBEDDING_DIM, ``condition_dim``
    = GAN.CONDITION_DIM, ``z_dim`` = GAN.Z_DIM, ``branch_num`` =
    TREE.BRANCH_NUM, ``num_residual`` = GAN.R_NUM, ``upblock`` =
    GAN.UPBLOCK, ``fused_tail`` = GAN.FUSED_TAIL (eval only: each stage
    tail, and the last stage's RGB head, through the fused tail kernel).
    """

    def __init__(self, gf_dim: int = 64, nef: int = 512,
                 condition_dim: int = 512, z_dim: int = 100,
                 branch_num: int = 3, num_residual: int = 2,
                 upblock: str = "dilated", fused_tail: bool = False):
        super().__init__()
        self.fused_tail = fused_tail
        self.ca_net = CANet(nef, condition_dim)
        self.init_stage = InitStageG(gf_dim * 16, condition_dim + z_dim,
                                     upblock)
        self.next_stages = nn.ModuleList(
            NextStageG(gf_dim, nef, num_residual, upblock, fused_tail)
            for _ in range(branch_num - 1))
        self.image_heads = nn.ModuleList(GetImageG(gf_dim)
                                         for _ in range(branch_num))

    def forward(self, z_code: torch.Tensor, sent_emb: torch.Tensor,
                word_embs: torch.Tensor, pad_mask: Optional[torch.Tensor],
                ca_eps: torch.Tensor, return_attn: bool = True,
                train: bool = False):
        """Returns (fake_imgs, att_maps, mu, logvar): images [B, s, s, 3] in
        [-1, 1] for each pyramid size, attention maps [B, H, W, L] of each
        refinement stage (empty with ``return_attn=False``).  Inputs are
        cast to the generator's dtype.  ``train=True`` normalises with
        batch statistics and updates the running ones."""
        dtype = self.ca_net.fc.weight.dtype
        c_code, mu, logvar = self.ca_net(sent_emb.to(dtype), ca_eps.to(dtype))
        h_code = self.init_stage(z_code.to(dtype), c_code, train)
        words = word_embs.to(dtype)
        fake_imgs = [self.image_heads[0](h_code)]
        att_maps = []
        last = len(self.next_stages) - 1
        for i, (stage, head) in enumerate(zip(self.next_stages,
                                              self.image_heads[1:])):
            if i == last and self.fused_tail and not train:
                # The head folds into the last fused tail: its 2x feature
                # map's only consumer is this head.
                img, attn = stage(h_code, words, pad_mask, return_attn,
                                  train, rgb_kernel=head.fold())
                fake_imgs.append(img)
            else:
                h_code, attn = stage(h_code, words, pad_mask, return_attn,
                                     train)
                fake_imgs.append(head(h_code))
            if attn is not None:
                att_maps.append(attn)
        return ([img.permute(0, 2, 3, 1) for img in fake_imgs], att_maps,
                mu, logvar)


class GDCGan(nn.Module):
    """Single-output generator (``GAN.B_DCGAN``, the reference's
    ``G_DCGAN``): :class:`GNet`'s stages with one RGB head, on the last
    stage's map.  The same arguments as :class:`GNet`; with ``fused_tail``
    in eval the earlier stages' tails run through the fused tail kernel
    and the last one folds the head in, as in the JAX ``GDCGan``.
    ``forward`` returns ``([image [B, s, s, 3]], att_maps, mu, logvar)``,
    ``s`` the finest size."""

    def __init__(self, gf_dim: int = 64, nef: int = 512,
                 condition_dim: int = 512, z_dim: int = 100,
                 branch_num: int = 3, num_residual: int = 2,
                 upblock: str = "dilated", fused_tail: bool = False):
        super().__init__()
        self.fused_tail = fused_tail
        self.ca_net = CANet(nef, condition_dim)
        self.init_stage = InitStageG(gf_dim * 16, condition_dim + z_dim,
                                     upblock)
        self.next_stages = nn.ModuleList(
            NextStageG(gf_dim, nef, num_residual, upblock, fused_tail)
            for _ in range(branch_num - 1))
        self.image_head = GetImageG(gf_dim)

    def forward(self, z_code: torch.Tensor, sent_emb: torch.Tensor,
                word_embs: torch.Tensor, pad_mask: Optional[torch.Tensor],
                ca_eps: torch.Tensor, return_attn: bool = True,
                train: bool = False):
        dtype = self.ca_net.fc.weight.dtype
        c_code, mu, logvar = self.ca_net(sent_emb.to(dtype), ca_eps.to(dtype))
        h_code = self.init_stage(z_code.to(dtype), c_code, train)
        words = word_embs.to(dtype)
        att_maps, img = [], None
        last = len(self.next_stages) - 1
        for i, stage in enumerate(self.next_stages):
            if i == last and self.fused_tail and not train:
                img, attn = stage(h_code, words, pad_mask, return_attn,
                                  train, rgb_kernel=self.image_head.fold())
            else:
                h_code, attn = stage(h_code, words, pad_mask, return_attn,
                                     train)
            if attn is not None:
                att_maps.append(attn)
        if img is None:
            img = self.image_head(h_code)
        return [img.permute(0, 2, 3, 1)], att_maps, mu, logvar


@torch.no_grad()
def init_generator_(model: nn.Module,
                    generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, with the JAX package's
    initializer families: orthogonal kernels, zero biases, BN scale
    N(1, 0.02), running mean 0 and variance 1."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            nn.init.normal_(module.weight, 1.0, 0.02, generator=generator)
            nn.init.zeros_(module.bias)
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        elif isinstance(module, (nn.Linear, nn.Conv2d)):
            nn.init.orthogonal_(module.weight, generator=generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
    return model
