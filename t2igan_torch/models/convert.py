"""Weight bridge: the JAX package's variables -> the port's modules.

The loaders take the JAX variable trees as nested dicts of numpy arrays,
as ``jax.tree.map(np.asarray, variables)`` gives them, and fill the port's
modules in place:

* Dense kernel [in, out] -> Linear weight [out, in];
* Conv kernel [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw];
* CLIP's fused ``qkv_proj`` kernel [d, 3, d] / bias [3, d] -> the fused
  Linear(d, 3d) with q, k and v stacked on its output rows;
* BatchNorm params ``scale``/``bias`` and batch_stats ``mean``/``var`` ->
  weight/bias/running_mean/running_var;
* spectral-norm conv kernels like conv kernels, and the ``spectral``
  collection's ``u``/``v`` -> the ``SNConv`` buffers (``v`` keeps the JAX
  (kh, kw, in) order);
* Inception's fused 1x1 convs (``fused1x1``: one conv and BN over the
  concatenated output channels of a block's same-input 1x1 branches) ->
  the per-branch ``BasicConv2d`` modules, split along the output channels.

A missing or mis-shaped variable raises, and so does a variable that no
module took (beyond the vision side for :func:`load_jax_clip_text`): that
is a config mismatch, such as another branch count.

The tests compare the port's state after a step with the JAX package's by
loading the JAX result into a second port module with these loaders and
comparing the two ``state_dict``s; there is no port -> JAX direction.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from t2igan_torch.models.clip import (ClipWithRegionHead, EncoderLayer,
                                      TextTower, VisionTower)
from t2igan_torch.models.discriminator import DGetLogits, DNetWithHeads
from t2igan_torch.models.inception import BasicConv2d, InceptionV3
from t2igan_torch.models.generator import (BatchNorm, CANet, GetImageG, GNet,
                                           InitStageG, NextStageG, ResBlock,
                                           UpBlock)
from t2igan_torch.ops.spectral import SNConv

Path = Tuple[str, ...]

# Top-level CLIP params of the vision side, which load_jax_clip_text skips.
_CLIP_VISION_KEYS = ("vision_model", "visual_projection", "linear_subr",
                     "logit_scale")


def _leaves(tree: Mapping[str, Any], prefix: Path = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


class _Loader:
    """Reads variables by path, checks shapes, and records what was read."""

    def __init__(self, tree: Mapping[str, Any]):
        self.tree = tree
        self.used = set()

    def get(self, path: Path) -> np.ndarray:
        node = self.tree
        for k in path:
            if not isinstance(node, Mapping) or k not in node:
                raise KeyError(f"missing JAX variable {'/'.join(path)}")
            node = node[k]
        self.used.add(path)
        return np.asarray(node, dtype=np.float32)

    def copy(self, dst: torch.Tensor, arr: np.ndarray, path: Path) -> None:
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"JAX variable {'/'.join(path)} has shape "
                             f"{tuple(arr.shape)}, the port expects "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.tensor(arr))

    def dense(self, lin: nn.Linear, path: Path) -> None:
        kernel = self.get(path + ("kernel",))
        self.copy(lin.weight, kernel.T, path + ("kernel",))
        if lin.bias is not None:
            self.copy(lin.bias, self.get(path + ("bias",)), path + ("bias",))

    def conv(self, conv: nn.Conv2d, path: Path) -> None:
        kernel = self.get(path + ("kernel",))
        if kernel.ndim != 4:
            raise ValueError(f"JAX variable {'/'.join(path)}/kernel has "
                             f"shape {kernel.shape}, expected a conv kernel")
        self.copy(conv.weight, kernel.transpose(3, 2, 0, 1),
                  path + ("kernel",))
        if conv.bias is not None:
            self.copy(conv.bias, self.get(path + ("bias",)), path + ("bias",))

    def layer_norm(self, ln: nn.LayerNorm, path: Path) -> None:
        self.copy(ln.weight, self.get(path + ("scale",)), path + ("scale",))
        self.copy(ln.bias, self.get(path + ("bias",)), path + ("bias",))

    def batch_norm(self, bn: BatchNorm, path: Path) -> None:
        # The JAX BatchNorm wraps flax's nn.BatchNorm as its child BatchNorm_0.
        p = ("params",) + path + ("BatchNorm_0",)
        s = ("batch_stats",) + path + ("BatchNorm_0",)
        for dst, src in ((bn.weight, p + ("scale",)), (bn.bias, p + ("bias",)),
                         (bn.running_mean, s + ("mean",)),
                         (bn.running_var, s + ("var",))):
            self.copy(dst, self.get(src), src)

    def sn_conv(self, conv: SNConv, path: Path) -> None:
        """``path`` below the collection: params/<path>/{kernel, bias} and
        spectral/<path>/{u, v}."""
        self.conv(conv, ("params",) + path)
        s = ("spectral",) + path
        self.copy(conv.u, self.get(s + ("u",)), s + ("u",))
        self.copy(conv.v, self.get(s + ("v",)), s + ("v",))

    def check_all_used(self, ignore: Tuple[str, ...] = ()) -> None:
        unused = [p for p in _leaves(self.tree)
                  if p not in self.used and p[0] not in ignore]
        if unused:
            raise ValueError("JAX variables that no module of the port takes "
                             "(config mismatch?): "
                             + ", ".join("/".join(p) for p in unused[:8]))


def _up_block(ld: _Loader, m: UpBlock, path: Path) -> None:
    ld.conv(m.conv, ("params",) + path + ("Conv_0",))
    ld.batch_norm(m.bn, path + ("BatchNorm_0",))


def _res_block(ld: _Loader, m: ResBlock, path: Path) -> None:
    ld.conv(m.conv1, ("params",) + path + ("Conv_0",))
    ld.batch_norm(m.bn1, path + ("BatchNorm_0",))
    ld.conv(m.conv2, ("params",) + path + ("Conv_1",))
    ld.batch_norm(m.bn2, path + ("BatchNorm_1",))


def _ca_net(ld: _Loader, m: CANet, path: Path) -> None:
    ld.dense(m.fc, ("params",) + path + ("Dense_0",))


def _init_stage(ld: _Loader, m: InitStageG, path: Path) -> None:
    ld.dense(m.fc, ("params",) + path + ("Dense_0",))
    ld.batch_norm(m.bn, path + ("BatchNorm_0",))
    for i, up in enumerate(m.upsample):
        _up_block(ld, up, path + (f"UpBlock_{i}",))


def _next_stage(ld: _Loader, m: NextStageG, path: Path) -> None:
    p = ("params",) + path
    for name in ("A", "B", "M_w", "M_r", "key", "value"):
        ld.dense(getattr(m, name), p + (name,))
    ld.conv(m.response_gate, p + ("response_gate",))
    for j, block in enumerate(m.residual):
        _res_block(ld, block, path + (f"ResBlock_{j}",))
    _up_block(ld, m.upsample, path + ("UpBlock_0",))


def _image_head(ld: _Loader, m: GetImageG, path: Path) -> None:
    ld.conv(m.conv, ("params",) + path + ("Conv_0",))


def _gnet(ld: _Loader, m: GNet, path: Path) -> None:
    _ca_net(ld, m.ca_net, path + ("CANet_0",))
    _init_stage(ld, m.init_stage, path + ("InitStageG_0",))
    for i, stage in enumerate(m.next_stages):
        _next_stage(ld, stage, path + (f"NextStageG_{i}",))
    for i, head in enumerate(m.image_heads):
        _image_head(ld, head, path + (f"GetImageG_{i}",))


_GENERATOR_LOADERS = {GNet: _gnet, CANet: _ca_net, InitStageG: _init_stage,
                      NextStageG: _next_stage, UpBlock: _up_block,
                      ResBlock: _res_block, GetImageG: _image_head}


@torch.no_grad()
def load_jax_generator(module: nn.Module, variables: Mapping[str, Any]):
    """Fill ``module`` from the variables ``{"params": ...,
    "batch_stats": ...}`` of its JAX counterpart: a ``GNet``, or one of its
    parts (``CANet``, ``InitStageG``, ``NextStageG``, ``UpBlock``,
    ``ResBlock``, ``GetImageG``) initialised on its own."""
    loader = _GENERATOR_LOADERS.get(type(module))
    if loader is None:
        raise TypeError(f"no JAX generator counterpart for "
                        f"{type(module).__name__}")
    ld = _Loader(variables)
    loader(ld, module, ())
    ld.check_all_used()
    return module


def _encoder_layer(ld: _Loader, m: EncoderLayer, path: Path) -> None:
    ld.layer_norm(m.layer_norm1, path + ("layer_norm1",))
    ld.layer_norm(m.layer_norm2, path + ("layer_norm2",))
    qkv = path + ("self_attn", "qkv_proj")
    kernel = ld.get(qkv + ("kernel",))                  # [d, 3, d]
    d = m.self_attn.qkv_proj.in_features
    if kernel.shape != (d, 3, d):
        raise ValueError(f"JAX variable {'/'.join(qkv)}/kernel has shape "
                         f"{kernel.shape}, the port expects {(d, 3, d)}")
    ld.copy(m.self_attn.qkv_proj.weight, kernel.reshape(d, 3 * d).T,
            qkv + ("kernel",))
    ld.copy(m.self_attn.qkv_proj.bias,
            ld.get(qkv + ("bias",)).reshape(-1), qkv + ("bias",))
    ld.dense(m.self_attn.out_proj, path + ("self_attn", "out_proj"))
    ld.dense(m.fc1, path + ("fc1",))
    ld.dense(m.fc2, path + ("fc2",))


def _text_tower(ld: _Loader, text: TextTower) -> None:
    p = ("text_model",)
    ld.copy(text.token_embedding.weight,
            ld.get(p + ("token_embedding", "embedding")),
            p + ("token_embedding", "embedding"))
    ld.copy(text.position_embedding, ld.get(p + ("position_embedding",)),
            p + ("position_embedding",))
    for i, layer in enumerate(text.layers):
        _encoder_layer(ld, layer, p + (f"layers_{i}",))
    ld.layer_norm(text.final_layer_norm, p + ("final_layer_norm",))


def _vision_tower(ld: _Loader, vision: VisionTower) -> None:
    p = ("vision_model",)
    for dst, name in ((vision.patch_embedding.kernel,
                       ("patch_embedding", "kernel")),
                      (vision.class_embedding, ("class_embedding",)),
                      (vision.position_embedding, ("position_embedding",))):
        ld.copy(dst, ld.get(p + name), p + name)
    ld.layer_norm(vision.pre_layrnorm, p + ("pre_layrnorm",))
    for i, layer in enumerate(vision.layers):
        _encoder_layer(ld, layer, p + (f"layers_{i}",))
    ld.layer_norm(vision.post_layernorm, p + ("post_layernorm",))


@torch.no_grad()
def load_jax_clip_text(module: ClipWithRegionHead,
                       params: Mapping[str, Any]) -> ClipWithRegionHead:
    """Fill the text side of ``module`` (text tower and projection) from
    the JAX ``ClipWithRegionHead`` params tree (the ``"params"``
    collection).  Vision-side entries are ignored."""
    ld = _Loader(params)
    _text_tower(ld, module.text_model)
    ld.dense(module.text_projection, ("text_projection",))
    ld.check_all_used(ignore=_CLIP_VISION_KEYS)
    return module


@torch.no_grad()
def load_jax_clip(module: ClipWithRegionHead,
                  params: Mapping[str, Any]) -> ClipWithRegionHead:
    """Fill all of ``module`` (both towers, both projections,
    ``linear_subr`` and ``logit_scale``) from the JAX
    ``ClipWithRegionHead`` params tree; every entry must be taken."""
    ld = _Loader(params)
    _text_tower(ld, module.text_model)
    _vision_tower(ld, module.vision_model)
    ld.dense(module.text_projection, ("text_projection",))
    ld.dense(module.visual_projection, ("visual_projection",))
    ld.dense(module.linear_subr, ("linear_subr",))
    ld.copy(module.logit_scale, ld.get(("logit_scale",)), ("logit_scale",))
    ld.check_all_used()
    return module


def _d_head(ld: _Loader, head: DGetLogits, path: Path) -> None:
    if head.joint is not None:
        ld.sn_conv(head.joint.conv, path + ("Block3x3Leaky_0", "SNConv_0"))
    ld.conv(head.conv, ("params",) + path + ("Conv_0",))


@torch.no_grad()
def load_jax_discriminator(module: DNetWithHeads,
                           variables: Mapping[str, Any]) -> DNetWithHeads:
    """Fill ``module`` from the variables ``{"params": ..., "spectral":
    ...}`` of the JAX ``DNetWithHeads`` of the same size; every entry must
    be taken."""
    ld = _Loader(variables)
    trunk = module.trunk
    for i, block in enumerate(trunk.encode.blocks):
        ld.sn_conv(block.conv, ("trunk", "Encode16x_0", f"DownBlock_{i}",
                                "SNConv_0"))
    for i, block in enumerate(trunk.down):
        ld.sn_conv(block.conv, ("trunk", f"DownBlock_{i}", "SNConv_0"))
    for i, block in enumerate(trunk.blocks):
        ld.sn_conv(block.conv, ("trunk", f"Block3x3Leaky_{i}", "SNConv_0"))
    _d_head(ld, module.cond_head, ("cond_head",))
    if module.uncond_head is not None:
        _d_head(ld, module.uncond_head, ("uncond_head",))
    ld.check_all_used()
    return module


# The same-input 1x1 branches that each JAX Inception block runs as one
# ``fused1x1`` conv, in the order of its output channels.
_FUSED_1X1 = {
    **{m: ("branch1x1", "branch5x5_1", "branch3x3dbl_1")
       for m in ("Mixed_5b", "Mixed_5c", "Mixed_5d")},
    **{m: ("branch1x1", "branch7x7_1", "branch7x7dbl_1")
       for m in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e")},
    "Mixed_7a": ("branch3x3_1", "branch7x7x3_1"),
    **{m: ("branch1x1", "branch3x3_1", "branch3x3dbl_1")
       for m in ("Mixed_7b", "Mixed_7c")},
}


def _basic_conv(ld: _Loader, m: BasicConv2d, path: Path,
                channels: slice = slice(None)) -> None:
    """conv and BN of one ``BasicConv2d`` from ``path`` (flax's plain
    ``nn.BatchNorm`` named ``bn``), taking the output ``channels`` of a
    fused conv."""
    p, s = ("params",) + path, ("batch_stats",) + path
    kernel = ld.get(p + ("conv", "kernel"))[..., channels]
    ld.copy(m.conv.weight, kernel.transpose(3, 2, 0, 1), p + ("conv", "kernel"))
    for dst, src in ((m.bn.weight, p + ("bn", "scale")),
                     (m.bn.bias, p + ("bn", "bias")),
                     (m.bn.running_mean, s + ("bn", "mean")),
                     (m.bn.running_var, s + ("bn", "var"))):
        ld.copy(dst, ld.get(src)[channels], src)


@torch.no_grad()
def load_jax_inception(module: InceptionV3,
                       variables: Mapping[str, Any]) -> InceptionV3:
    """Fill ``module`` from the variables ``{"params": ..., "batch_stats":
    ...}`` of the JAX ``InceptionV3`` of the same variant; each
    ``fused1x1`` is split into its branches in ``_FUSED_1X1`` order and
    widths, and every entry must be taken."""
    ld = _Loader(variables)
    for name, child in module.named_children():
        if isinstance(child, BasicConv2d):
            _basic_conv(ld, child, (name,))
        elif isinstance(child, nn.Linear):
            ld.dense(child, ("params", name))
        else:
            fused = _FUSED_1X1.get(name, ())
            start = 0
            for branch in fused:
                m = getattr(child, branch)
                width = m.conv.out_channels
                _basic_conv(ld, m, (name, "fused1x1"),
                            slice(start, start + width))
                start += width
            if fused:
                total = ld.get(("params", name, "fused1x1", "conv",
                                "kernel")).shape[-1]
                if total != start:
                    raise ValueError(f"JAX variable {name}/fused1x1 has "
                                     f"{total} output channels, the port's "
                                     f"branches {fused} take {start}")
            for branch, m in child.named_children():
                if branch not in fused:
                    _basic_conv(ld, m, (name, branch))
    ld.check_all_used()
    return module
