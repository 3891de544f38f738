"""Weight bridge: the JAX package's variables -> the port's modules.

Both loaders take the JAX variable trees as nested dicts of numpy arrays,
as ``jax.tree.map(np.asarray, variables)`` gives them, and fill the port's
modules in place:

* Dense kernel [in, out] -> Linear weight [out, in];
* Conv kernel [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw];
* CLIP's fused ``qkv_proj`` kernel [d, 3, d] / bias [3, d] -> the fused
  Linear(d, 3d) with q, k and v stacked on its output rows;
* BatchNorm params ``scale``/``bias`` and batch_stats ``mean``/``var`` ->
  weight/bias/running_mean/running_var.

A missing or mis-shaped variable raises, and so does a variable of the
generator (or of the CLIP text side) that no module took: that is a config
mismatch, such as another branch count.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from t2igan_torch.models.clip import ClipWithRegionHead, EncoderLayer
from t2igan_torch.models.generator import (BatchNorm, CANet, GetImageG, GNet,
                                           InitStageG, NextStageG, ResBlock,
                                           UpBlock)

Path = Tuple[str, ...]

# Top-level CLIP params of the vision side, which the port does not hold yet.
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


@torch.no_grad()
def load_jax_clip_text(module: ClipWithRegionHead,
                       params: Mapping[str, Any]) -> ClipWithRegionHead:
    """Fill ``module`` from the JAX ``ClipWithRegionHead`` params tree (the
    ``"params"`` collection).  Vision-side entries are ignored."""
    ld = _Loader(params)
    text = module.text_model
    ld.copy(text.token_embedding.weight,
            ld.get(("text_model", "token_embedding", "embedding")),
            ("text_model", "token_embedding", "embedding"))
    ld.copy(text.position_embedding,
            ld.get(("text_model", "position_embedding")),
            ("text_model", "position_embedding"))
    for i, layer in enumerate(text.layers):
        _encoder_layer(ld, layer, ("text_model", f"layers_{i}"))
    ld.layer_norm(text.final_layer_norm, ("text_model", "final_layer_norm"))
    ld.dense(module.text_projection, ("text_projection",))
    ld.check_all_used(ignore=_CLIP_VISION_KEYS)
    return module
