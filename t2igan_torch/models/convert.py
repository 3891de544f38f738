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
comparing the two ``state_dict``s.

CLIP also crosses under the reference's own names, the ``clip%d.pth``
files that DAMSM fine-tuning writes and GAN training reads
(:func:`clip_reference_state_dict`, :func:`load_reference_clip_state`,
:func:`save_clip_pth`, :func:`load_clip_pth`): HF ``CLIPModel`` keys plus
``linear_subr.*`` and ``logit_scale``, the keys that the JAX package's
``convert_torch_clip_state`` reads.  So do the generator and the
discriminators, as ``netG_epoch_%d.pth`` and ``netD%d.pth``
(:func:`generator_reference_state_dict`,
:func:`discriminator_reference_state_dict`, their loaders and the
``save_*_pth``/``load_*_pth`` pairs), under the names that the JAX
package's ``convert_torch_generator_state`` and
``convert_torch_discriminator_state`` read (the generator as a ``G_NET``,
or a ``G_DCGAN`` for a ``GDCGan``); and the generator goes back to a JAX
variable tree (:func:`jax_generator_variables`) for the ``.npz`` export.
The legacy encoders load from the JAX package's variables
(:func:`load_jax_rnn_encoder`, :func:`load_jax_cnn_encoder`,
:func:`load_jax_global_attention_text`).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from t2igan_torch.models.clip import (ClipWithRegionHead, EncoderLayer,
                                      TextTower, VisionTower)
from t2igan_torch.models.discriminator import DGetLogits, DNetWithHeads
from t2igan_torch.models.inception import BasicConv2d, InceptionV3
from t2igan_torch.models.legacy import (CnnEncoder, GlobalAttentionText,
                                        RnnEncoder)
from t2igan_torch.models.generator import (BatchNorm, CANet, GDCGan,
                                           GetImageG, GNet, InitStageG,
                                           NextStageG, ResBlock, UpBlock)
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


def _stages(ld: _Loader, m, path: Path) -> None:
    _ca_net(ld, m.ca_net, path + ("CANet_0",))
    _init_stage(ld, m.init_stage, path + ("InitStageG_0",))
    for i, stage in enumerate(m.next_stages):
        _next_stage(ld, stage, path + (f"NextStageG_{i}",))


def _gnet(ld: _Loader, m: GNet, path: Path) -> None:
    _stages(ld, m, path)
    for i, head in enumerate(m.image_heads):
        _image_head(ld, head, path + (f"GetImageG_{i}",))


def _gdcgan(ld: _Loader, m: GDCGan, path: Path) -> None:
    """The JAX ``GDCGan``: ``GNet``'s names with the one head
    ``GetImageG_0``."""
    _stages(ld, m, path)
    _image_head(ld, m.image_head, path + ("GetImageG_0",))


_GENERATOR_LOADERS = {GNet: _gnet, GDCGan: _gdcgan, CANet: _ca_net,
                      InitStageG: _init_stage, NextStageG: _next_stage,
                      UpBlock: _up_block, ResBlock: _res_block,
                      GetImageG: _image_head}


def _check_heads(module: nn.Module, n_heads: int, what: str) -> None:
    """Raise, naming ``GAN.B_DCGAN``, when a file's count of RGB heads
    says it holds the other generator class (one head: ``G_DCGAN``, one a
    branch: ``G_NET``; with one branch the two are the same)."""
    if isinstance(module, GDCGan) and n_heads > 1:
        raise ValueError(f"{what} holds a G_NET ({n_heads} RGB heads) but "
                         f"the generator is GDCGan: set GAN.B_DCGAN: False")
    if isinstance(module, GNet) and n_heads == 1 and \
            len(module.image_heads) > 1:
        raise ValueError(f"{what} holds a G_DCGAN (one RGB head) but the "
                         f"generator is GNet with {len(module.image_heads)} "
                         f"branches: set GAN.B_DCGAN: True")


@torch.no_grad()
def load_jax_generator(module: nn.Module, variables: Mapping[str, Any]):
    """Fill ``module`` from the variables ``{"params": ...,
    "batch_stats": ...}`` of its JAX counterpart: a ``GNet`` or a
    ``GDCGan``, or one of their parts (``CANet``, ``InitStageG``,
    ``NextStageG``, ``UpBlock``, ``ResBlock``, ``GetImageG``) initialised
    on its own.  A ``GNet`` tree into a ``GDCGan``, or the reverse, raises
    naming ``GAN.B_DCGAN``."""
    loader = _GENERATOR_LOADERS.get(type(module))
    if loader is None:
        raise TypeError(f"no JAX generator counterpart for "
                        f"{type(module).__name__}")
    _check_heads(module, sum(k.startswith("GetImageG_")
                             for k in variables.get("params", {})),
                 "the JAX variable tree")
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


# ---------------------------------------------------------------------------
# The legacy encoders (models/legacy.py)
# ---------------------------------------------------------------------------

@torch.no_grad()
def load_jax_rnn_encoder(module: RnnEncoder,
                         variables: Mapping[str, Any]) -> RnnEncoder:
    """Fill ``module`` from the variables ``{"params": ...}`` of the JAX
    ``RnnEncoder`` of the same ``rnn_type``: the inverse of the JAX
    package's ``convert_torch_rnn_encoder_state``.  Each direction's cell
    (``*Cell_0`` forward, ``*Cell_1`` the ``_reverse`` weights) has a dense
    layer per gate; torch stacks the gates on the rows, LSTM (i, f, g, o)
    and GRU (r, z, n).  LSTM: the ``h*`` biases (which carry b_ih + b_hh)
    become ``bias_ih`` and ``bias_hh`` is 0.  GRU: the ``i{r,z}`` biases
    (b_ih + b_hh) and ``in``'s become ``bias_ih``; ``bias_hh`` is 0 but for
    its n rows, ``hn``'s bias, the one pre-activation where torch keeps
    the two apart (``r`` multiplies only the hidden side)."""
    ld = _Loader(variables)
    ld.copy(module.encoder.weight,
            ld.get(("params", "Embed_0", "embedding")),
            ("params", "Embed_0", "embedding"))
    lstm = module.rnn_type == "LSTM"
    cell, gates = ("OptimizedLSTMCell", "ifgo") if lstm else ("GRUCell",
                                                              "rzn")
    for d, suffix in enumerate(("", "_reverse")):
        p = ("params", f"{cell}_{d}")
        w_ih = np.concatenate([ld.get(p + (f"i{g}", "kernel")).T
                               for g in gates])
        w_hh = np.concatenate([ld.get(p + (f"h{g}", "kernel")).T
                               for g in gates])
        if lstm:
            b_ih = np.concatenate([ld.get(p + (f"h{g}", "bias"))
                                   for g in gates])
            b_hh = np.zeros_like(b_ih)
        else:
            b_ih = np.concatenate([ld.get(p + (f"i{g}", "bias"))
                                   for g in gates])
            b_hh = np.zeros_like(b_ih)
            hn = ld.get(p + ("hn", "bias"))
            b_hh[-len(hn):] = hn
        rnn = module.rnn
        for name, arr in (("weight_ih", w_ih), ("weight_hh", w_hh),
                          ("bias_ih", b_ih), ("bias_hh", b_hh)):
            ld.copy(getattr(rnn, f"{name}_l0{suffix}"), arr,
                    p + (name,))
    ld.check_all_used()
    return module


@torch.no_grad()
def load_jax_cnn_encoder(module: CnnEncoder,
                         variables: Mapping[str, Any]) -> CnnEncoder:
    """Fill ``module`` from the variables ``{"params": ...,
    "batch_stats": ...}`` of the JAX ``CnnEncoder``: its ``inception``
    subtree through :func:`load_jax_inception`, then the two heads."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    extra = (set(params) - {"inception", "emb_features", "emb_cnn_code"}) \
        | (set(stats) - {"inception"})
    if extra:
        raise ValueError(f"JAX variables that no module of the port takes: "
                         f"{sorted(extra)}")
    load_jax_inception(module.inception, {
        "params": params["inception"],
        "batch_stats": stats.get("inception", {})})
    ld = _Loader({"params": {k: params[k] for k in
                             ("emb_features", "emb_cnn_code")}})
    ld.conv(module.emb_features, ("params", "emb_features"))
    ld.dense(module.emb_cnn_code, ("params", "emb_cnn_code"))
    ld.check_all_used()
    return module


@torch.no_grad()
def load_jax_global_attention_text(module: GlobalAttentionText,
                                   variables: Mapping[str, Any]
                                   ) -> GlobalAttentionText:
    """Fill ``module`` from the JAX ``GlobalAttentionText``'s variables."""
    ld = _Loader(variables)
    ld.dense(module.conv_context, ("params", "conv_context"))
    ld.check_all_used()
    return module


# ---------------------------------------------------------------------------
# CLIP under the reference's (HF CLIPModel) names
# ---------------------------------------------------------------------------

# Port parameter name -> reference key, first match wins.  ``qkv_proj`` is
# split into q/k/v and the patch kernel changes layout (_to_reference).
_CLIP_RENAMES = (
    (r"^(text|vision)_model\.layers\.(\d+)\.(fc\d)\.",
     r"\1_model.encoder.layers.\2.mlp.\3."),
    (r"^(text|vision)_model\.layers\.", r"\1_model.encoder.layers."),
    (r"^text_model\.token_embedding\.weight$",
     "text_model.embeddings.token_embedding.weight"),
    (r"^(text|vision)_model\.position_embedding$",
     r"\1_model.embeddings.position_embedding.weight"),
    (r"^vision_model\.patch_embedding\.kernel$",
     "vision_model.embeddings.patch_embedding.weight"),
    (r"^vision_model\.class_embedding$",
     "vision_model.embeddings.class_embedding"),
)
_QKV = ("q_proj", "k_proj", "v_proj")
_CLIP_PREFIXES = ("module.", "backbone.")


def _reference_keys(name: str) -> List[str]:
    for pattern, repl in _CLIP_RENAMES:
        if re.search(pattern, name):
            name = re.sub(pattern, repl, name)
            break
    if ".qkv_proj." in name:
        return [name.replace("qkv_proj", q) for q in _QKV]
    return [name]


def _to_reference(name: str, t: torch.Tensor) -> List[torch.Tensor]:
    if ".qkv_proj." in name:
        return list(t.chunk(3, dim=0))      # q, k, v stacked on the rows
    if name == "vision_model.patch_embedding.kernel":
        return [t.permute(3, 2, 0, 1)]      # [p, p, C, D] -> OIHW
    return [t]


def _from_reference(name: str, ts: List[torch.Tensor]) -> torch.Tensor:
    if ".qkv_proj." in name:
        return torch.cat(ts, dim=0)
    if name == "vision_model.patch_embedding.kernel":
        return ts[0].permute(2, 3, 1, 0)    # OIHW -> [p, p, C, D]
    return ts[0]


def clip_reference_state_dict(module: ClipWithRegionHead
                              ) -> Dict[str, torch.Tensor]:
    """The weights of ``module`` as f32 CPU tensors under the reference's
    names: HF ``CLIPModel`` keys (``embeddings.*``, ``encoder.layers.*``
    with separate ``q_proj``/``k_proj``/``v_proj`` and ``mlp.fc1``/
    ``mlp.fc2``, an OIHW ``patch_embedding.weight``, ``pre_layrnorm``),
    ``linear_subr.*`` and ``logit_scale``."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in module.named_parameters():
        for key, t in zip(_reference_keys(name),
                          _to_reference(name, p.detach())):
            out[key] = t.to(device="cpu", dtype=torch.float32,
                            memory_format=torch.contiguous_format, copy=True)
    return out


@torch.no_grad()
def load_reference_clip_state(module: ClipWithRegionHead,
                              state_dict: Mapping[str, Any]
                              ) -> ClipWithRegionHead:
    """Fill ``module`` from a state dict under the reference's names (the
    inverse of :func:`clip_reference_state_dict`).  Keys may carry the
    ``module.`` and ``backbone.`` prefixes of the reference's DataParallel
    and ``AddLinearOnCLIP`` checkpoints.  A bare ``CLIPModel`` dict gets
    the JAX converter's fresh head: a ``linear_subr`` kernel drawn from
    ``numpy.random.default_rng(0)``, normal over sqrt(hidden), zero bias;
    and ``logit_scale`` log(1 / 0.07) when absent.  A missing or
    mis-shaped key raises, and so does a key that no parameter takes
    (HF's ``position_ids`` buffers aside)."""
    sd = {}
    for key, v in state_dict.items():
        while key.startswith(_CLIP_PREFIXES):
            key = key.split(".", 1)[1]
        sd[key] = (v.detach().to("cpu", torch.float32)
                   if isinstance(v, torch.Tensor)
                   else torch.as_tensor(np.asarray(v, dtype=np.float32)))
    if "linear_subr.weight" not in sd:
        hidden, region = (module.linear_subr.in_features,
                          module.linear_subr.out_features)
        kernel = (np.random.default_rng(0).standard_normal((hidden, region))
                  / np.sqrt(hidden)).astype(np.float32)
        sd["linear_subr.weight"] = torch.from_numpy(kernel.T.copy())
        sd["linear_subr.bias"] = torch.zeros(region)
    sd.setdefault("logit_scale", torch.tensor(math.log(1.0 / 0.07)))
    used = set()
    for name, p in module.named_parameters():
        keys = _reference_keys(name)
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"CLIP state dict has no {missing[0]!r} (for the "
                           f"port's {name})")
        t = _from_reference(name, [sd[k] for k in keys])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"CLIP state dict gives {name} the shape "
                             f"{tuple(t.shape)}, the port expects "
                             f"{tuple(p.shape)}")
        p.copy_(t)
        used.update(keys)
    unused = [k for k in sd if k not in used
              and not k.endswith("position_ids")]
    if unused:
        raise ValueError("CLIP state dict entries that no parameter of the "
                         "port takes (config mismatch?): "
                         + ", ".join(unused[:8]))
    return module


def save_clip_pth(module: ClipWithRegionHead, path: str) -> None:
    """``torch.save`` of :func:`clip_reference_state_dict` (a reference
    ``clip%d.pth``).  A module sharded over a model axis raises: the file
    is always whole (``t2igan_torch.parallel.tp.gather_clip`` first)."""
    if getattr(module, "tp_group", None) is not None:
        raise ValueError("this CLIP is sharded over a model axis; write "
                         "t2igan_torch.parallel.tp.gather_clip(module)")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(clip_reference_state_dict(module), path)


def load_clip_pth(module: ClipWithRegionHead,
                  path: str) -> ClipWithRegionHead:
    """Fill ``module`` from a ``clip%d.pth`` (the port's or the
    reference's), read with ``torch.load(weights_only=True)``."""
    return load_reference_clip_state(
        module, torch.load(path, map_location="cpu", weights_only=True))


# ---------------------------------------------------------------------------
# The generator as a JAX variable tree (port -> JAX, for the .npz export)
# ---------------------------------------------------------------------------

class _Writer:
    """The inverse of :class:`_Loader`: the same module walk, writing each
    tensor under its JAX path as an f32 numpy array."""

    def __init__(self):
        self.tree: Dict[str, Any] = {}

    def put(self, path: Path, t: torch.Tensor) -> None:
        node = self.tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.detach().to("cpu", torch.float32).numpy().copy()

    def dense(self, lin: nn.Linear, path: Path) -> None:
        self.put(path + ("kernel",), lin.weight.T)
        if lin.bias is not None:
            self.put(path + ("bias",), lin.bias)

    def conv(self, conv: nn.Conv2d, path: Path) -> None:
        self.put(path + ("kernel",), conv.weight.permute(2, 3, 1, 0))
        if conv.bias is not None:
            self.put(path + ("bias",), conv.bias)

    def batch_norm(self, bn: BatchNorm, path: Path) -> None:
        p = ("params",) + path + ("BatchNorm_0",)
        s = ("batch_stats",) + path + ("BatchNorm_0",)
        self.put(p + ("scale",), bn.weight)
        self.put(p + ("bias",), bn.bias)
        self.put(s + ("mean",), bn.running_mean)
        self.put(s + ("var",), bn.running_var)


@torch.no_grad()
def jax_generator_variables(module: Union[GNet, GDCGan],
                            stats_from: Union[GNet, GDCGan] = None
                            ) -> Dict[str, Any]:
    """``{"params": ..., "batch_stats": ...}`` of ``module`` as nested dicts
    of f32 numpy arrays under the JAX ``GNet``'s (or ``GDCGan``'s) names:
    the inverse of
    :func:`load_jax_generator`.  The batch statistics come from
    ``stats_from`` (default ``module``): the EMA generator is saved with
    the trained G's running statistics, as the JAX package does."""
    walk = _GENERATOR_LOADERS[type(module)]
    params = _Writer()
    walk(params, module, ())
    stats = _Writer()
    walk(stats, stats_from if stats_from is not None else module, ())
    return {"params": params.tree["params"],
            "batch_stats": stats.tree["batch_stats"]}


# ---------------------------------------------------------------------------
# The generator and the discriminators under the reference's torch names
# ---------------------------------------------------------------------------

def _stage(m) -> int:
    return int(m.group(1)) + 2


# Port name -> reference key, first match wins (the reference's G_NET,
# G_DCGAN and D_NET64/128/256; the name table of the JAX package's
# converters).
_BLOCK = {"conv1": 0, "bn1": 1, "conv2": 3, "bn2": 4}
_GENERATOR_RENAMES = (
    (r"^init_stage\.fc\.", lambda m: "h_net1.fc.0."),
    (r"^init_stage\.bn\.", lambda m: "h_net1.fc.1."),
    (r"^init_stage\.upsample\.(\d+)\.(conv|bn)\.",
     lambda m: f"h_net1.upsample{int(m.group(1)) + 1}."
               f"{1 if m.group(2) == 'conv' else 2}."),
    (r"^next_stages\.(\d+)\.(M_w|M_r|key|value)\.",
     lambda m: f"h_net{_stage(m)}.{m.group(2)}.0."),
    (r"^next_stages\.(\d+)\.response_gate\.",
     lambda m: f"h_net{_stage(m)}.response_gate.0."),
    (r"^next_stages\.(\d+)\.residual\.(\d+)\.(conv1|bn1|conv2|bn2)\.",
     lambda m: f"h_net{_stage(m)}.residual.{m.group(2)}.block."
               f"{_BLOCK[m.group(3)]}."),
    (r"^next_stages\.(\d+)\.upsample\.(conv|bn)\.",
     lambda m: f"h_net{_stage(m)}.upsample."
               f"{1 if m.group(2) == 'conv' else 2}."),
    (r"^next_stages\.(\d+)\.(A|B)\.", lambda m: f"h_net{_stage(m)}."
                                                f"{m.group(2)}."),
    (r"^image_heads\.(\d+)\.conv\.",
     lambda m: f"img_net{int(m.group(1)) + 1}.img.0."),
    (r"^image_head\.conv\.", lambda m: "img_net.img.0."),
    (r"^ca_net\.fc\.", lambda m: "ca_net.fc."),
)
# The memory projections are k=1 Conv1d in the reference: (out, in, 1).
_CONV1D = re.compile(r"^next_stages\.\d+\.(M_w|M_r|key|value)\.weight$")

_SN_BUFFERS = {"weight": "weight_bar", "bias": "bias", "u": "weight_u",
               "v": "weight_v"}


def _discriminator_sources(module: DNetWithHeads) -> Dict[str, str]:
    """Port SN conv / head conv prefix -> the reference's module path."""
    down = ("img_code_s32", "img_code_s64")
    blocks = (("img_code_s32_1",) if module.img_size == 128
              else ("img_code_s64_1", "img_code_s64_2"))
    src = {f"trunk.encode.blocks.{i}.conv": f"img_code_s16.{2 * i}.module"
           for i in range(len(module.trunk.encode.blocks))}
    src.update({f"trunk.down.{i}.conv": f"{down[i]}.0.module"
                for i in range(len(module.trunk.down))})
    src.update({f"trunk.blocks.{i}.conv": f"{blocks[i]}.0.module"
                for i in range(len(module.trunk.blocks))})
    src["cond_head.joint.conv"] = "COND_DNET.jointConv.0.module"
    src["cond_head.conv"] = "COND_DNET.outlogits.0"
    src["uncond_head.conv"] = "UNCOND_DNET.outlogits.0"
    return src


def _reference_key(name: str, module: nn.Module) -> str:
    if isinstance(module, DNetWithHeads):
        prefix, leaf = name.rsplit(".", 1)
        src = _discriminator_sources(module)[prefix]
        return f"{src}.{_SN_BUFFERS[leaf] if src.endswith('module') else leaf}"
    for pattern, repl in _GENERATOR_RENAMES:
        if re.search(pattern, name):
            return re.sub(pattern, repl, name)
    raise KeyError(f"no reference name for the port's {name}")


def _sn_v_to_reference(v: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``v`` flattened in (kh, kw, in) order -> the reference's (in, kh,
    kw) order."""
    _, cin, kh, kw = weight.shape
    return v.reshape(kh, kw, cin).permute(2, 0, 1).reshape(-1)


def _sn_v_from_reference(v: torch.Tensor, weight: torch.Tensor
                         ) -> torch.Tensor:
    _, cin, kh, kw = weight.shape
    return v.reshape(cin, kh, kw).permute(1, 2, 0).reshape(-1)


def _cpu32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(device="cpu", dtype=torch.float32,
                         memory_format=torch.contiguous_format, copy=True)


@torch.no_grad()
def generator_reference_state_dict(module: Union[GNet, GDCGan],
                                   stats_from: Union[GNet, GDCGan] = None
                                   ) -> Dict[str, torch.Tensor]:
    """The weights of ``module`` as f32 CPU tensors under the reference's
    ``G_NET`` names (``netG_epoch_%d.pth``): ``ca_net.fc``,
    ``h_net1.fc.{0,1}``, ``h_net1.upsample{1..4}.{1,2}``,
    ``h_net<b>.{A,B,M_w.0,M_r.0,key.0,value.0,response_gate.0,
    residual.<i>.block.{0,1,3,4},upsample.{1,2}}`` and ``img_net<b>.img.0``
    (a ``GDCGan``: ``G_DCGAN``'s, the one head ``img_net.img.0``).
    Linears stay (out, in), the memory projections become k=1 Conv1d
    weights (out, in, 1), convs OIHW, BNs ``weight/bias/running_mean/
    running_var/num_batches_tracked`` (the last 0: the port does not count
    batches).  The running statistics come from ``stats_from`` (default
    ``module``): the EMA generator is saved with the trained G's."""
    stats = dict((stats_from if stats_from is not None else module)
                 .named_buffers())
    out: Dict[str, torch.Tensor] = {}
    for name, t in module.state_dict().items():
        key = _reference_key(name, module)
        t = stats.get(name, t)
        if _CONV1D.match(name):
            t = t[..., None]
        out[key] = _cpu32(t)
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return out


@torch.no_grad()
def discriminator_reference_state_dict(module: DNetWithHeads
                                       ) -> Dict[str, torch.Tensor]:
    """The weights and spectral vectors of ``module`` as f32 CPU tensors
    under the reference's ``D_NET{64,128,256}`` names (``netD%d.pth``):
    each SN conv as ``<src>.module.{weight_bar,bias,weight_u,weight_v}``
    (``weight_v`` in the reference's (in, kh, kw) order), the heads'
    plain convs as ``{COND,UNCOND}_DNET.outlogits.0.{weight,bias}``."""
    sd = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for name, t in sd.items():
        if name.endswith(".v"):
            t = _sn_v_to_reference(t, sd[name[:-1] + "weight"])
        out[_reference_key(name, module)] = _cpu32(t)
    return out


def _reference_tensors(state_dict: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """Keys without DataParallel's ``module.`` prefix and without
    ``num_batches_tracked``, values as f32 CPU tensors."""
    sd = {}
    for key, v in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if key.endswith("num_batches_tracked"):
            continue
        sd[key] = (v.detach().to("cpu", torch.float32)
                   if isinstance(v, torch.Tensor)
                   else torch.as_tensor(np.asarray(v, dtype=np.float32)))
    return sd


@torch.no_grad()
def _load_reference_state(module: nn.Module, state_dict: Mapping[str, Any],
                          what: str) -> nn.Module:
    sd = _reference_tensors(state_dict)
    own = module.state_dict()
    used = set()
    for name, dst in own.items():
        key = _reference_key(name, module)
        if key not in sd:
            raise KeyError(f"{what} state dict has no {key!r} (for the "
                           f"port's {name})")
        t = sd[key]
        if _CONV1D.match(name) and t.dim() == 3 and t.shape[-1] == 1:
            t = t[..., 0]
        if name.endswith(".v") and isinstance(module, DNetWithHeads):
            weight = own[name[:-1] + "weight"]
            if t.numel() != weight[0].numel():
                raise ValueError(f"{what} state dict gives {key} "
                                 f"{t.numel()} entries, the port expects "
                                 f"{weight[0].numel()}")
            t = _sn_v_from_reference(t, weight)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"{what} state dict gives {name} ({key}) the "
                             f"shape {tuple(t.shape)}, the port expects "
                             f"{tuple(dst.shape)}")
        dst.copy_(t)
        used.add(key)
    unused = [k for k in sd if k not in used]
    if unused:
        raise ValueError(f"{what} state dict entries that no tensor of the "
                         f"port takes (config mismatch?): "
                         + ", ".join(unused[:8]))
    return module


def load_reference_generator_state(module: Union[GNet, GDCGan],
                                   state_dict: Mapping[str, Any]
                                   ) -> Union[GNet, GDCGan]:
    """Fill ``module`` in place (``copy_``, so the fused tail's cached
    operands see the change) from a state dict under the reference's
    ``G_NET`` names (``G_DCGAN``'s for a ``GDCGan``: one head,
    ``img_net.img.0``); the inverse of
    :func:`generator_reference_state_dict`.  Keys may carry the
    ``module.`` prefix, ``num_batches_tracked`` is ignored.  A missing or
    mis-shaped key raises, and so does a key that no tensor takes (another
    ``R_NUM`` or branch count); a ``G_NET`` dict into a ``GDCGan``, or the
    reverse, raises naming ``GAN.B_DCGAN``."""
    heads = {k.split(".img.0.")[0] for k in
             (k[len("module."):] if k.startswith("module.") else k
              for k in state_dict) if k.startswith("img_net")}
    _check_heads(module, len(heads), "the generator state dict")
    return _load_reference_state(module, state_dict, "generator")


def load_reference_discriminator_state(module: DNetWithHeads,
                                       state_dict: Mapping[str, Any]
                                       ) -> DNetWithHeads:
    """Fill ``module`` from a state dict under the reference's
    ``D_NET{64,128,256}`` names (the inverse of
    :func:`discriminator_reference_state_dict`), with the same checks as
    :func:`load_reference_generator_state`."""
    return _load_reference_state(module, state_dict, "discriminator")


def _save(sd: Dict[str, torch.Tensor], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(sd, path)


def _read(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def save_generator_pth(module: Union[GNet, GDCGan], path: str,
                       stats_from: Union[GNet, GDCGan] = None) -> None:
    """``torch.save`` of :func:`generator_reference_state_dict` (a
    reference ``netG_epoch_%d.pth``, ``G_NET`` or ``G_DCGAN``)."""
    _save(generator_reference_state_dict(module, stats_from), path)


def load_generator_pth(module: Union[GNet, GDCGan], path: str
                       ) -> Union[GNet, GDCGan]:
    """Fill ``module`` from a ``netG_epoch_%d.pth`` (the port's or the
    reference's)."""
    return load_reference_generator_state(module, _read(path))


def save_discriminator_pth(module: DNetWithHeads, path: str) -> None:
    """``torch.save`` of :func:`discriminator_reference_state_dict` (a
    reference ``netD%d.pth``)."""
    _save(discriminator_reference_state_dict(module), path)


def load_discriminator_pth(module: DNetWithHeads,
                           path: str) -> DNetWithHeads:
    """Fill ``module`` from a ``netD%d.pth`` (the port's or the
    reference's)."""
    return load_reference_discriminator_state(module, _read(path))
