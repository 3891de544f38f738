"""Typed configuration for the PyTorch port.

A copy of :mod:`t2igan.config` (the port imports nothing of the JAX
package): the same dataclasses, defaults and YAML merge rules, so the same
YAML files give an equal :class:`Config` in both packages.  ``yaml`` is
imported only inside :func:`cfg_from_file`.

What the port does with the TPU-only generator switches:

* ``GAN.UPBLOCK``, ``GAN.PHASED_TAIL`` and ``GAN.PHASED_TAIL_TRAIN`` pick
  output-equivalent rewrites of the same upsample + conv3x3 (+ BN, GLU, RGB
  head) for XLA; every value computes the same function, so the port
  accepts them and runs the plain form.
* ``GAN.FUSED_TAIL`` selects the fused eval stage tail, a Pallas kernel
  in the JAX package and the hand-written CUDA kernel K3
  (``csrc/reschain.cu``) in the port.
* The ``T2IGAN_*`` environment overrides of the JAX package do not exist
  here: the config alone decides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Mapping


def _frozen(cls):
    return dataclass(frozen=True)(cls)


@_frozen
class TreeConfig:
    BRANCH_NUM: int = 3
    BASE_SIZE: int = 64


@_frozen
class SmoothConfig:
    GAMMA1: float = 5.0
    GAMMA2: float = 5.0
    GAMMA3: float = 10.0
    LAMBDA: float = 1.0


@_frozen
class TrainConfig:
    TRAIN_CLIP_MODEL: bool = False
    DEVICE: str = "cuda:0"  # accepted for YAML parity; not read
    CLIP_MODEL_CHECKPOINT: str = "output/pretrained/clip350.pth"
    CLIP_MODEL_BASE: str = "openai/clip-vit-base-patch32"

    BATCH_SIZE: int = 64
    MAX_EPOCH: int = 600
    SNAPSHOT_INTERVAL: int = 2000
    DISCRIMINATOR_LR: float = 2e-4
    GENERATOR_LR: float = 2e-4
    CLIP_LR: float = 1e-5

    BACKBONE_LR: float = 2e-5
    LINEAR_LR: float = 2e-3
    RNN_GRAD_CLIP: float = 0.25
    STEP_SIZE_UP: int = 300
    GAMMA: float = 0.8
    BASE_LR: float = 1e-7

    FLAG: bool = True
    NET_G: str = ""
    NET_E: str = ""
    B_NET_D: bool = True

    # Cap on DAMSM validation batches per epoch for smoke runs; 0 = the
    # full validation split.
    EVAL_MAX_BATCHES: int = 0

    SMOOTH: SmoothConfig = field(default_factory=SmoothConfig)


@_frozen
class GanConfig:
    DF_DIM: int = 64
    GF_DIM: int = 128
    Z_DIM: int = 100
    CONDITION_DIM: int = 512
    R_NUM: int = 2
    B_ATTENTION: bool = True
    B_DCGAN: bool = False
    # Output-equivalent forms of the UpBlock's upsample + conv3x3 in the JAX
    # package ("dilated", "naive", "subpixel"); the port runs the plain form
    # for all three.
    UPBLOCK: str = "dilated"
    # The fused eval stage tail (a Pallas kernel in the JAX package, K3 in
    # PERF.md, csrc/reschain.cu in the port); eval mode only.
    FUSED_TAIL: bool = False
    # Phase-space form of the final eval tail in the JAX package; the same
    # function as the plain tail, which is what the port runs.
    PHASED_TAIL: bool = True
    # Train-mode counterpart of PHASED_TAIL; the same function as the plain
    # train tail, which is what the port runs.
    PHASED_TAIL_TRAIN: bool = True


@_frozen
class TextConfig:
    CAPTIONS_PER_IMAGE: int = 10
    EMBEDDING_DIM: int = 512
    WORDS_NUM: int = 77


@_frozen
class Config:
    DATASET_NAME: str = "birds"
    CONFIG_NAME: str = ""
    DATA_DIR: str = ""
    GPU_ID: int = 0
    CUDA: bool = True  # accepted for YAML parity; not read
    WORKERS: int = 6
    B_VALIDATION: bool = False
    # Input-pipeline engine of the JAX package ("auto", "thread", "native");
    # accepted for YAML parity.
    DATA_ENGINE: str = "auto"

    TREE: TreeConfig = field(default_factory=TreeConfig)
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    GAN: GanConfig = field(default_factory=GanConfig)
    TEXT: TextConfig = field(default_factory=TextConfig)

    # ---- derived helpers (not part of the YAML surface) ----

    @property
    def branch_sizes(self) -> tuple:
        """Image pyramid sizes, e.g. (64, 128, 256) for BASE_SIZE=64, 3 branches."""
        return tuple(self.TREE.BASE_SIZE * (2 ** i) for i in range(self.TREE.BRANCH_NUM))

    @property
    def final_size(self) -> int:
        return self.TREE.BASE_SIZE * (2 ** (self.TREE.BRANCH_NUM - 1))


def _merge_into(cls: type, defaults: Any, overrides: Mapping[str, Any], path: str = ""):
    """Merge a YAML mapping into a dataclass.

    Unknown keys raise ``KeyError``; a type mismatch raises ``ValueError``,
    except that an ``int`` is accepted for a ``float`` default (YAML ``5``
    vs ``5.0``).
    """
    valid = {f.name: f for f in fields(cls)}
    kwargs = {}
    for key, value in overrides.items():
        if key not in valid:
            raise KeyError("{} is not a valid config key".format(path + key))
        default_val = getattr(defaults, key)
        if dataclasses.is_dataclass(default_val):
            if not isinstance(value, Mapping):
                raise ValueError(
                    "Type mismatch ({} vs. {}) for config key: {}".format(
                        type(default_val), type(value), path + key))
            kwargs[key] = _merge_into(type(default_val), default_val, value,
                                      path + key + ".")
        else:
            if type(default_val) is not type(value):
                ok = (isinstance(default_val, float) and isinstance(value, int)
                      and not isinstance(value, bool))
                if ok:
                    value = float(value)
                else:
                    raise ValueError(
                        "Type mismatch ({} vs. {}) for config key: {}".format(
                            type(default_val), type(value), path + key))
            kwargs[key] = value
    return dataclasses.replace(defaults, **kwargs)


def cfg_from_file(filename: str, base: Config | None = None) -> Config:
    """Load a YAML config file and merge it over the defaults."""
    import yaml

    with open(filename, "r") as f:
        yaml_cfg = yaml.safe_load(f) or {}
    return cfg_from_dict(yaml_cfg, base=base)


def cfg_from_dict(d: Mapping[str, Any], base: Config | None = None) -> Config:
    base = base if base is not None else Config()
    return _merge_into(Config, base, d)


def cfg_replace(cfg: Config, **updates) -> Config:
    """Functional update helper: ``cfg_replace(cfg, TRAIN=dict(BATCH_SIZE=8))``."""
    return _merge_into(Config, cfg, updates)
