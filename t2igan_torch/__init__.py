"""t2igan_torch — the PyTorch/CUDA port of t2igan, for NVIDIA Hopper.

The JAX package :mod:`t2igan` is the reference this package is held
against; this package imports ``torch``, ``numpy`` and the standard library
and nothing of ``t2igan`` or JAX.  Its paths so far:

* the sampler (:func:`t2igan_torch.train.steps.make_sampler`): caption
  token ids through the CLIP text tower and the cascaded DM-GAN generator
  in eval mode to images at 64, 128 and 256 px;
* the adversarial train step (:func:`t2igan_torch.train.steps.make_gan_step`):
  the generator in train mode, three spectral-norm discriminators, the GAN,
  DAMSM and NT-Xent losses through the frozen CLIP towers, Adam and the
  G EMA;
* gen+eval (:func:`t2igan_torch.evaluation.fid.make_gen_activation_fn`):
  the sampler's images through the FID Inception-v3 to ``pool3``.

The memory read of each refinement stage is a pair of hand-written CUDA
kernels, forward (``csrc/memory_read.cu``) and backward
(``csrc/memory_read_bwd.cu``); under ``GAN.FUSED_TAIL`` each stage's eval
tail is a third (``csrc/reschain.cu``).  All are built with ``nvcc`` at
first use.

Entry points: ``python -m t2igan_torch.generate --cfg CFG --captions FILE``
and ``python -m t2igan_torch.train_gan --cfg CFG --steps N``.
"""

from t2igan_torch.config import Config, cfg_from_dict, cfg_from_file, cfg_replace

__all__ = ["Config", "cfg_from_dict", "cfg_from_file", "cfg_replace"]
