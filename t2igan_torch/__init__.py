"""t2igan_torch — the PyTorch/CUDA port of t2igan, for NVIDIA Hopper.

The JAX package :mod:`t2igan` is the reference this package is held
against; this package imports ``torch``, ``numpy`` and the standard library
and nothing of ``t2igan`` or JAX.  Its main path is the sampler
(:func:`t2igan_torch.train.steps.make_sampler`): caption token ids through
the CLIP text tower and the cascaded DM-GAN generator in eval mode to
images at 64, 128 and 256 px.  The memory read of each refinement stage is
a hand-written CUDA kernel (``csrc/memory_read.cu``), built with ``nvcc``
at first use.

Entry point: ``python -m t2igan_torch.generate --cfg CFG --captions FILE``.
"""

from t2igan_torch.config import Config, cfg_from_dict, cfg_from_file, cfg_replace

__all__ = ["Config", "cfg_from_dict", "cfg_from_file", "cfg_replace"]
