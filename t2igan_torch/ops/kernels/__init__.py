"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
the memory read forward and backward (:mod:`.memory_read`), the fused
eval stage tail (:mod:`.reschain`) and train-mode BatchNorm with its GLU or
residual epilogue (:mod:`.batchnorm`).

The memory read and fused-tail wrappers count their launches in
:data:`LAUNCHES` (one per launch of their kernel, nowhere else), so a run
can show that the main path went through the kernel.  A replayed CUDA
graph of the GAN step (:mod:`t2igan_torch.train.graphs`) runs no wrapper:
its count is copied from what the wrappers counted at its capture, so it
says what the capture recorded, not what the card ran; a profiler trace
of a replay measures that (``chip_smoke.py`` phases 4a and 4d).  Reset a
count by assigning 0.  The BatchNorm kernels count theirs apart, in
:data:`.batchnorm.BN_LAUNCHES`: a benchmark run holds every key of
``LAUNCHES`` to the launches its entry expects a call, and the train
entry expects K1-K3 alone.  Once it expects the BN kernels too, their
counter folds into ``LAUNCHES``.
"""

import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
