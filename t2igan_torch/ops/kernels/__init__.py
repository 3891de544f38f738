"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
the memory read forward and backward (:mod:`.memory_read`), the fused
eval stage tail (:mod:`.reschain`) and train-mode BatchNorm with its GLU or
residual epilogue (:mod:`.batchnorm`).

The memory read and fused-tail wrappers count their launches in
:data:`LAUNCHES` (one per launch of their kernel, nowhere else), so a run
can show that the main path went through the kernel.  Reset a count by
assigning 0.  The BatchNorm kernels count theirs apart, in
:data:`.batchnorm.BN_LAUNCHES`: a benchmark run holds every key of
``LAUNCHES`` to the launches its entry expects a call, and the train
entry expects K1-K3 alone.  Once it expects the BN kernels too, their
counter folds into ``LAUNCHES``.
"""

import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
