"""Hand-written CUDA kernels of the port and their plain PyTorch versions:
the memory read forward and backward (:mod:`.memory_read`) and the fused
eval stage tail (:mod:`.reschain`).

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per
launch of its kernel, nowhere else), so a run can show that the main path
went through the kernel.  Reset a count by assigning 0.
"""

import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
