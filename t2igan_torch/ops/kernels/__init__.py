"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per
launch of its kernel, nowhere else), so a run can show that the main path
went through the kernel.  Reset a count by assigning 0.
"""

import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
