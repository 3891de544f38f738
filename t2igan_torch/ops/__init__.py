"""Tensor ops of the port: attention primitives, image helpers and the
hand-written CUDA kernels (:mod:`t2igan_torch.ops.kernels`)."""
