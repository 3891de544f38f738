"""The plain reference that decides ``correct``: plain PyTorch, importing
nothing of the program, fed the benchmark's own weights and inputs."""

import contextlib

import torch


@contextlib.contextmanager
def exact():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
