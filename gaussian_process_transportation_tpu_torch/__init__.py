"""PyTorch + CUDA port of the Gaussian Process Transportation framework.

A second package beside ``gaussian_process_transportation_tpu`` (the JAX
reference, which it never imports).  Plain tensor code is PyTorch; each of
the JAX package's seven TPU kernels is a CUDA kernel written for Hopper
under ``csrc/`` (the batched small Cholesky/inverse, the panel factor of
the blocked Cholesky, the Gram tile and fused predicts, the fused
small-N LML value and gradient), built with ``nvcc`` at first use; the
random forest's split search is host C++ (``csrc/cart.cpp``), built with
``g++`` at first use.  Every
function dispatches on the device of the tensors it is given: CPU tensors
take the plain PyTorch twins, CUDA tensors the kernels.  The entry points
that make tensors (``GaussianProcessTransportation``, ``convert``) put
them on the card unless asked for the CPU.
"""

import torch as _torch

# The JAX package pins float32 matmuls to full precision because TPU bf16
# passes broke GP Grams (lost positive-definiteness, NaN Cholesky).  TF32
# keeps about three decimal digits and is the Hopper form of the same trap,
# so matmuls and cuDNN stay in full float32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import kernels
from .models import AffineTransform, GaussianProcess
from .transport import gpt
from .transport.gpt import GaussianProcessTransportation
from .utils.resample import resample

__all__ = [
    "kernels",
    "GaussianProcess",
    "AffineTransform",
    "GaussianProcessTransportation",
    "resample",
    "gpt",
]

__version__ = "0.1.0"
