"""PyTorch + CUDA port of the Gaussian Process Transportation framework.

A second package beside ``gaussian_process_transportation_tpu`` (the JAX
reference, which it never imports).  Plain tensor code is PyTorch; the one
TPU kernel on the ensemble-transport path
(``ops/batched_linalg.py::spd_inverse_elast_fused``) is a CUDA kernel
written for Hopper (``csrc/spd_inverse_elast.cu``), built with ``nvcc`` at
first use.  Every function dispatches on the device of the tensors it is
given: CPU tensors take the plain PyTorch twins, CUDA tensors the kernels.
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
from .transport import gpt
from .utils.resample import resample

__all__ = ["kernels", "gpt", "resample"]

__version__ = "0.1.0"
