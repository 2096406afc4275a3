"""volsurfs_tpu_torch: the PyTorch / CUDA port of volsurfs_tpu for one
NVIDIA H100.

The package keeps the JAX package's module names; inside, it is PyTorch:
``nn.Module``s, functions on tensors, an explicit ``device`` and
``torch.Generator``. Entry points default to ``device="cuda"``. Each hot
function that the JAX package ran as a TPU kernel or as TPU-shaped XLA is
a CUDA kernel written by hand (``csrc/``), built at first use by
``_build``; beside it sits a plain PyTorch version that runs on CPU
tensors and that the kernel is tested against.
"""

import torch as _torch

__version__ = "0.1.0"

# full float32 matmuls and convolutions, as the JAX package sets
# jax_default_matmul_precision="highest"
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
