"""EnFed in PyTorch with hand-written Hopper kernels.

The port of the JAX package ``repro`` to PyTorch and CUDA (``sm_90a``).
Its module layout mirrors ``repro`` file for file, and it imports nothing
of ``repro`` and nothing of ``jax``: it runs on a host that has neither.

Entry points (``EnFedSession``, ``SupervisedTask``) run on ``cuda`` unless
the caller passes ``device="cpu"``.  On a CUDA tensor every kernel wrapper
launches its hand-written kernel (``src/repro_torch/csrc/*.cu``, built by
``nvcc`` at first use); on a CPU tensor it runs the kernel's plain PyTorch
twin (``kernels/<name>/ref.py``), which is the spec.

TF32 is switched off for matmuls and cuDNN at import: the JAX reference
computes in full float32, and TF32 keeps only about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
