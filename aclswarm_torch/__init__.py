"""PyTorch/CUDA port of the swarm framework (`aclswarm_tpu` is the
reference it is held against, module for module).

Plain tensor code is PyTorch; the three kernels the reference wrote in
Pallas are hand-written CUDA C++ for Hopper under `aclswarm_torch/csrc/`,
built with ``nvcc`` at first use (`aclswarm_torch.ops`).

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises when no card is present.
"""
import torch

__version__ = "0.1.0"

# The reference runs every contraction at precision="highest"
# (`aclswarm_tpu/core/geometry.py`, `control/distcntrl.py`): its default
# reduced-precision matmuls cost ~1e-2 alignment error. TF32 keeps ~3
# decimal digits and would reproduce exactly that error on Hopper, so the
# port keeps every float32 product in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
