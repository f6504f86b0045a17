"""multimodal_gar_tpu_torch: the PyTorch / CUDA port of multimodal_gar_tpu.

MGAR at configs/mil3.yaml (RGB + LiDAR + DAFM) for one NVIDIA H100: the
train / eval command line (``python -m multimodal_gar_tpu_torch``), the
training loop with evaluation and checkpoints, the host input pipeline, the
model, and hand-written CUDA kernels for the I3D stem, the sparse convs and
their gradients and the row gather (ops/kernels/). The JAX package is the
reference the port is tested against; the port imports nothing of it.
"""
import torch

# mil3 runs in full float32: TF32 keeps about three decimal digits in cuDNN
# convolutions and matmuls, so it stays off until an accuracy decision
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
