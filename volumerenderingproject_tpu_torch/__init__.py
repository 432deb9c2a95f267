"""volumerenderingproject_tpu_torch — the PyTorch/CUDA port of the volume
renderer, for NVIDIA Hopper GPUs.

The JAX package ``volumerenderingproject_tpu`` is the reference; this
package imports neither it nor JAX.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.  The a1/VRC render's march runs in a
hand-written CUDA kernel (``csrc/march.cu``), built with nvcc at first use.
"""

import torch

# full float32 everywhere, the counterpart of the JAX package's
# Precision.HIGHEST pins: no TF32 in matrix products or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .ingest.volume import Volume, make_volume  # noqa: E402
from .ingest.nifti import load_nifti  # noqa: E402
from .scene.camera import Camera, default_camera, reset_preset  # noqa: E402
from .scene.transfer_function import (  # noqa: E402
    TransferFunction,
    default_transfer_function,
)
from .utils.config import Algorithm, Interp, RenderConfig  # noqa: E402
from .models.raycast import render, render_vrc  # noqa: E402

__version__ = "0.1.0"
