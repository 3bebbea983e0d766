"""atvsnet_torch: the A-TVSNet pipeline in PyTorch, with hand-written CUDA kernels for Hopper.

A port of atvsnet_tpu (JAX), which stays the numerical reference. This package imports
torch and numpy only: never jax, and nothing of atvsnet_tpu.

Entry points:
  serving.DepthEstimator          frames and cams in, un-padded metric depth and
                                  confidence out, from one device-resident model
  cli.example                     python -m atvsnet_torch.cli.example: an example/{i}
                                  directory in, pred.npy, pred.jpg and the error report out
  cli.eval_errors                 the 14 depth-error metrics of two .npy/.pfm maps
  models.atvsnet.multi_view_forward, models.tvsnet.two_view_forward
                                  the bare forwards on prepared arrays
  params.load_model / init_model / save_params
                                  weights from and to the JAX package's .npz
  data.preprocess, data.cams, data.pfm, data.mvs_list, eval.errors
                                  the host-side readers, preparation policy and metrics

Those that run the model take a `device`. Left out, it is "cuda", and a machine without
CUDA raises instead of running on the CPU; tests pass device="cpu".
"""

from __future__ import annotations

import torch

from atvsnet_torch.config import PipelineConfig

__all__ = ["PipelineConfig", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or CUDA when None (never a CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "atvsnet_torch runs on CUDA by default and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        device = "cuda"
    return torch.device(device)
