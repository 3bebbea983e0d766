"""Device-to-host downloads that do not stall the queue behind them."""

from __future__ import annotations

import numpy as np
import torch


def start_download(t: torch.Tensor):
    """Start bringing a tensor to the host: (host tensor, event or None). From a CUDA device
    the copy goes into pinned memory without blocking and the event fires when it has
    landed, so work queued after it runs on while the host waits for this copy only. A CPU
    tensor comes back as it is."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def finish_download(host: torch.Tensor, event) -> np.ndarray:
    """Wait for a download begun by start_download; the array is a view of the host tensor."""
    if event is not None:
        event.synchronize()
    return host.numpy()
