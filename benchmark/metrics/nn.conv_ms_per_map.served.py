"""Device ms per map in convolution and matrix-product kernels (cuDNN, cuBLAS and the FFT
kernels cuDNN runs convolutions with); the soft-argmin kernel is not one of them."""

from benchmark.metrics.common import device_ms_per_map

PATTERNS = ("conv", "gemm", "fft", "xmma", "cutlass", "winograd", "cudnn", "sm90_", "sm80_")
EXCLUDE = ("softargmin",)


def read(run):
    return device_ms_per_map(run, PATTERNS, EXCLUDE)
