"""Device ms a batch of cuDNN and cuBLAS convolution, GEMM and layout
kernels (torch.profiler, traced window)."""

from cfbench.readers import CONV_KEYS, device_ms

UNIT = "ms"


def read(run, summary):
    return device_ms(run, summary, "serve", CONV_KEYS)
