"""Device ms a step of cuDNN and cuBLAS convolution, GEMM and layout
kernels (torch.profiler, traced window)."""

from cfbench.readers import CONV_KEYS, device_ms

UNIT = "ms"


def read(run, summary):
    return device_ms(run, summary, "train", CONV_KEYS)
