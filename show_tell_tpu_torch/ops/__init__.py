"""Hand-written Hopper kernels of the port, and the one rule that routes to them.

A wrapper launches its CUDA kernel for tensors on a CUDA device and runs
the kernel's plain PyTorch twin for tensors on the CPU.  There is no other
switch: no flag, no environment variable, and no fallback from a kernel
that fails to build or launch (that raises).

The helpers below are what every wrapper does before and after a launch:
check each tensor it hands to the kernel, pass the current stream, and
raise on a CUDA error.
"""

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' `dtype` argument


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("show_tell_tpu_torch kernels take CPU or CUDA tensors, not %s" % t.device)


def dtype_code(kernel: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise ValueError("%s takes float32 or bfloat16, not %s" % (kernel, dtype))
    return DTYPE_CODES[dtype]


def check_widths(kernel: str, **widths: int) -> None:
    """Row widths the kernels load as 16-byte vectors must be multiples of 8."""
    bad = {k: v for k, v in widths.items() if v < 8 or v % 8}
    if bad:
        raise ValueError("%s needs widths that are multiples of 8, got %s" % (kernel, bad))


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raise unless ``t`` has this device, dtype and shape, is contiguous and 16-byte aligned."""
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.data_ptr() % 16:
        raise ValueError("%s must be 16-byte aligned" % name)


def stream_arg(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, as the kernels' last argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError("%s kernel failed with cudaError_t %d" % (kernel, err))
