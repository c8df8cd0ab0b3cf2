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


def whole_decode_default() -> bool:
    """Whether ``greedy_decode_kernel`` takes the whole-decode kernel
    (ops/whole_decode.py: all T greedy GRU steps in one launch) when the
    caller does not say; the counterpart of
    show_tell_tpu/ops/__init__.py::pallas_whole_decode_default.

    On, by an A/B on an NVIDIA H100 80GB HBM3 at its 700 W power limit
    (chip_smoke.py phase 6: host clock a T=25 pooled-GRU decode, ten
    rounds of five decodes in turns against 25 fused-step launches with
    index_select between them; ids bit-equal).  The rule: on when at
    B=64 bf16 the whole decode is faster in at least 9 of 10 rounds and
    the medians differ by more than the larger interquartile range, and
    the loop wins so at none of B = 1, 64, 512.  The run that set it, with
    the rule fixed before it, had the whole decode faster in 10 of 10 rounds
    at every B, bf16 and f32: 0.9717 against 1.9152 ms at B=1, 10.6069
    against 10.7170 ms at B=64 (medians 0.1101 ms apart, spread
    0.0195 ms), 81.4852 against 81.8421 ms at B=512; f32 1.62x, 1.021x,
    1.016x.  Of the four earlier runs, which printed ranges only, or
    quartiles without counting rounds, the second had one whole-decode
    round of 13.54 ms at B=64 and so no win by min-max ranges; the rule
    moved to quartiles after it.

    What it saves is the host's work between steps: the loop waits on it
    at B=1 and hides it behind the device at B >= 64, where the kernel's
    extra grid barrier a step (1.6 us) eats most of the saving.  Whether
    the 1% at B=64 shows in captions/s is not verified: three host-clock
    requests spread more than that.  The TPU kernel's 0.99x and 0.82x
    (off there) do not carry over.  Early exit, the LSTM and the sharded
    projection keep the per-step loop."""
    return True
