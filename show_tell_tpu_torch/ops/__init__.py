"""Hand-written Hopper kernels of the port, and the one rule that routes to them.

A wrapper launches its CUDA kernel for tensors on a CUDA device and runs
the kernel's plain PyTorch twin for tensors on the CPU.  There is no other
switch: no flag, no environment variable, and no fallback from a kernel
that fails to build or launch (that raises).
"""

import torch


def uses_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain twin); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError("show_tell_tpu_torch kernels take CPU or CUDA tensors, not %s" % t.device)
