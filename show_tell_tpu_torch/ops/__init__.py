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

    Off, by an A/B on an NVIDIA H100 80GB HBM3 at its 700 W power limit
    (chip_smoke.py phase 6: host clock a T=25 pooled-GRU decode, ten
    rounds of five decodes in turns against 25 fused-step launches with
    index_select between them; ids bit-equal).  The rule, fixed before the
    first run: on when at B=64 bf16 the whole decode is faster in at least
    9 of 10 rounds and the medians differ by more than the larger
    interquartile range, and the loop wins so at none of B = 1, 64, 512.

    The run that turned it off came after both kernels moved to the
    tensor cores in bf16 (the per-step GRU step from 0.42 to 0.06 ms at
    B=64): the whole decode won at B=1 (1.1878 against 1.8889 ms, 10 of
    10 rounds) and B=64 (1.5616 against 1.7619 ms, 10 of 10, medians
    0.2003 ms apart, spread 0.1896 ms), and lost at B=512 (3.8727 against
    3.7698 ms, the loop faster in 10 of 10 rounds, medians 0.1029 ms
    apart, spread 0.0403 ms).  In f32, when both still ran the SIMT code
    (before the 3xTF32 tiles), the whole decode was faster at every B
    (1.20x, 1.031x, 1.019x); that A/B has not been run on the 3xTF32 tiles.
    The earlier runs, on the SIMT
    bf16 kernels, had it on: faster in 10 of 10 rounds at every B, 1.62x
    at B=1 and 1.01x at B=64 in the run that set it.

    Where it loses: at B=512 a whole-decode step takes about 7 us more on
    the card than a launch of the per-step kernel (tools/step_times.py in
    the same call: 3.8571 and 3.8768 ms for 25 steps, 0.1479 and 0.1477 ms
    a step), and the host work it saves is hidden there behind the card.
    Where the 7 us go is not measured: its extra grid barrier and row
    gather a step, or a kernel at 255 registers against the step's 234.  A
    route by batch size would keep its gain at B <= 64; the rule as fixed
    takes one default for every B.  Early exit, the LSTM and the sharded
    projection keep the per-step loop either way."""
    return False


def beam_step_default() -> str:
    """The step route that ``captioner_beam_decode`` gives a pooled
    family's beam search (``decode.beam.beam_search_decode``'s
    ``fused_step``), "dense" or "topk"; the counterpart of
    show_tell_tpu/ops/__init__.py::pallas_beam_fused_default.  The
    attention families keep the dense step: the JAX package has no
    attention top-k step.

    The rule, fixed before the first timed run (chip_smoke.py phase 6:
    host clock a whole beam decode at K=3, bf16, ids on the host, ten
    rounds of five decodes with the two routes in turns, the pooled GRU and
    LSTM at B = 1, 64, 256): "topk" when, for both pooled families, the
    top-k route is faster at B=64 in at least 9 of 10 rounds with medians
    more than the larger interquartile range apart, and the dense route
    wins so at neither B=1 nor B=256; else "dense".

    Dense, by the A/B on an NVIDIA H100 80GB HBM3 at its 700 W power limit
    that followed the top-k step's move to the tensor cores (0.0974 ms
    against the dense step's 0.0808 at R=192, GRU; 1.2488 before): at B=64
    the top-k route was faster in 8 of 10 rounds for either family, its
    medians 1.2723 ms (GRU, 15.7562 against 17.0285 ms) and 2.2929 ms
    (LSTM) lower, inside the larger interquartile ranges (1.9912, 2.7501
    ms), so no route won there; at B=256 it won 10 of 10 rounds for both
    (GRU 14.4061 against 27.9639 ms, LSTM 17.5778 against 29.4840 ms); at
    B=1 neither won.  Two more runs of the same code gave the same
    verdicts.  Both routes spend most of a decode at B <= 64 in the
    engine's host work between the 24 step launches, which is why the
    routes tie there; the top-k route's gain (no log_softmax over R x V,
    a sort of B x K^2 candidates, not B x K x V) shows once the device
    work outgrows the host's, at B=256.  A route by batch size would take
    that gain; the rule as fixed takes one default for every B."""
    return "dense"


def fold_bn_default() -> bool:
    """Whether ``serve.Captioner`` serves the encoder with every BatchNorm
    folded into its convolution (models/serving.FoldedEncoder) when the
    caller does not say; the counterpart of the JAX package's serving
    transform (show_tell_tpu/models/serving.py).  It is the card's
    default: on the CPU the Captioner keeps the unfolded encoder, the JAX
    package's own serving route, to which the CPU tests hold it.

    The rule, fixed before the first timed run (chip_smoke.py phase 6 (b):
    the encoder alone from uint8 pixels on the card, folded and unfolded
    in turns, ten rounds of five encodes by CUDA events, the pooled GRU and
    the attention GRU at B = 1 and 64, bf16 and f32): on where the folded
    route wins at B=64 in bf16 for both families by ab_verdict's rule
    (faster in at least 9 of 10 rounds, the medians further apart than the
    larger interquartile range) and the unfolded route wins in no cell.

    On, by two runs of that A/B on an NVIDIA H100 80GB HBM3 at its 700 W
    power limit: the folded route was faster in 10 of 10 rounds in every
    cell; at B=64 bf16 it took 4.21-5.57 ms against 8.63-13.92 ms (2.05-2.78x,
    the medians 4.4-8.4 ms apart against spreads of 0.05-2.3 ms), at B=1
    bf16 2.34-5.36 against 6.54-13.45 ms, at B=64 f32 41.0-41.1 against
    45.6-45.8 ms (1.11x: the convolutions without TF32 are the time); at B=1
    f32 it won or tied.  The folded route runs none of the unfolded one's
    ~104 eval-BatchNorm, ~100 ReLU and 33 add passes over the activations."""
    return True
