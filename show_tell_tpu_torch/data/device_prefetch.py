"""Batches staged on the device one step ahead (counterpart of
show_tell_tpu/data/device_prefetch.py, one device).

On a GPU each host batch's arrays are copied into pinned memory and on to
the card with ``non_blocking=True`` on a side stream, and an event records
the copy; the batch is yielded only after the next batch's copy has been
queued, and the compute stream waits on its event before using it
(``record_stream`` tells the allocator that the compute stream reads
memory the side stream allocated).  That is ``serve.Captioner.stage``'s
pattern, one batch ahead.  On the CPU the arrays become tensors as they are.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from show_tell_tpu_torch.core.device import resolve_device


def device_prefetch(batches: Iterable, device: Union[str, torch.device],
                    put_indices: Tuple[int, ...] = (1, 2, 3), stage_ahead: bool = True) -> Iterator[tuple]:
    """Yield each batch with its elements at ``put_indices`` (numpy arrays:
    images, captions, lengths) as tensors on ``device``, the next batch's
    copy already queued; the other elements (the paths) pass through.
    ``stage_ahead=False`` queues each batch's copy only when it is taken
    (the serial order, for an A/B of the staging)."""
    device = resolve_device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch) -> Tuple[list, Optional["torch.cuda.Event"]]:
        out = list(batch)
        if stream is None:
            for i in put_indices:
                out[i] = torch.from_numpy(np.ascontiguousarray(out[i]))
            return out, None
        pinned = [torch.from_numpy(np.ascontiguousarray(out[i])).pin_memory() for i in put_indices]
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for i, host in zip(put_indices, pinned):
                out[i] = host.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def take(staged) -> tuple:
        out, ready = staged
        if ready is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(ready)
            for i in put_indices:
                out[i].record_stream(compute)
        return tuple(out)

    it = iter(batches)
    if not stage_ahead:
        for batch in it:
            yield take(put(batch))
        return
    try:
        pending = put(next(it))
    except StopIteration:
        return
    for nxt in it:
        staged = put(nxt)  # queue batch k+1's copy before batch k is used
        yield take(pending)
        pending = staged
    yield take(pending)
