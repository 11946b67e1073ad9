"""The device every entry point runs on, and the host-to-device copy path.

``resolve_device`` is the counterpart of the JAX package's ``on_tpu()``:
the card is the default and its absence is an error, never a silent move
to the CPU. The CPU runs only when the caller asks for it.

``HostToDevice`` replaces ``jax.device_put``. On a CUDA device each host
array is copied with ``non_blocking=True`` on one dedicated copy stream,
so weight streaming overlaps the kernels on the compute stream. A host
array in page-locked memory (a model's weights, which ``pinned_copy``
moves into one registered slab) is copied straight from where it lies;
any other goes through a pinned staging buffer first:

* a thread that issues copies enters ``copies()`` (``torch.cuda.stream``
  of the copy stream) and calls ``put``;
* ``mark`` records an event on the copy stream after a weight's chunks,
  and the compute stream ``wait``s on it before it uses the weight;
* every tensor made on the copy stream is ``record_stream``-ed on the
  compute stream, so the caching allocator cannot hand its memory out
  again while compute kernels still read it.

PyTorch's pinned host allocator keeps each staging block until the copy
that reads it has finished, so a staging buffer is dropped right after
its copy is enqueued. A registered slab is not one of its blocks: ``put``
holds every source it did not stage, with an event recorded after its
copy, until that event has completed (``HostToDevice.in_flight``), so the
slab is never unregistered and freed while a queued copy still reads it,
whoever drops the last view of it first.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` by default; raises when CUDA is absent unless the caller
    passed ``"cpu"`` (or ``"meta"``, on which a dry run computes nothing)."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _unregister(ptr: int) -> None:
    """Unpin a ``pinned_copy`` slab: runs just before numpy frees it."""
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pinned_copy(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Copy host arrays into one page-aligned slab that is page-locked in
    place (``cudaHostRegister``) and return views of it, same names, same
    values, so the copy stream moves them to the card at the host link's
    rate with no staging copy. The slab is unregistered just before numpy
    frees it, once no view of it is left and no copy from it is in flight
    (``HostToDevice.put`` holds a view until its copy has landed)."""
    align = 4096
    offsets, total = {}, 0
    for name, a in arrays.items():
        offsets[name] = total
        total += -(-a.nbytes // align) * align
    if total == 0:
        return dict(arrays)
    raw = np.empty(total + align, np.uint8)
    start = -raw.ctypes.data % align
    slab = raw[start: start + total]
    cudart = torch.cuda.cudart()
    err = int(cudart.cudaHostRegister(slab.ctypes.data, total, 0))
    if err != 0:
        raise RuntimeError(f"cudaHostRegister failed with CUDA error {err}")
    weakref.finalize(raw, _unregister, slab.ctypes.data).atexit = False
    out = {}
    for name, a in arrays.items():
        view = slab[offsets[name]: offsets[name] + a.nbytes] \
            .view(a.dtype).reshape(a.shape)
        view[...] = a
        out[name] = view
    return out


class HostToDevice:
    """Host-array copies onto one device through its copy stream.
    ``copied_bytes`` counts the bytes every instance has copied.
    ``in_flight`` holds (event, source) for each copy from page-locked
    memory that PyTorch's allocator does not own (a ``pinned_copy`` view):
    the source stays alive until the event, recorded after its copy, has
    completed. It is shared by every instance, so an engine or a replica
    dropped with copies queued still holds their sources; ``put`` and
    ``mark`` drop the landed ones."""

    copied_bytes = 0
    _count_lock = threading.Lock()
    in_flight: List[Tuple["torch.cuda.Event", torch.Tensor]] = []
    _flight_lock = threading.Lock()

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        # the stream that consumes the copies: the creator's current one
        self.compute = torch.cuda.current_stream(device) \
            if self.cuda else None

    def copies(self):
        """Context in which ``put`` enqueues on the copy stream."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def put(self, host: np.ndarray) -> torch.Tensor:
        """Copy ``host`` to the device on the current stream."""
        src = torch.from_numpy(np.ascontiguousarray(host))
        with HostToDevice._count_lock:
            HostToDevice.copied_bytes += src.nbytes
        if not self.cuda:
            return src.clone()
        HostToDevice.release_landed()
        registered = src.is_pinned()
        if not registered:
            staging = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
            src = staging.copy_(src)
        stream = torch.cuda.current_stream(self.device)
        out = src.to(self.device, non_blocking=True)
        if registered:
            landed = torch.cuda.Event()
            landed.record(stream)
            with HostToDevice._flight_lock:
                HostToDevice.in_flight.append((landed, src))
        if stream != self.compute:
            out.record_stream(self.compute)
        return out

    @staticmethod
    def release_landed() -> None:
        """Drop the held sources whose copies have landed (outside the
        lock: the last one of a slab unregisters it)."""
        with HostToDevice._flight_lock:
            held = HostToDevice.in_flight
            done = [pair[0].query() for pair in held]
            landed = [pair for pair, d in zip(held, done) if d]
            held[:] = [pair for pair, d in zip(held, done) if not d]
        del landed

    def mark(self, event: Optional["torch.cuda.Event"] = None):
        """Record ``event`` (a new one if None) on the copy stream: it
        completes once every copy enqueued so far has landed."""
        if not self.cuda:
            return None
        HostToDevice.release_landed()
        event = event or torch.cuda.Event()
        event.record(self.stream)
        return event

    def wait(self, event) -> None:
        """Make the compute stream wait for ``event`` (device side)."""
        if event is not None:
            self.compute.wait_event(event)
