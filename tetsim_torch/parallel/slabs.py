"""``SlabMesh``: d x-slabs of a grid box, each on a device, and the two
boundary-plane moves between neighbouring slabs.

A slab owns lx cube columns and lx + 1 vertex planes; the plane it shares
with each neighbour is stored by both.  The moves are the only place where
slabs talk to each other: ``send_left`` moves a plane of slab i to slab
i - 1 and ``send_right`` a plane of slab i to slab i + 1, each as a
``copy_`` (the Neo-Hookean sweep refreshes a stale replica) or an ``add_``
(``add_halo``: the polar halo completes a partial sum) on the current
stream, across devices where the two slabs lie on different ones.
``device_groups`` gives a kernel the slabs of each device as one tensor.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..state import check_device


class SlabMesh:
    """``size`` slabs along x and the device of each: ``SlabMesh(4)`` puts
    4 slabs on the card, ``SlabMesh(devices=["cpu"] * 8)`` 8 on the CPU.
    ``size`` is what JAX's ``mesh.shape[axis]`` gives the steppers."""

    def __init__(self, size: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        if devices is None:
            if size is None:
                raise ValueError("SlabMesh needs a size or a device list")
            devices = ["cuda"] * int(size)
        elif size is not None and int(size) != len(devices):
            raise ValueError(f"size {size} != {len(devices)} devices")
        if not devices:
            raise ValueError("SlabMesh needs at least one slab")
        self.devices = tuple(check_device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def groups(self) -> List[tuple]:
        """[(device, first slab, slab count)]: runs of consecutive slabs on
        one device, which a kernel launch covers together."""
        out = []
        for i, dev in enumerate(self.devices):
            if out and out[-1][0] == dev:
                out[-1] = (dev, out[-1][1], out[-1][2] + 1)
            else:
                out.append((dev, i, 1))
        return out

    def device(self) -> torch.device:
        """The one device of every slab; raises where they differ."""
        if len(set(self.devices)) != 1:
            raise ValueError(
                "the plain slab steppers stack the slabs on one device; this "
                f"mesh spans {sorted(set(map(str, self.devices)))}")
        return self.devices[0]

    def place(self, slabs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-slab tensors of one shape, each moved to its slab's device;
        the slabs of a group come out as consecutive slices of one buffer,
        so ``group_view`` covers them without a copy."""
        out: List[torch.Tensor] = []
        for dev, first, k in self.groups():
            out += ungroup(torch.stack(list(slabs[first:first + k])).to(dev))
        return out

    def send_left(self, src, dst, add: bool = False, pairs=None) -> None:
        """dst[i - 1] <- src[i] for i = 1 .. size - 1, or for the i in
        ``pairs`` (``copy_``, or ``add_`` with ``add``); src and dst list
        one plane view per slab."""
        for i in range(1, self.size) if pairs is None else pairs:
            _move(src[i], dst[i - 1], add)

    def send_right(self, src, dst, add: bool = False, pairs=None) -> None:
        """dst[i] <- src[i - 1] for i = 1 .. size - 1, or for the i in
        ``pairs``."""
        for i in range(1, self.size) if pairs is None else pairs:
            _move(src[i - 1], dst[i], add)

    def device_cuts(self) -> List[int]:
        """The slabs i whose left neighbour i - 1 lies on another device."""
        return [first for _, first, _ in self.groups()[1:]]

    def add_halo(self, lo, hi) -> None:
        """Complete the shared planes' partial sums: each slab's plane 0
        (``lo``) gains its left neighbour's plane lx (``hi``) and each plane
        lx its right neighbour's plane 0, both as they were before; the two
        copies of a shared plane then hold the same sum bit for bit (IEEE
        addition commutes)."""
        first = [p.clone() for p in lo]
        self.send_right(hi, lo, add=True)
        self.send_left(first, hi, add=True)


def _move(src: torch.Tensor, dst: torch.Tensor, add: bool) -> None:
    if src.device != dst.device:
        src = src.to(dst.device)
    if add:
        dst.add_(src)
    else:
        dst.copy_(src)


def plane(x: torch.Tensor, p: int, gyz: int) -> torch.Tensor:
    """View of vertex plane p of a slab tensor [..., planes * gyz (+ pad)]."""
    return x[..., p * gyz:(p + 1) * gyz]


def group_view(slabs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One [k, ...] tensor over a group's k slab tensors: a view of their
    storage where they are consecutive, equal, contiguous slices of one
    buffer (as ``ungroup`` makes them), else a stacked copy."""
    first = slabs[0]
    n = first.numel()
    same = all(
        s.shape == first.shape and s.dtype == first.dtype and s.is_contiguous()
        and s.device == first.device
        and s.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
        and s.data_ptr() == first.data_ptr() + i * n * s.element_size()
        for i, s in enumerate(slabs))
    if same:
        return first.as_strided((len(slabs),) + tuple(first.shape),
                                (n,) + tuple(first.stride()))
    return torch.stack(list(slabs))


def device_groups(mesh: SlabMesh, **slabs) -> List[dict]:
    """For each run of ``mesh``'s slabs on one CUDA device, the launch
    context ``dev``, ``stream``, ``first`` (slab) and ``k`` (count), and
    each named per-slab list as one [k, ...] tensor (``group_view``);
    raises for a slab that is not on a CUDA device."""
    out = []
    for dev, first, k in mesh.groups():
        if dev.type != "cuda":
            raise ValueError(f"the slab kernels run on CUDA, not {dev}")
        g = {name: group_view(v[first:first + k]) for name, v in slabs.items()}
        dev = next(iter(g.values())).device
        g.update(dev=dev, stream=torch.cuda.current_stream(dev).cuda_stream,
                 first=first, k=k)
        out.append(g)
    return out


def ungroup(x: torch.Tensor) -> List[torch.Tensor]:
    """The per-slab views [k, ...] -> k tensors."""
    return list(x.unbind(0))
