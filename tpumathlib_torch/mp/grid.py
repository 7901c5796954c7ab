"""Process grids, sharded operands and block-cyclic layouts.

Counterpart of ``tpumathlib/mp/grid.py``.
- ``cublasMpGridCreate`` / ``cusolverMpCreateDeviceGrid`` → ``Grid``: a
  list of ranks, each a ``torch.device``, named by the reference's mesh
  axes (``("x",)``, or ``("x", "y")`` for a 2D grid).
- ``NamedSharding(mesh, spec)`` → ``Grid.sharding(spec)``, and
  ``jax.device_put(x, sharding)`` → ``Grid.shard(x, spec)``, which returns a
  ``Sharded``: one tensor a rank, each on its rank's device, and the spec
  as a tuple (``("x", None)`` for ``P("x", None)``).
- ``numroc``, ``block_cyclic_spec`` and ``block_cyclic_to_global`` are the
  reference's numpy helpers, copied.

The reference is single-controller: one process drives every device of a
mesh. So is the port: one process drives every rank of a grid, and a
device may hold several ranks (``[torch.device("cuda:0")] * 4`` is four
ranks on one card). A rank's kernels touch only that rank's tensors; data
crosses between ranks only as copies between the ranks' pieces, so ranks
that share a card run the code that ranks on separate cards run.

The ops of this slice (``mp.matmul``, ``mp.overlap``, ``mp.pblas``) take 1D
grids; a 2D grid is built as the reference builds it, for ``mp.cyclic``,
and ``Grid.shard`` refuses it until then.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpumathlib_torch.core.errors import (
    ExecutionError, InvalidValueError, NotSupportedError, check)
from tpumathlib_torch.core.interop import from_numpy


def numroc(n: int, nb: int, iproc: int, nprocs: int, srcproc: int = 0) -> int:
    """Number of rows/cols of a block-cyclically distributed dimension owned
    by process ``iproc`` (ScaLAPACK NUMROC semantics; cuBLASMp/helpers.h:1384)."""
    dist = (nprocs + iproc - srcproc) % nprocs
    nblocks = n // nb
    mine = (nblocks // nprocs) * nb
    extra = nblocks % nprocs
    if dist < extra:
        mine += nb
    elif dist == extra:
        mine += n % nb
    return mine


def block_cyclic_spec(n: int, nb: int, nprocs: int):
    """Block-cyclic layout map for one dimension: returns (nblocks, owner,
    local_index) arrays — block b lives on rank b % nprocs at local block
    slot b // nprocs."""
    nblocks = -(-n // nb)
    owner = np.arange(nblocks) % nprocs
    local_slot = np.arange(nblocks) // nprocs
    return nblocks, owner, local_slot


def block_cyclic_to_global(a_local_blocks, n: int, nb: int, nprocs: int):
    """Reassemble a global dimension from per-rank block lists (host-side
    verification helper, ≙ the gather in cuBLASMp/matmul.h:303+)."""
    nblocks, owner, slot = block_cyclic_spec(n, nb, nprocs)
    parts = [a_local_blocks[owner[b]][slot[b]] for b in range(nblocks)]
    return np.concatenate(parts, axis=0)[:n]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A grid and a spec (≙ ``NamedSharding``)."""

    grid: "Grid"
    spec: tuple


class Sharded:
    """A global tensor held as one piece a rank (≙ a sharded ``jax.Array``).

    ``spec[d]`` names the grid axis that dimension d is split over, in equal
    parts in rank order, or is None where every rank holds the whole
    dimension. ``pieces[r]`` lies on ``grid.devices[r]``."""

    def __init__(self, grid: "Grid", pieces: list, spec: tuple, shape: tuple):
        self.grid, self.pieces, self.shape = grid, list(pieces), tuple(shape)
        self.spec = _full_spec(spec, len(self.shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (rank 0's by default), for checks."""
        device = self.grid.devices[0] if device is None else torch.device(device)
        dims = [d for d, a in enumerate(self.spec) if a is not None]
        if not dims:
            return self.pieces[0].to(device)
        return torch.cat([p.to(device) for p in self.pieces], dim=dims[0])


def _full_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    check(len(spec) <= ndim, f"spec {spec} names more dims than {ndim}")
    spec = spec + (None,) * (ndim - len(spec))
    check(sum(a is not None for a in spec) <= 1,
          f"spec {spec}: this slice splits at most one dimension", NotSupportedError)
    return spec


class Grid:
    """A process grid (≙ cublasMpGrid_t). ``devices`` is the list of ranks;
    a device may repeat. ``axes`` names the grid's axes: ``("x",)`` for a 1D
    grid, ``("x", "y")`` with ``nprow`` rows for a 2D one, whose rank (i, j)
    is ``devices[i * npcol + j]``."""

    def __init__(self, devices, axes: tuple = ("x",), layout: str = "col",
                 shape: tuple | None = None):
        self.devices = [torch.device(d) for d in devices]
        self.axes = tuple(axes)
        self.layout = layout   # grid rank ordering, parity only
        self.shape = dict(zip(self.axes, shape or (len(self.devices),)))

    @classmethod
    def create(cls, devices=None, nprow: int | None = None, npcol: int = 1,
               layout: str = "col") -> "Grid":
        """Every card (``torch.cuda.device_count()`` of them) unless
        ``devices`` is given; raises on a machine without a card."""
        if devices is None:
            count = torch.cuda.device_count()
            if count == 0:
                raise ExecutionError("Grid.create() takes every card, and there is none; "
                                     "pass devices to build a grid elsewhere")
            devices = [torch.device("cuda", i) for i in range(count)]
        n = len(devices)
        if nprow is None:
            nprow, npcol = n, 1
        check(nprow * npcol == n, f"a {nprow} x {npcol} grid over {n} devices")
        if npcol == 1:
            return cls(devices, ("x",), layout)
        return cls(devices, ("x", "y"), layout, (nprow, npcol))

    @property
    def nprow(self) -> int:
        return self.shape[self.axes[0]]

    @property
    def npcol(self) -> int:
        return self.shape[self.axes[1]] if len(self.axes) > 1 else 1

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis(self, axis: str | None) -> str:
        """The 1D grid's axis (``axis`` or the grid's first); raises
        NotSupportedError on a 2D grid, which waits for ``mp.cyclic``."""
        axis = axis or self.axes[0]
        if len(self.axes) != 1:
            raise NotSupportedError("the ops of mp.matmul, mp.overlap and mp.pblas take a "
                                    f"1D grid; this one is {self.nprow} x {self.npcol}")
        check(axis == self.axes[0], f"axis {axis!r} is not the grid's {self.axes[0]!r}")
        return axis

    def sharding(self, spec) -> Sharding:
        return Sharding(self, tuple(spec))

    def _range(self, spec: tuple, shape: tuple, rank: int) -> list:
        """The global index range (start, stop) of rank ``rank``'s piece, a dim."""
        out = []
        for a, n in zip(spec, shape):
            if a is None:
                out.append((0, n))
            else:
                part = n // self.size
                out.append((rank * part, (rank + 1) * part))
        return out

    def shard(self, x, spec) -> Sharded:
        """``x`` (numpy array, tensor or Sharded) split by ``spec`` over the
        ranks (≙ ``jax.device_put(x, NamedSharding(mesh, spec))``). A
        Sharded input is redistributed piece by piece (≙ ``gemr2d``). A split
        dimension must be a multiple of the grid's size."""
        self.axis(None)
        if isinstance(x, Sharded):
            check(x.grid is self, "a Sharded of another grid")
            src = x
        else:
            t = x if isinstance(x, torch.Tensor) else from_numpy(np.asarray(x))
            src = Sharded(self, [t] * self.size, (), t.shape)
        spec = _full_spec(spec, src.ndim)
        for a, n in zip(spec, src.shape):
            if a is not None:
                self.axis(a)
                if n % self.size:
                    raise InvalidValueError(
                        f"a dimension of {n} does not split over {self.size} ranks")
        if spec == src.spec and isinstance(x, Sharded):
            return x
        pieces = []
        for r, dev in enumerate(self.devices):
            want = self._range(spec, src.shape, r)
            piece = torch.empty([b - a for a, b in want], dtype=src.dtype, device=dev)
            # a replicated source is read from this rank's own piece only
            sources = range(self.size) if any(a is not None for a in src.spec) else (r,)
            for q in sources:
                have = self._range(src.spec, src.shape, q)
                lo = [max(a[0], b[0]) for a, b in zip(want, have)]
                hi = [min(a[1], b[1]) for a, b in zip(want, have)]
                if any(h <= l for l, h in zip(lo, hi)):
                    continue
                dst = piece[tuple(slice(l - w[0], h - w[0]) for l, h, w in zip(lo, hi, want))]
                dst.copy_(src.pieces[q][tuple(slice(l - v[0], h - v[0])
                                              for l, h, v in zip(lo, hi, have))])
            pieces.append(piece)
        return Sharded(self, pieces, spec, src.shape)
