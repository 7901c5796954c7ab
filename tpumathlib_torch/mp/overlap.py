"""Ring-overlapped AllGather+GEMM and GEMM+ReduceScatter: kernels B12a and
B12b (≙ cuBLASMp's NVSHMEM-backed matmul_ag / matmul_rs overlap).

Counterpart of ``tpumathlib/mp/overlap.py``, whose Pallas kernels copy the
ring's chunks between TPUs from inside the kernel, by remote DMA and
semaphores, while the MXU multiplies. On this card the copies run outside
the kernels, as stream-ordered copies between the ranks' buffers, and the
products and the accumulate stay in the repository's CUDA
(``csrc/mp_overlap.cu``):
- each rank has a compute stream and a comm stream on its device, made
  once per ``Grid`` and kept;
- a chunk's copy to the right neighbour runs on the sender's comm stream;
  an event recorded after it stands for the reference's ``recv_sem``, and
  the receiver's streams wait on it before they read the slot;
- a sender's comm stream waits, before it sends a slot, for whatever filled
  it: the copy that brought the chunk (B12a), or its own compute stream's
  accumulate (B12b);
- on entry every side stream waits for the caller's current stream, and
  on exit the caller's stream waits for every side stream. Every buffer is
  allocated on the caller's stream before the ring starts and held until
  that exit wait, so the caching allocator cannot hand it out early.

Race-freedom is the reference's slot map, kept as it is: every slot
receives one remote write over the whole call (one slot per originating
rank in the all-gather, one per ring step in the reduce-scatter), so a
neighbour running ahead never clobbers a slot still being read. Ranks
synchronise only through events; no kernel waits on another launch, so
ranks that share a card cannot hang it.

``_ring_gemm`` (``tml_ring_gemm``: a chunk times B, summed in f32, written
in the slot's dtype) and ``_ring_accumulate`` (``tml_ring_accumulate``:
slot += partial in f32, or, at the last step, D = slot + partial in D's
dtype) launch on the current stream. On CPU tensors they take the plain
versions, ``_ring_gemm_plain`` and ``_ring_accumulate_plain``, and the
schedule runs in the same order with no streams or events: every rank's
send, then every rank's product, step by step. Counts:
``matmul_ag_overlapped.launches`` and ``matmul_rs_overlapped.launches`` grow
by P² ring GEMMs a call, ``matmul_rs_overlapped.accumulates`` by P(P − 1).
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from tpumathlib_torch.core.errors import NotSupportedError, check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.fft.kernels import _f32_products  # noqa: F401  (C16: patched by name)
from tpumathlib_torch.mp.grid import Grid, Sharded

F32, BF16 = torch.float32, torch.bfloat16
# dtype codes of csrc/mp_overlap.cu, for operands and outputs
_CODE = {F32: 0, BF16: 1}
COMPUTE, COMM = 0, 1
# each grid's (compute, comm) streams a rank, made at the grid's first ring
_STREAMS: "weakref.WeakKeyDictionary[Grid, list]" = weakref.WeakKeyDictionary()


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _ring_gemm_plain(a, b, out) -> None:
    """The ring GEMM's plain version: ``out = a @ b`` in f32, in out's dtype."""
    with _f32_products():
        out.copy_(torch.matmul(a.to(F32), b.to(F32)))


def _ring_gemm(a, b, out, count) -> None:
    """``out`` (a row block of a slot or of D, unit column stride) = a @ b,
    summed in f32, through ``tml_ring_gemm`` on the current stream;
    ``count.launches`` grows by one a launch."""
    if not on_cuda(a, b, out):
        _ring_gemm_plain(a, b, out)
        return
    if not (a.dtype == b.dtype and a.dtype in _CODE and out.dtype in _CODE):
        raise NotSupportedError(f"ring GEMM of {a.dtype} @ {b.dtype} -> {out.dtype}; "
                                f"operands and output of {list(_CODE)}")
    check(a.device == b.device == out.device and out.stride(1) == 1,
          "ring GEMM operands on one device, the output with unit column stride")
    a = a if a.stride(1) == 1 else a.contiguous()
    b = b if b.stride(1) == 1 else b.contiguous()
    (m, k), n = a.shape, b.shape[1]
    if not (m and n):
        return
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(out.device):
        rc = lib.tml_ring_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                               a.stride(0), b.stride(0), out.stride(0), _CODE[a.dtype],
                               _CODE[out.dtype], torch.cuda.current_stream(out.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, "tml_ring_gemm")
    count.launches += 1


def _send(dst, src) -> None:
    """The ring's copy of a chunk or slot into the right neighbour's slot, on
    the current stream (the sender's comm stream)."""
    dst.copy_(src, non_blocking=True)


def _ring_accumulate_plain(partial, slot, d=None) -> None:
    """slot += partial, or d = slot + partial in d's dtype."""
    if d is None:
        slot.add_(partial)
    else:
        d.copy_(slot + partial)


def _ring_accumulate(partial, slot, d=None) -> None:
    """B12b's accumulate through ``tml_ring_accumulate`` on the current
    stream: f32 ``partial`` into the f32 ``slot``, or, with ``d``, D = slot +
    partial in D's dtype (all three contiguous and of one shape)."""
    if not on_cuda(partial, slot, d):
        _ring_accumulate_plain(partial, slot, d)
        return
    out = slot if d is None else d
    if not (partial.dtype == slot.dtype == F32 and out.dtype in _CODE):
        raise NotSupportedError(f"ring accumulate into {out.dtype}; f32 slots, "
                                f"output of {list(_CODE)}")
    check(all(t.is_contiguous() and t.shape == slot.shape and t.device == slot.device
              for t in (partial, slot, out)), "ring accumulate operands contiguous, one shape")
    if not slot.numel():
        return
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(slot.device):
        rc = lib.tml_ring_accumulate(partial.data_ptr(), slot.data_ptr(),
                                     None if d is None else d.data_ptr(), slot.numel(),
                                     _CODE[out.dtype],
                                     torch.cuda.current_stream(slot.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, "tml_ring_accumulate")
    matmul_rs_overlapped.accumulates += 1


class _Ring:
    """Each rank's compute and comm streams and the events between them; on
    CPU ranks every call is a no-op and the schedule runs in issue order."""

    def __init__(self, grid: Grid):
        card = [_on_card(d) for d in grid.devices]
        check(all(card) or not any(card), "a grid of CUDA and CPU ranks")
        self.devices, self.streams = grid.devices, None
        if card[0]:
            if grid not in _STREAMS:
                _STREAMS[grid] = [(torch.cuda.Stream(device=d), torch.cuda.Stream(device=d))
                                  for d in grid.devices]
            self.streams = _STREAMS[grid]

    def on(self, rank: int, which: int):
        """The rank's compute or comm stream as the current stream."""
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[rank][which])

    def record(self, rank: int, which: int):
        if self.streams is None:
            return None
        event = torch.cuda.Event()
        event.record(self.streams[rank][which])
        return event

    def wait(self, rank: int, which: int, event) -> None:
        if event is not None:
            self.streams[rank][which].wait_event(event)

    def enter(self) -> None:
        if self.streams is not None:
            for dev, pair in zip(self.devices, self.streams):
                for s in pair:
                    s.wait_stream(torch.cuda.current_stream(dev))

    def exit(self) -> None:
        if self.streams is not None:
            for dev, pair in zip(self.devices, self.streams):
                caller = torch.cuda.current_stream(dev)
                for s in pair:
                    caller.wait_stream(s)


def matmul_ag_overlapped(a, b, grid: Grid, axis: str | None = None) -> Sharded:
    """D = all_gather(A) @ B with the gather overlapped on a ring.

    A: (axis, None) (row chunks), B: (None, axis) (column chunks) →
    D: (None, axis), in A's dtype — the contract of mp.matmul.matmul_ag.
    At step s rank r sends the chunk of rank (r − s) mod P that it holds to
    its right neighbour and multiplies it by its B while the copy runs."""
    axis = grid.axis(axis)
    a, b = grid.shard(a, (axis, None)), grid.shard(b, (None, axis))
    nr, (m, k) = grid.size, a.shape
    mloc = m // nr
    ring = _Ring(grid)
    # slots[r][c]: rank c's chunk on rank r. Rank r's own is its input
    # piece; every other is written once, by the left neighbour's copy.
    slots = [[a.pieces[r] if c == r else torch.empty((mloc, k), dtype=a.dtype, device=dev)
              for c in range(nr)] for r, dev in enumerate(grid.devices)]
    outs = [torch.empty((m, bp.shape[1]), dtype=a.dtype, device=dev)
            for bp, dev in zip(b.pieces, grid.devices)]
    arrived = [None] * nr   # the event after which the chunk in hand is in its slot
    ring.enter()
    for step in range(nr):
        held = [(r - step) % nr for r in range(nr)]
        landed = [None] * nr
        if step < nr - 1:
            for r in range(nr):
                right, c = (r + 1) % nr, held[r]
                with ring.on(r, COMM):
                    ring.wait(r, COMM, arrived[r])
                    _send(slots[right][c], slots[r][c])
                    landed[right] = ring.record(r, COMM)
        for r in range(nr):
            c = held[r]
            with ring.on(r, COMPUTE):
                ring.wait(r, COMPUTE, arrived[r])
                _ring_gemm(slots[r][c], b.pieces[r], outs[r][c * mloc:(c + 1) * mloc],
                           matmul_ag_overlapped)
        arrived = landed
    ring.exit()
    return Sharded(grid, outs, (None, axis), (m, b.shape[1]))


matmul_ag_overlapped.launches = 0


def matmul_rs_overlapped(a, b, grid: Grid, axis: str | None = None) -> Sharded:
    """D = reduce_scatter(A @ B) with the reduction overlapped on a ring.

    A: (None, axis) (column chunks), B: (axis, None) (row chunks) →
    D: (axis, None), sp = m / P rows a rank, in A's dtype — the contract of
    mp.matmul.matmul_rs. Slot 0 holds the partial product of chunk
    (r − 1) mod P; at step s rank r sends slot s to its right neighbour's
    slot s + 1 and, while the copy runs, multiplies chunk (r − s − 2) mod P,
    which it adds into its own slot s + 1 once the left neighbour's copy
    has landed there. The last step's add writes D."""
    axis = grid.axis(axis)
    a, b = grid.shard(a, (None, axis)), grid.shard(b, (axis, None))
    nr, m, h = grid.size, a.shape[0], b.shape[1]
    check(m % nr == 0, f"a dimension of {m} does not split over {nr} ranks")
    sp = m // nr
    ring = _Ring(grid)
    outs = [torch.empty((sp, h), dtype=a.dtype, device=dev) for dev in grid.devices]
    # slots[r][s]: written once by the left neighbour's step s − 1 copy
    # (slot 0 by rank r's first product), then by rank r's own accumulate
    slots = [torch.empty((nr, sp, h), dtype=F32, device=dev) if nr > 1 else None
             for dev in grid.devices]
    mine = [torch.empty((sp, h), dtype=F32, device=dev) if nr > 1 else None
            for dev in grid.devices]

    def rows(r: int, c: int):
        return a.pieces[r][c * sp:(c + 1) * sp]

    ring.enter()
    filled = [None] * nr   # the event after which slot `step` of rank r is whole
    for r in range(nr):
        with ring.on(r, COMPUTE):
            _ring_gemm(rows(r, (r - 1) % nr), b.pieces[r], slots[r][0] if nr > 1 else outs[r],
                       matmul_rs_overlapped)
            filled[r] = ring.record(r, COMPUTE)
    for step in range(nr - 1):
        landed = [None] * nr
        for r in range(nr):
            right = (r + 1) % nr
            with ring.on(r, COMM):
                ring.wait(r, COMM, filled[r])
                _send(slots[right][step + 1], slots[r][step])
                landed[right] = ring.record(r, COMM)
        for r in range(nr):
            with ring.on(r, COMPUTE):
                _ring_gemm(rows(r, (r - step - 2) % nr), b.pieces[r], mine[r],
                           matmul_rs_overlapped)
                ring.wait(r, COMPUTE, landed[r])
                last = step == nr - 2
                _ring_accumulate(mine[r], slots[r][step + 1], outs[r] if last else None)
                filled[r] = None if last else ring.record(r, COMPUTE)
    ring.exit()
    return Sharded(grid, outs, (axis, None), (m, h))


matmul_rs_overlapped.launches = 0
matmul_rs_overlapped.accumulates = 0
