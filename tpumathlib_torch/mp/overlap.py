"""Ring-overlapped AllGather+GEMM and GEMM+ReduceScatter: kernels B12a and
B12b (≙ cuBLASMp's NVSHMEM-backed matmul_ag / matmul_rs overlap).

Counterpart of ``tpumathlib/mp/overlap.py``, whose Pallas kernels copy the
ring's chunks between TPUs from inside the kernel, by remote DMA and
semaphores, while the MXU multiplies. On this card the copies run outside
the kernels, as stream-ordered copies between the ranks' buffers, and the
products and the accumulate stay in the repository's CUDA:
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
  that exit wait, so the caching allocator cannot hand it out early: the
  slots, and each rank's operands of its GEMMs (``_RankOperands``).

Race-freedom is the reference's slot map, kept as it is: every slot
receives one remote write over the whole call (one slot per originating
rank in the all-gather, one per ring step in the reduce-scatter), so a
neighbour running ahead never clobbers a slot still being read. Ranks
synchronise only through events; no kernel waits on another launch, so
ranks that share a card cannot hang it.

``_ring_gemm`` (a chunk times the rank's B, summed in f32, written in the
slot's dtype) and ``_ring_accumulate`` (``tml_ring_accumulate``, in
``csrc/mp_overlap.cu``: slot += partial in f32, or, at the last step, D =
slot + partial in D's dtype) launch on the current stream. The ring GEMM
runs on the tensor cores:
- f32 operands on the 3xTF32 kernel (``dx/tf32x3.py``,
  ``csrc/gemm_tf32x3.cu``): each rank's B piece is split into the TF32
  planes of Bᵀ once a call, on its compute stream before its first GEMM
  (``tml_split_tf32``); the kernel splits each A chunk in its registers,
  or, where k is not a multiple of 4, the chunk is split into planes just
  before its GEMM;
- bf16 operands on B1's bf16 TMA + wgmma kernel (``csrc/gemm_wgmma.cu``,
  launched by ``dx.gemm._Into.wgmma``, counted as B1's), B read N-major
  through wgmma's transpose bit, no split; an operand that route does not
  read in place (``dx.gemm._tc_reads``: a row stride of a multiple of 8
  elements) is copied once into a buffer whose row stride is.
The f32 ring writes f32 (its outputs and slots); the bf16 ring writes bf16
outputs and f32 slots.
On CPU tensors they take the plain versions, ``_ring_gemm_plain`` and
``_ring_accumulate_plain``, and the schedule runs in the same order with no
streams or events: every rank's send, then every rank's product, step by
step. Counts: ``matmul_ag_overlapped.launches`` and
``matmul_rs_overlapped.launches`` grow by P² ring GEMMs a call,
``.splits`` by the split passes of an f32 call (P, and P² more where k is
not a multiple of 4; none in bf16), and
``matmul_rs_overlapped.accumulates`` by P(P − 1).
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from tpumathlib_torch.core.dtypes import cdiv
from tpumathlib_torch.core.errors import NotSupportedError, check
from tpumathlib_torch.dx import cuda_utils, gemm, tf32x3
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.fft.kernels import _f32_products  # noqa: F401  (C16: patched by name)
from tpumathlib_torch.mp.grid import Grid, Sharded

F32, BF16 = torch.float32, torch.bfloat16
# dtype codes of csrc/mp_overlap.cu's outputs
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


def _padded(rows: int, cols: int, dtype, device):
    """A (rows, cols) buffer whose row stride is a multiple of 8 elements."""
    return torch.empty((rows, cdiv(max(cols, 1), 8) * 8), dtype=dtype, device=device)[:, :cols]


class _RankOperands:
    """One rank's operands of its P ring GEMMs in a call, allocated on the
    caller's stream before the ring starts and held until its exit wait:
    B as the kernel reads it, prepared once (``prepare``, on the rank's
    compute stream before its first GEMM), and the buffer each GEMM
    prepares its A chunk in (``load_a``). f32: the TF32 planes of Bᵀ (n, k),
    row stride padded to 16 bytes; the A chunks (row stride k) go to the
    kernel as they are, split in its registers, or, where TMA cannot read
    them (k not a multiple of 4), are split into planes of (rows, k). bf16: B
    itself where B1's kernel reads it in place, else a copy with a row
    stride of a multiple of 8; the same for the A chunks, whose row stride
    is k. On CPU tensors: B alone. ``count`` is the ring function whose
    ``.launches`` and ``.splits`` grow."""

    def __init__(self, b, rows: int, count):
        self.b, self.count, self.ready = b, count, False
        self.card = on_cuda(b)
        if not self.card:
            return
        if b.dtype not in (F32, BF16):
            raise NotSupportedError(f"ring GEMM of {b.dtype} operands; f32 or bf16 operands")
        self.b = b if b.stride(1) == 1 else b.contiguous()
        (k, n), dev = b.shape, b.device
        if b.dtype == F32:   # the launchers load the kernels: a failed build raises here
            self.tf32 = tf32x3.Tf32x3()
            self.bt = tf32x3.planes(n, k, dev)
            self.at = tf32x3.planes(rows, k, dev) if k % 4 else None
        else:
            self.wgmma = gemm._Into().wgmma
            self.bt = self.b if gemm._tc_reads(self.b) else _padded(k, n, BF16, dev)
            self.at = _padded(rows, k, BF16, dev) if k % 8 else None

    def stream(self) -> int:
        return torch.cuda.current_stream(self.b.device).cuda_stream

    def prepare(self) -> None:
        """B's planes (f32: one split pass, transposed) or its copy, on the
        current stream."""
        self.ready = True
        b = self.b
        if b.dtype == F32:
            self.tf32.split(self.stream(), (b.data_ptr(), b.stride(0)),
                            *tf32x3.plane_pair(self.bt), *b.shape, tf32x3.TRANSPOSE)
            self.count.splits += 1
        elif self.bt is not b:
            _stage(self.bt, b)

    def load_a(self, a):
        """A chunk as the kernel reads it: the chunk itself, its planes (f32,
        one split pass), or its copy (bf16)."""
        if a.dtype == F32 and tf32x3.tma_ready(a):
            return a
        if a.dtype == F32:
            check(self.at is not None, "an f32 ring chunk whose row stride TMA cannot take")
            at = self.at[:, :a.shape[0]]
            self.tf32.split(self.stream(), (a.data_ptr(), a.stride(0)), *tf32x3.plane_pair(at),
                            *a.shape)
            self.count.splits += 1
            return at
        if gemm._tc_reads(a):
            return a
        check(self.at is not None, "a bf16 ring chunk whose row stride TMA cannot take")
        at = self.at[:a.shape[0]]
        _stage(at, a)
        return at

    def gemm(self, a, out) -> None:
        """out = A·B, ``a`` from ``load_a``: one launch on the current
        stream."""
        (m, n), k = out.shape, self.b.shape[0]
        d = (out.data_ptr(), out.stride(0))
        if self.b.dtype == F32:
            self.tf32.gemm(self.stream(), m, n, k, d, tf32x3.plane_pair(a),
                           tf32x3.plane_pair(self.bt))
        else:
            self.wgmma(self.stream(), m, n, k, (*d, 1), (a.data_ptr(), a.stride(0), 1),
                       (self.bt.data_ptr(), self.bt.stride(0), 1), out_dtype=out.dtype)
        self.count.launches += 1


def _ring_gemm(a, ops: _RankOperands, out) -> None:
    """``out`` (a row block of a slot or of D, unit column stride) = a @ B,
    B the rank's (``ops``), summed in f32, on the current stream: B prepared
    at the rank's first GEMM of the call, then A's chunk, then the product."""
    if not ops.card:
        _ring_gemm_plain(a, ops.b, out)
        return
    if not (a.dtype == ops.b.dtype and out.dtype in (F32, a.dtype)):
        raise NotSupportedError(f"ring GEMM of {a.dtype} @ {ops.b.dtype} -> {out.dtype}; "
                                f"f32 operands into f32, bf16 into f32 or bf16")
    check(a.device == ops.b.device == out.device and a.stride(1) == out.stride(1) == 1
          and a.shape[1] == ops.b.shape[0] and out.shape == (a.shape[0], ops.b.shape[1]),
          "ring GEMM operands on one device, the chunk and the output with unit column stride")
    if not out.numel():
        return
    with torch.cuda.device(out.device):
        if not ops.ready:
            ops.prepare()
        ops.gemm(ops.load_a(a), out)


def _send(dst, src) -> None:
    """The ring's copy of a chunk or slot into the right neighbour's slot, on
    the current stream (the sender's comm stream)."""
    dst.copy_(src, non_blocking=True)


def _stage(dst, src) -> None:
    """A bf16 operand's copy into a buffer B1's kernel reads, on the current
    stream (the rank's compute stream)."""
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
    ops = [_RankOperands(bp, mloc, matmul_ag_overlapped) for bp in b.pieces]
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
                _ring_gemm(slots[r][c], ops[r], outs[r][c * mloc:(c + 1) * mloc])
        arrived = landed
    ring.exit()
    return Sharded(grid, outs, (None, axis), (m, b.shape[1]))


matmul_ag_overlapped.launches = 0
matmul_ag_overlapped.splits = 0


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
    ops = [_RankOperands(bp, sp, matmul_rs_overlapped) for bp in b.pieces]

    def rows(r: int, c: int):
        return a.pieces[r][c * sp:(c + 1) * sp]

    ring.enter()
    filled = [None] * nr   # the event after which slot `step` of rank r is whole
    for r in range(nr):
        with ring.on(r, COMPUTE):
            _ring_gemm(rows(r, (r - 1) % nr), ops[r], slots[r][0] if nr > 1 else outs[r])
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
                _ring_gemm(rows(r, (r - step - 2) % nr), ops[r], mine[r])
                ring.wait(r, COMPUTE, landed[r])
                last = step == nr - 2
                _ring_accumulate(mine[r], slots[r][step + 1], outs[r] if last else None)
                filled[r] = None if last else ring.record(r, COMPUTE)
    ring.exit()
    return Sharded(grid, outs, (axis, None), (m, h))


matmul_rs_overlapped.launches = 0
matmul_rs_overlapped.splits = 0
matmul_rs_overlapped.accumulates = 0
