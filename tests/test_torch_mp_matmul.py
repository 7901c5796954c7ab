"""Parity of tpumathlib_torch.mp (grid, matmul, overlap: kernels B12a and
B12b) with the reference on the CPU.

The reference runs on the 8-device virtual CPU mesh of tests/conftest.py
(its overlapped Pallas kernels in interpret mode, as its own tests run
them); the port on ``Grid.create([torch.device("cpu")] * 8)``, eight CPU
ranks, where the ring wrappers take their plain versions. Both get the same
seeded numpy inputs at the reference tests' shapes (S, H, F = 64, 32, 128)
and are held to each other and to numpy at the reference tests' rtol 1e-4,
max-scaled (core.check.allclose); gemr2d and the ring's chunk identity are
exact.

Ring-specific: P ∈ {1, 2, 3, 8}; a "chunk identity" input whose result
shows any misplaced slot exactly; a split dimension not divisible by P
raises. The CUDA branch of both rings runs against ``_EmulatedLib`` (the GEMM
test's emulation, with B1's bf16 kernel, plus the 3xTF32 split and product
of tests/test_torch_tf32x3.py and tml_ring_accumulate) under
``_DeferredCuda``, a CPU stand-in for streams and events that holds every
launch, copy, record and wait in its stream's queue and runs the queues in a
random interleaving that keeps only stream order and event waits: the
results equal the plain versions under every interleaving tried, every
waited event was recorded first, the caller's stream waits for every side
stream last, and the counts grow by P² ring GEMMs, the split passes (f32:
B once a rank, transposed, and each A chunk where k is not a multiple of 4;
else the kernel splits A in its registers) and P(P − 1) accumulates a
call. With the waits dropped the same harness sees wrong results, so it can
see a race.
"""

import contextlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpumathlib.mp import Grid as RefGrid
from tpumathlib.mp import block_cyclic_spec as ref_block_cyclic_spec
from tpumathlib.mp import matmul_ag as ref_matmul_ag
from tpumathlib.mp import matmul_allreduce as ref_matmul_allreduce
from tpumathlib.mp import matmul_rs as ref_matmul_rs
from tpumathlib.mp import numroc as ref_numroc
from tpumathlib.mp import tp_matmul as ref_tp_matmul
from tpumathlib.mp.grid import block_cyclic_to_global as ref_block_cyclic_to_global
from tpumathlib.mp.matmul import gemr2d as ref_gemr2d
from tpumathlib.mp.overlap import matmul_ag_overlapped as ref_ag_overlapped
from tpumathlib.mp.overlap import matmul_rs_overlapped as ref_rs_overlapped
from tpumathlib_torch import mp
from tpumathlib_torch.core.check import assert_allclose
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError, NotSupportedError
from tpumathlib_torch.dx import cuda_utils, gemm, tf32x3
from tpumathlib_torch.entry import dryrun_multichip
from tpumathlib_torch.mp import grid as port_grid
from tpumathlib_torch.mp import overlap
from tpumathlib_torch.mp.matmul import gemr2d
from test_torch_dx_gemm import _EmulatedLib as _EmulatedGemmLib
from test_torch_dx_gemm import _view

torch.set_num_threads(1)

S, H, F = 64, 32, 128   # seq, hidden, ffn: tests/test_mp_matmul.py's shapes
RTOL = 1e-4             # tests/test_mp_matmul.py's rtol, max-scaled
CPU = torch.device("cpu")
SPECS = [("x", None), (None, "x"), (None, None)]


@pytest.fixture(scope="module")
def ref_grid():
    return RefGrid.create(jax.devices())


@pytest.fixture(scope="module")
def grid():
    return mp.Grid.create([CPU] * 8)


@pytest.fixture
def data(rng):
    x = rng.normal(size=(S, H)).astype(np.float32)
    w1 = rng.normal(size=(H, F)).astype(np.float32) / np.sqrt(H)
    w2 = rng.normal(size=(F, H)).astype(np.float32) / np.sqrt(F)
    return x, w1, w2


@pytest.fixture
def rs_data():
    a = np.random.default_rng(7).normal(size=(S, F)).astype(np.float32)
    b = np.random.default_rng(8).normal(size=(F, H)).astype(np.float32)
    return a, b


def _put(ref_grid, arr, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(ref_grid.mesh, P(*spec)))


def _gelu(x):
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x**3)))


def _agree(got, ref_out, want, msg):
    """The port's result against the reference's and against numpy float64,
    both at RTOL."""
    full = got.full()
    assert_allclose(full, np.asarray(ref_out), rtol=RTOL, msg=f"{msg} vs reference")
    assert_allclose(full, want, rtol=RTOL, msg=f"{msg} vs float64")


def _pieces_match_shards(got, ref_out):
    """Rank r's piece is the reference's shard on mesh device r."""
    shards = {s.device: np.asarray(s.data) for s in ref_out.addressable_shards}
    for piece, dev in zip(got.pieces, ref_out.sharding.mesh.devices.flat):
        np.testing.assert_array_equal(piece.numpy(), shards[dev])


# --- the collective path (mp.matmul) ------------------------------------------

def test_matmul_ag(ref_grid, grid, data):
    x, w1, _ = data
    ref_out = ref_matmul_ag(_put(ref_grid, x, ("x", None)), _put(ref_grid, w1, (None, "x")),
                            ref_grid)
    got = mp.matmul_ag(grid.shard(x, ("x", None)), grid.shard(w1, (None, "x")), grid)
    assert got.spec == (None, "x") and got.shape == (S, F)
    _agree(got, ref_out, x.astype(np.float64) @ w1, "AG+GEMM")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_matmul_ag_bias_epilogue(ref_grid, grid, data, rng, use_pallas):
    """relu_bias through torch.matmul and through B1's plain version; the
    reference's collective route (use_pallas=False) is the yardstick."""
    x, w1, _ = data
    bias = rng.normal(size=F).astype(np.float32)
    ref_out = ref_matmul_ag(_put(ref_grid, x, ("x", None)), _put(ref_grid, w1, (None, "x")),
                            ref_grid, epilogue="relu_bias", bias=_put(ref_grid, bias, ("x",)))
    got = mp.matmul_ag(x, w1, grid, epilogue="relu_bias", bias=bias, use_pallas=use_pallas)
    _agree(got, ref_out, np.maximum(x.astype(np.float64) @ w1 + bias, 0), "AG+GEMM relu_bias")


def test_matmul_rs(ref_grid, grid, rs_data):
    a, b = rs_data
    ref_out = ref_matmul_rs(_put(ref_grid, a, (None, "x")), _put(ref_grid, b, ("x", None)),
                            ref_grid)
    got = mp.matmul_rs(grid.shard(a, (None, "x")), grid.shard(b, ("x", None)), grid)
    assert got.spec == ("x", None) and ref_out.sharding.spec == P("x", None)
    _agree(got, ref_out, a.astype(np.float64) @ b, "GEMM+RS")


def test_matmul_allreduce(ref_grid, grid, rs_data):
    a, b = rs_data
    ref_out = ref_matmul_allreduce(_put(ref_grid, a, (None, "x")),
                                   _put(ref_grid, b, ("x", None)), ref_grid)
    got = mp.matmul_allreduce(a, b, grid)
    assert got.spec == (None, None)
    _agree(got, ref_out, a.astype(np.float64) @ b, "GEMM+AR")
    for piece in got.pieces[1:]:   # replicated: every rank holds the same sum
        assert torch.equal(piece, got.pieces[0])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tp_matmul_cycle(ref_grid, grid, data, use_pallas):
    """The full TP-MLP cycle, the GELU fused into the AG phase's product
    (torch.matmul, or B1's plain version)."""
    x, w1, w2 = data
    ref_out = jax.jit(lambda x, a, b: ref_tp_matmul(x, a, b, ref_grid, epilogue="gelu"))(
        _put(ref_grid, x, ("x", None)), _put(ref_grid, w1, (None, "x")),
        _put(ref_grid, w2, ("x", None)))
    got = mp.tp_matmul(grid.shard(x, ("x", None)), grid.shard(w1, (None, "x")),
                       grid.shard(w2, ("x", None)), grid, epilogue="gelu",
                       use_pallas=use_pallas)
    assert got.spec == ("x", None)
    _agree(got, ref_out, _gelu(x.astype(np.float64) @ w1) @ w2, "tp_matmul")


@pytest.mark.parametrize("src", SPECS)
@pytest.mark.parametrize("dst", SPECS)
def test_gemr2d(ref_grid, grid, data, src, dst):
    """Every redistribution among the slice's specs is exact, and each rank's
    piece is the reference's shard on the same mesh device."""
    x, _, _ = data
    ref_out = ref_gemr2d(_put(ref_grid, x, src), NamedSharding(ref_grid.mesh, P(*dst)))
    got = gemr2d(grid.shard(x, src), grid.sharding(dst))
    assert got.spec == dst and got.shape == x.shape
    np.testing.assert_array_equal(got.full().numpy(), x)
    _pieces_match_shards(got, ref_out)


def test_operands_are_resharded_to_the_in_specs(ref_grid, grid, data):
    """An operand with another spec (or none) is resharded first, as
    shard_map does: the result does not depend on how it came."""
    x, w1, _ = data
    want = mp.matmul_ag(grid.shard(x, ("x", None)), grid.shard(w1, (None, "x")), grid).full()
    for xs, ws in ((x, w1), (grid.shard(x, (None, "x")), grid.shard(w1, ("x", None))),
                   (torch.from_numpy(x), grid.shard(w1, (None, None)))):
        assert torch.equal(mp.matmul_ag(xs, ws, grid).full(), want)


def test_numroc():
    # ScaLAPACK reference values, as tests/test_mp_matmul.py::test_numroc
    assert [mp.numroc(10, 3, p, 4) for p in range(4)] == [3, 3, 3, 1]
    assert [mp.numroc(10, 2, p, 2) for p in range(2)] == [6, 4]
    assert sum(mp.numroc(1000, 32, p, 8) for p in range(8)) == 1000
    for n, nb, nprocs, src in ((10, 3, 4, 0), (1000, 32, 8, 3), (7, 8, 3, 1), (257, 16, 5, 2)):
        for p in range(nprocs):
            assert mp.numroc(n, nb, p, nprocs, src) == ref_numroc(n, nb, p, nprocs, src)


@pytest.mark.parametrize("n,nb,nprocs", [(10, 3, 4), (1000, 32, 8), (7, 8, 3)])
def test_block_cyclic_helpers(rng, n, nb, nprocs):
    got, want = mp.block_cyclic_spec(n, nb, nprocs), ref_block_cyclic_spec(n, nb, nprocs)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    x = rng.normal(size=(n,))
    nblocks, owner, slot = got
    blocks = [[None] * (nblocks // nprocs + 1) for _ in range(nprocs)]
    for blk in range(nblocks):
        blocks[owner[blk]][slot[blk]] = x[blk * nb:(blk + 1) * nb]
    back = port_grid.block_cyclic_to_global(blocks, n, nb, nprocs)
    np.testing.assert_array_equal(back, ref_block_cyclic_to_global(blocks, n, nb, nprocs))
    np.testing.assert_array_equal(back, x)


def test_grid_shapes_and_2d_refusal():
    g = mp.Grid.create([CPU] * 8, nprow=4, npcol=2)
    assert (g.axes, g.nprow, g.npcol, g.size) == (("x", "y"), 4, 2, 8)
    with pytest.raises(NotSupportedError, match="1D grid"):
        mp.matmul_ag(np.ones((8, 4), np.float32), np.ones((4, 8), np.float32), g)
    with pytest.raises(NotSupportedError):
        overlap.matmul_rs_overlapped(np.ones((8, 8), np.float32), np.ones((8, 4), np.float32), g)
    with pytest.raises(InvalidValueError):
        mp.Grid.create([CPU] * 8, nprow=3, npcol=2)


def test_grid_create_takes_the_cards_and_raises_without_one():
    """With no devices, Grid.create takes every card (jax.devices()'s
    counterpart); on a machine without one it raises, never building a CPU
    grid quietly."""
    assert torch.cuda.device_count() == 0
    with pytest.raises(ExecutionError, match="there is none"):
        mp.Grid.create()


# --- the overlapped rings (mp.overlap: B12a, B12b) -------------------------------

def test_matmul_ag_overlapped(ref_grid, grid, data):
    """The ring AG+GEMM against the reference's Pallas kernel in interpret
    mode and numpy."""
    x, w1, _ = data
    ref_out = ref_ag_overlapped(_put(ref_grid, x, ("x", None)), _put(ref_grid, w1, (None, "x")),
                                ref_grid)
    got = overlap.matmul_ag_overlapped(grid.shard(x, ("x", None)), grid.shard(w1, (None, "x")),
                                       grid)
    assert got.spec == (None, "x") and ref_out.sharding.spec == P(None, "x")
    _agree(got, ref_out, x.astype(np.float64) @ w1, "overlapped AG+GEMM")


def test_matmul_rs_overlapped(ref_grid, grid, rs_data):
    a, b = rs_data
    ref_out = ref_rs_overlapped(_put(ref_grid, a, (None, "x")), _put(ref_grid, b, ("x", None)),
                                ref_grid)
    got = overlap.matmul_rs_overlapped(grid.shard(a, (None, "x")), grid.shard(b, ("x", None)),
                                       grid)
    assert got.spec == ("x", None) and ref_out.sharding.spec in (P("x", None), P("x"))
    _agree(got, ref_out, a.astype(np.float64) @ b, "overlapped GEMM+RS")


def _ag_identity(nr, mloc=3, k=5, n_per=2):
    """A whose chunk c (rank c's rows) holds c + 1, B = ones: D's row block c
    is exactly (c + 1)·k, so a chunk in the wrong slot shows."""
    a = np.repeat(np.arange(1, nr + 1, dtype=np.float32), mloc)[:, None] * np.ones((1, k),
                                                                                    np.float32)
    b = np.ones((k, n_per * nr), np.float32)
    return a, b, a.astype(np.float64) @ b


def _rs_identity(nr, sp=3, kloc=2, h=4):
    """A whose row chunk c times rank q's column block is (c + 1)·2^q, B =
    ones: D's rows of chunk c are (c + 1)·(2^P − 1)·kloc exactly, so a
    partial of the wrong chunk, or a rank's partial lost or added twice,
    shows."""
    rows = np.repeat(np.arange(1, nr + 1, dtype=np.float32), sp)[:, None]
    cols = np.repeat(2.0 ** np.arange(nr, dtype=np.float32), kloc)[None, :]
    a, b = rows * cols, np.ones((kloc * nr, h), np.float32)
    return a, b, a.astype(np.float64) @ b


@pytest.mark.parametrize("nr", [1, 2, 3, 8])
def test_ring_chunk_identity(nr):
    g = mp.Grid.create([CPU] * nr)
    a, b, want = _ag_identity(nr)
    got = overlap.matmul_ag_overlapped(a, b, g)
    np.testing.assert_array_equal(got.full().numpy(), want)
    a, b, want = _rs_identity(nr)
    got = overlap.matmul_rs_overlapped(a, b, g)
    np.testing.assert_array_equal(got.full().numpy(), want)


@pytest.mark.parametrize("nr", [1, 2, 3, 8])
def test_rings_match_the_collective_path(nr):
    """Both rings against the collective routes and float64 at P ranks, on
    ragged widths."""
    g = mp.Grid.create([CPU] * nr)
    gen = np.random.default_rng(nr)
    a = gen.normal(size=(4 * nr, 7)).astype(np.float32)
    b = gen.normal(size=(7, 3 * nr)).astype(np.float32)
    got = overlap.matmul_ag_overlapped(a, b, g)
    assert got.spec == (None, "x")
    assert_allclose(got.full(), a.astype(np.float64) @ b, rtol=RTOL)
    assert_allclose(got.full(), mp.matmul_ag(a, b, g).full(), rtol=RTOL)
    a = gen.normal(size=(2 * nr, 5 * nr)).astype(np.float32)
    b = gen.normal(size=(5 * nr, 6)).astype(np.float32)
    got = overlap.matmul_rs_overlapped(a, b, g)
    assert got.spec == ("x", None)
    assert_allclose(got.full(), a.astype(np.float64) @ b, rtol=RTOL)
    assert_allclose(got.full(), mp.matmul_rs(a, b, g).full(), rtol=RTOL)


def test_ring_refuses_indivisible_dims():
    """m (and B's sharded dimension) must split over the ranks; the
    reference fails inside shard_map, the port raises InvalidValueError."""
    g = mp.Grid.create([CPU] * 3)
    with pytest.raises(InvalidValueError, match="does not split"):
        overlap.matmul_ag_overlapped(np.ones((7, 4), np.float32), np.ones((4, 6), np.float32), g)
    with pytest.raises(InvalidValueError, match="does not split"):
        overlap.matmul_ag_overlapped(np.ones((6, 4), np.float32), np.ones((4, 5), np.float32), g)
    with pytest.raises(InvalidValueError, match="does not split"):
        overlap.matmul_rs_overlapped(np.ones((7, 6), np.float32), np.ones((6, 4), np.float32), g)


def test_cpu_ring_launches_nothing():
    before = (overlap.matmul_ag_overlapped.launches, overlap.matmul_rs_overlapped.launches,
              overlap.matmul_rs_overlapped.accumulates)
    g = mp.Grid.create([CPU] * 2)
    overlap.matmul_ag_overlapped(np.ones((4, 4), np.float32), np.ones((4, 4), np.float32), g)
    overlap.matmul_rs_overlapped(np.ones((4, 4), np.float32), np.ones((4, 4), np.float32), g)
    assert before == (overlap.matmul_ag_overlapped.launches,
                      overlap.matmul_rs_overlapped.launches,
                      overlap.matmul_rs_overlapped.accumulates)


def test_dryrun_multichip_on_cpu_ranks():
    """entry.dryrun_multichip's TP-MLP cycle and reshard on 8 CPU ranks, on
    B1's plain version (its own check is rtol 1e-4)."""
    run = dryrun_multichip(8, [CPU] * 8)
    assert run["out"].spec == ("x", None) and run["resharded"].spec == (None, "x")
    assert run["max_scaled_err"] <= RTOL


# --- the CUDA branch, emulated ------------------------------------------------------

_CODE_DTYPE = {v: k for k, v in overlap._CODE.items()}


class _EmulatedLib(_EmulatedGemmLib):
    """tml_ring_accumulate computed on the CPU from its raw arguments,
    beside the GEMM's emulation (B1's bf16 kernel) and the 3xTF32 split and
    product's."""

    def tml_ring_accumulate(self, partial, slot, d, count, d_code, stream):
        self.calls.append(dict(kind="ring_accumulate", count=count, d=bool(d), stream=stream))
        q = _view(partial, torch.float32, (count,), (1,))
        s = _view(slot, torch.float32, (count,), (1,))
        if d:
            _view(d, _CODE_DTYPE[d_code], (count,), (1,)).copy_(s + q)
        else:
            s.add_(q)
        return 0


class _Event:
    def __init__(self, cuda):
        self.cuda, self.ticket = cuda, None

    def record(self, stream=None):
        stream = stream or self.cuda.current()
        self.ticket = object()
        stream.queue.append(("record", self.ticket))


class _Stream:
    def __init__(self, cuda, name):
        self.cuda, self.name, self.queue, self.done = cuda, name, [], 0
        self.cuda_stream = len(cuda.streams) + 1
        cuda.streams[self.cuda_stream] = self

    def wait_event(self, event):
        if event.ticket is None:
            self.cuda.errors.append(f"{self.name} waits on an event never recorded")
        self.queue.append(("wait", event.ticket))

    def wait_stream(self, other):
        event = _Event(self.cuda)
        event.record(other)
        if self.name == "caller" and other.name != "caller":
            self.cuda.exit_waits[other] = len(other.queue)
            self.cuda.drain()
        self.wait_event(event)


class _DeferredCuda:
    """Streams and events on the CPU that defer the work (see the module
    docstring). ``drain`` runs the queues in a random interleaving, seeded;
    it runs when the caller's stream first waits on a side stream (the
    rings' exit), while the rings' buffers are still alive."""

    def __init__(self, seed):
        self.rng, self.streams, self.stack = random.Random(seed), {}, []
        self.errors, self.exit_waits, self.fired = [], {}, set()
        self.caller = _Stream(self, "caller")

    def current(self):
        return self.stack[-1] if self.stack else self.caller

    @contextlib.contextmanager
    def stream(self, s):
        self.stack.append(s)
        try:
            yield
        finally:
            self.stack.pop()

    def defer(self, fn):
        self.current().queue.append(("op", fn))

    def drain(self):
        def runnable(s):
            kind, what = s.queue[s.done]
            return kind != "wait" or what is None or what in self.fired

        while True:
            live = [s for s in self.streams.values() if s.done < len(s.queue)]
            if not live:
                return
            ready = [s for s in live if runnable(s)]
            if not ready:
                self.errors.append("no stream can run: a wait on an event recorded later")
                return
            s = self.rng.choice(ready)
            kind, what = s.queue[s.done]
            s.done += 1
            if kind == "op":
                what()
            elif kind == "record":
                self.fired.add(what)


class _DeferredLib(_EmulatedLib):
    """The emulation, deferred to the queue of the stream each launch names;
    a launch the emulation refuses when it runs is an error."""

    def __init__(self, cuda):
        super().__init__()
        self.cuda = cuda

    def _defer(self, entry, args):
        def run():
            if entry(self, *args):
                self.cuda.errors.append(f"{entry.__name__} refused its arguments")
        self.cuda.streams[args[-1]].queue.append(("op", run))
        return 0

    def tml_split_tf32(self, *args):
        return self._defer(_EmulatedLib.tml_split_tf32, args)

    def tml_gemm_tf32x3(self, *args):
        return self._defer(_EmulatedLib.tml_gemm_tf32x3, args)

    def tml_gemm_wgmma(self, *args):
        return self._defer(_EmulatedLib.tml_gemm_wgmma, args)

    def tml_ring_accumulate(self, *args):
        return self._defer(_EmulatedLib.tml_ring_accumulate, args)


@pytest.fixture
def deferred(monkeypatch):
    """Install a ``_DeferredCuda`` of the given seed; returns its maker."""
    def make(seed):
        cuda = _DeferredCuda(seed)
        lib = _DeferredLib(cuda)
        monkeypatch.setattr(overlap, "on_cuda", lambda *t: True)
        monkeypatch.setattr(overlap, "_on_card", lambda dev: True)
        monkeypatch.setattr(overlap, "_send", lambda dst, src: cuda.defer(lambda: dst.copy_(src)))
        monkeypatch.setattr(overlap, "_stage", lambda dst, src: cuda.defer(lambda: dst.copy_(src)))
        monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream(cuda, "side"))
        monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(cuda))
        monkeypatch.setattr(torch.cuda, "stream", cuda.stream)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: cuda.current())
        return cuda, lib
    return make


def _deferred_inputs(grid, cuda, a, b, specs):
    """a and b sharded, their pieces zero until an op on the caller's stream
    writes them: a ring that does not wait for the caller reads zeros."""
    out = []
    for x, spec in zip((a, b), specs):
        sx = grid.shard(x, spec)
        for piece in sx.pieces:
            true = piece.clone()
            piece.zero_()
            cuda.defer(lambda p=piece, t=true: p.copy_(t))
        out.append(sx)
    return out


def _run_deferred(make, nr, kind, seed):
    """One ring call of ``kind`` at ``nr`` ranks under a seeded
    interleaving; returns (the result, float64 want, the harness, the lib,
    the growth of the three counts)."""
    cuda, lib = make(seed)
    gen = np.random.default_rng(1000 * nr + seed)
    g = mp.Grid.create([CPU] * nr)
    if kind == "ag":
        a = gen.normal(size=(3 * nr, 5)).astype(np.float32)
        b = gen.normal(size=(5, 2 * nr)).astype(np.float32)
        specs, fn = (("x", None), (None, "x")), overlap.matmul_ag_overlapped
    else:
        a = gen.normal(size=(3 * nr, 2 * nr)).astype(np.float32)
        b = gen.normal(size=(2 * nr, 4)).astype(np.float32)
        specs, fn = ((None, "x"), ("x", None)), overlap.matmul_rs_overlapped
    before = _ring_counts()
    got = fn(*_deferred_inputs(g, cuda, a, b, specs), g)
    cuda.drain()
    return got, a.astype(np.float64) @ b, cuda, lib, [y - x for x, y in zip(before,
                                                                          _ring_counts())]


def _ring_counts():
    """(AG GEMMs, AG splits, RS GEMMs, RS splits, accumulates)."""
    ag, rs = overlap.matmul_ag_overlapped, overlap.matmul_rs_overlapped
    return [ag.launches, ag.splits, rs.launches, rs.splits, rs.accumulates]


def _tf32(lib, kind):
    return [c for c in lib.__dict__.get("tf32_calls", []) if c["kind"] == kind]


@pytest.mark.parametrize("nr", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_cuda_branch_counts_and_marshalling(deferred, nr, kind):
    """Through the real CUDA wrappers on the emulated library: P² ring GEMMs
    a call on the 3xTF32 kernel, P² + P split passes (each rank's B once,
    transposed into Bᵀ's planes, and every A chunk: k = 5 and 2 a rank are
    not TMA's row strides), P(P − 1) accumulates (B12b), each launch on a
    side stream, the result equal to float64 at RTOL."""
    got, want, cuda, lib, grew = _run_deferred(deferred, nr, kind, seed=0)
    assert cuda.errors == []
    assert_allclose(got.full(), want, rtol=RTOL)
    gemms, splits = _tf32(lib, "gemm"), _tf32(lib, "split")
    accs = [c for c in lib.calls if c.get("kind") == "ring_accumulate"]
    assert len(gemms) == nr * nr and len(splits) == nr * nr + nr
    assert sum(c["flags"] == tf32x3.TRANSPOSE for c in splits) == nr
    assert all(c["ld"][0] % 4 == 0 and c["ld"][1] % 4 == 0 and c["c"] is None for c in gemms)
    if kind == "ag":
        assert grew == [nr * nr, nr * nr + nr, 0, 0, 0] and accs == []
    else:
        assert grew == [0, 0, nr * nr, nr * nr + nr, nr * (nr - 1)]
        assert len(accs) == nr * (nr - 1)
        assert sum(c["d"] for c in accs) == (nr if nr > 1 else 0)   # the last step writes D
    assert not [c for c in lib.calls if c.get("kernel")]   # no B1 launch for f32 operands
    assert all(cuda.streams[c["stream"]].name == "side" for c in lib.calls + lib.tf32_calls)


@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_cuda_branch_splits_a_in_the_kernel_where_tma_reads_it(deferred, kind):
    """k = 8 a rank, a multiple of 4: the A chunks go to the 3xTF32 kernel
    as they lie (split in its registers), so a call's split passes are the
    P of B alone, transposed; the result equals float64 at RTOL under a
    seeded interleaving."""
    nr = 4
    cuda, lib = deferred(1)
    g = mp.Grid.create([CPU] * nr)
    gen = np.random.default_rng(11)
    if kind == "ag":
        a = gen.normal(size=(3 * nr, 8)).astype(np.float32)
        b = gen.normal(size=(8, 2 * nr)).astype(np.float32)
        specs, fn = (("x", None), (None, "x")), overlap.matmul_ag_overlapped
        want_grew = [nr * nr, nr, 0, 0, 0]
    else:
        a = gen.normal(size=(3 * nr, 8 * nr)).astype(np.float32)
        b = gen.normal(size=(8 * nr, 4)).astype(np.float32)
        specs, fn = ((None, "x"), ("x", None)), overlap.matmul_rs_overlapped
        want_grew = [0, 0, nr * nr, nr, nr * (nr - 1)]
    before = _ring_counts()
    got = fn(*_deferred_inputs(g, cuda, a, b, specs), g)
    cuda.drain()
    assert cuda.errors == []
    assert_allclose(got.full(), a.astype(np.float64) @ b, rtol=RTOL)
    gemms, splits = _tf32(lib, "gemm"), _tf32(lib, "split")
    assert len(gemms) == nr * nr and all(c["split_a"] and c["ld"][0] == 8 for c in gemms)
    assert [c["flags"] for c in splits] == [tf32x3.TRANSPOSE] * nr
    assert [y - x for x, y in zip(before, _ring_counts())] == want_grew


@pytest.mark.parametrize("nr", [2, 3, 4])
@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_cuda_branch_is_race_free_under_any_interleaving(deferred, nr, kind):
    """Twelve seeded interleavings of every stream's queue that keep only
    stream order and event waits: the ring's result equals float64 at RTOL
    under each; no wait is on an event not yet recorded; the caller's
    stream waits on every side stream after that stream's last work; the
    streams are the grid's, made once."""
    for seed in range(12):
        got, want, cuda, _, _ = _run_deferred(deferred, nr, kind, seed)
        assert cuda.errors == [], seed
        assert_allclose(got.full(), want, rtol=RTOL, msg=f"seed {seed}")
        side = [s for s in cuda.streams.values() if s.name == "side"]
        assert len(side) == 2 * nr
        assert all(cuda.exit_waits[s] == len(s.queue) for s in side)


def test_harness_sees_a_race_when_the_waits_are_dropped(deferred, monkeypatch):
    """The control: with every event wait dropped, some interleaving gives a
    wrong result (the harness can see a missing wait)."""
    monkeypatch.setattr(overlap._Ring, "wait", lambda self, rank, which, event: None)
    wrong = 0
    for kind in ("ag", "rs"):
        for seed in range(12):
            got, want, _, _, _ = _run_deferred(deferred, 3, kind, seed)
            wrong += not np.allclose(got.full().numpy(), want, rtol=RTOL, atol=RTOL)
    assert wrong > 0


def test_streams_are_made_once_per_grid(deferred):
    cuda, _ = deferred(0)
    g = mp.Grid.create([CPU] * 2)
    ones = np.ones((4, 4), np.float32)
    overlap.matmul_ag_overlapped(ones, ones, g)
    streams = overlap._STREAMS[g]
    overlap.matmul_rs_overlapped(ones, ones, g)
    cuda.drain()
    assert overlap._STREAMS[g] is streams and len(cuda.streams) == 1 + 4


def test_cuda_branch_rejects_unsupported_dtypes(deferred):
    """float64 operands, and f32 operands into a bf16 output (the 3xTF32
    kernel writes f32 alone), raise before any launch."""
    cuda, lib = deferred(0)
    g = mp.Grid.create([CPU] * 2)
    with pytest.raises(NotSupportedError, match="ring GEMM"):
        overlap.matmul_ag_overlapped(np.ones((4, 4)), np.ones((4, 4)), g)   # float64
    ops = overlap._RankOperands(torch.ones((4, 4)), 4, overlap.matmul_ag_overlapped)
    with pytest.raises(NotSupportedError, match="ring GEMM"):
        overlap._ring_gemm(torch.ones((4, 4)), ops, torch.empty((4, 4), dtype=torch.bfloat16))
    assert lib.calls == [] and _tf32(lib, "gemm") == _tf32(lib, "split") == []


def test_cuda_accumulate_rejects_strided_operands(deferred):
    """tml_ring_accumulate reads partial, slot and D as contiguous rows, so a
    strided one of the three raises before any launch."""
    cuda, lib = deferred(0)
    dense, strided = torch.ones((4, 4)), torch.ones((4, 8))[:, ::2]
    for args in ((strided, dense), (dense, strided), (dense, dense, strided)):
        with pytest.raises(InvalidValueError, match="contiguous"):
            overlap._ring_accumulate(*args)
    assert [c for c in lib.calls if c["kind"] == "ring_accumulate"] == []


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the ring launches its kernels or raises: a failing
    build never falls back to the plain versions."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(overlap, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    g = mp.Grid.create([CPU] * 2)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        overlap.matmul_ag_overlapped(np.ones((4, 4), np.float32), np.ones((4, 4), np.float32), g)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        overlap._ring_accumulate(torch.ones(4), torch.ones(4))


@pytest.mark.parametrize("width", [4, 8])
def test_bf16_ring_marshalling(deferred, width):
    """bf16 operands take B1's bf16 wgmma kernel, B N-major (its transpose
    bit) and no split: B12a's GEMMs write bf16 rows of D, B12b's write f32
    slots and its last accumulate writes bf16 D; both within the bf16 rtol
    1e-2 of float64. The emulated kernel refuses a row stride that is not a
    multiple of 8, as TMA does: B's pieces (2 or 4 columns) are copied once
    a call into buffers whose stride is, and at width 4 each A chunk (k = 4)
    before its GEMM; at width 8 the chunks are read in place. The launches
    are B1's (dx.gemm._Into.wgmma): its counts grow by the ring's 4."""
    for kind, codes in (("ag", {(1, 1)}), ("rs", {(1, 0)})):
        cuda, lib = deferred(3)
        g = mp.Grid.create([CPU] * 2)
        gen = np.random.default_rng(5)
        k = width if kind == "ag" else 2 * width   # k a rank: width
        a = torch.from_numpy(gen.normal(size=(8, k)).astype(np.float32)).bfloat16()
        b = torch.from_numpy(gen.normal(size=(k, 4)).astype(np.float32)).bfloat16()
        fn = overlap.matmul_ag_overlapped if kind == "ag" else overlap.matmul_rs_overlapped
        before = _ring_counts()
        b1_before = (gemm._gemm_wgmma.launches, gemm.pallas_matmul.launches)
        got = fn(a, b, g)
        cuda.drain()
        assert cuda.errors == [] and got.dtype == torch.bfloat16
        assert (gemm._gemm_wgmma.launches, gemm.pallas_matmul.launches) == (
            b1_before[0] + 4, b1_before[1] + 4)
        wgmma = [c for c in lib.calls if c.get("kernel") == "wgmma"]
        assert len(wgmma) == 4 and {(c["ab"], c["d"]) for c in wgmma} == codes
        assert all(c["majors"][1] == 0 for c in wgmma)   # B row-major: N-major in the kernel
        assert _tf32(lib, "split") == [] and [y - x for x, y in zip(before, _ring_counts())] == (
            [4, 0, 0, 0, 0] if kind == "ag" else [0, 0, 4, 0, 2])
        assert_allclose(got.full(), a.double() @ b.double(), rtol=1e-2)
