"""The block route of tpumathlib_torch.dx.solver's Jacobi kernels (B7g
syevd, B7h gesvd; csrc/dx_jacobi_block.cu, 33 ≤ n ≤ 64), mirrored on the CPU.

Two warps a matrix: thread i of 64 holds row i of A and of V (zeros past
n), the columns in the circle method's slots (``_Circle``, the schedule's
pairs checked for every n in test_torch_dx_jacobi_warp.py). The models run
the kernels' rounds in torch:

- ``_model_block_syevd``: the columns turn with the round's (c, s); the
  rows of A·J go to a tile, and each thread turns its row with its
  partner's from the tile (c·a_mine ± s·a_partner); lane k forms pair k's
  next (c, s) from the same tile and this round's (c, s) (``turned_entry``),
  which must equal what the rows hold, bit for bit; round 0's from A. On
  the CPU it is ``_syevd_plain`` bit for bit (NaN in the same places) over
  2 sweeps at n = 33, 40, 63 and 64, also with an inf.
- ``_model_block_gesvd``: each warp sums its 32 rows' products of every
  pair (``warp_sums``: a lane's own product fused into its partner's,
  lane ^ 16, then folded at distance 8, 4, 2, 1), warp 0's sums plus warp
  1's; σ_j sums column j's squares row by row. That is not the plain
  version's order of sums. With the plain order in its place, the model is
  ``_gesvd_plain`` bit for bit over 2 sweeps at the same n, also with an
  inf. In the kernel's order each round's sums are held within 1e-6 of the
  plain order's (over the sum of the terms' magnitudes, NaN and inf in the
  same places) for the 12 sweeps of ``gesvd_batched``, whose singular values
  then agree within 2e-6: Jacobi's own rounding (unconverged, after 2
  sweeps, the plain version in f32 sits 1e-5 to 1e-4 from float64). The
  card holds the kernels to DXE_TOL (chip_smoke.py phase 21).
"""

import numpy as np
import pytest
import torch

from test_torch_dx_jacobi_warp import _Circle, _lanes, _same, _sym, _with_inf
from tpumathlib_torch.dx import solver as port

torch.set_num_threads(1)

THREADS = 64   # the block route's threads a matrix: two warps
WARP = 32


def _padded(a, npad, eye=False):
    """(B, n, n) into (B, THREADS, npad) rows, zeros past n; eye: V's start."""
    bsz, n = a.shape[0], a.shape[-1]
    out = torch.zeros((bsz, THREADS, npad))
    if eye:
        out[:, range(n), range(n)] = 1.0
    else:
        out[:, :n, :n] = a
    return out


def _down(npad):
    """Slots 1 .. npad − 1 move down by one (``rotate``)."""
    return [0] + list(range(2, npad)) + [1]


def _turn_columns(circle, n, r, c, s, *ms):
    """Columns p and q of every live pair of round r, in place."""
    live = [k for k in range(circle.pairs) if k != circle.dead(n, r)]
    ps = [circle.p_slot(k) for k in live]
    qs = [circle.q_slot(k) for k in live]
    c, s = c[:, None, live], s[:, None, live]
    for m in ms:
        x, y = m[:, :, ps], m[:, :, qs]
        m[:, :, ps] = c * x - s * y
        m[:, :, qs] = s * x + c * y


def _pairs(circle, n, r):
    """Round r's pairs by slot, and which are live: [(k, p, q)], [bool]."""
    pq = [(k, circle.index_at(circle.p_slot(k), r), circle.index_at(circle.q_slot(k), r))
          for k in range(circle.pairs)]
    return pq, [p < n and q < n for _, p, q in pq]


def _coeffs(entries, live):
    """rot_coeffs of lane k from its three entries; (1, 0) for the dead pair."""
    c, s = port._rot_pair(*entries)
    live = torch.tensor(live)
    return torch.where(live, c, 1.0), torch.where(live, s, 0.0)


def _model_block_syevd(a, sweeps):
    """syevd_block_kernel on f32 (B, n, n): (w, V) unsorted."""
    n = a.shape[-1]
    npad = n + n % 2
    circle, down = _Circle(npad), _down(npad)
    big, v = _padded(a, npad), _padded(a, npad, eye=True)
    pq, live = _pairs(circle, n, 0)   # round 0's slots are the natural order
    idx = lambda i: torch.tensor([t[i] for t in pq])
    c, s = _coeffs((big[:, idx(1), idx(1)], big[:, idx(2), idx(2)], big[:, idx(1), idx(2)]), live)
    for _ in range(sweeps):
        for r in range(circle.m):
            _turn_columns(circle, n, r, c, s, big, v)
            tile = big.clone()   # the rows of A·J, round r's slots
            lanes = _lanes(circle, n, r, THREADS)
            slot = torch.tensor([t[0] for t in lanes])
            partner = torch.tensor([t[1] for t in lanes])
            turned = torch.tensor([t[2] for t in lanes])
            own_p = torch.tensor([t[3] for t in lanes])
            k_of = torch.tensor([circle.pair_of(int(t)) for t in slot])
            sr = torch.where(own_p, -s[:, k_of], s[:, k_of])
            new = c[:, k_of, None] * big + sr[:, :, None] * tile[:, partner]
            big = torch.where(turned[None, :, None], new, big)
            # lane k: pair k of round r + 1 from the tile and round r's (c, s)
            r1 = (r + 1) % circle.m
            pq, live = _pairs(circle, n, r1)

            def entry(x, col):
                sx, scol = circle.slot_of(x, r), circle.slot_of(col, r)
                y = circle.index_at(circle.partner_slot(sx), r)
                if y >= n:
                    got = tile[:, x, scol]
                else:
                    k = circle.pair_of(sx)
                    sr = -s[:, k] if circle.holds_p(sx) else s[:, k]
                    got = c[:, k] * tile[:, x, scol] + sr * tile[:, y, scol]
                _same([got], [big[:, x, scol]])   # what thread x holds
                return got

            zero = torch.zeros(a.shape[0])
            ent = [[entry(p, p), entry(q, q), entry(p, q)] if ok else [zero] * 3
                   for (_, p, q), ok in zip(pq, live)]
            c, s = _coeffs([torch.stack([e[j] for e in ent], 1) for j in range(3)], live)
            big, v = big[:, :, down], v[:, :, down]
    return torch.diagonal(big[:, :n, :n], dim1=1, dim2=2).clone(), v[:, :n, :n].contiguous()


def _by_pair(big, slot, circle):
    """Column slot(k) of every row for pair k, zeros for k up to 32."""
    cols = big[:, :, [slot(k) for k in range(circle.pairs)]]
    return torch.cat([cols, torch.zeros((big.shape[0], THREADS, WARP - circle.pairs))], 2)


def _warp_sums(x, y):
    """``warp_sums`` of one warp, x and y (B, 32 lanes, pairs) its rows'
    columns p and q of every pair: the sums of x², y² and x·y. A lane of
    the half that keeps the pair (lanes 0–15 for pairs 0–15, 16–31 beyond)
    fuses its own product into its partner's (lane ^ 16), which was rounded
    to f32 first: one FMA, here in float64 rounded once to f32. Then the
    halves fold at distance 8, 4, 2 and 1."""
    keep = (torch.arange(x.shape[2]) >= WARP // 2)[None, None, :]
    out = []
    for u, w in ((x, x), (y, y), (x, y)):
        lo, hi = (u[:, :WARP // 2], w[:, :WARP // 2]), (u[:, WARP // 2:], w[:, WARP // 2:])
        mine = [torch.where(keep, h, l) for l, h in zip(lo, hi)]
        other = [torch.where(keep, l, h) for l, h in zip(lo, hi)]
        v = (mine[0].double() * mine[1].double() + (other[0] * other[1]).double()).float()
        while v.shape[1] > 1:
            half = v.shape[1] // 2
            v = v[:, :half] + v[:, half:]
        out.append(v[:, 0])
    return out


def _model_block_gesvd(a, sweeps, sums="kernel"):
    """gesvd_block_kernel on f32 (B, n, n): (U, s, V) unsorted. sums
    "kernel": each warp's ``_warp_sums``, warp 0's added to warp 1's, each
    round held within 1e-6 of the plain order's sums over the sum of the
    terms' magnitudes; σ_j from column j's squares row by row. sums
    "plain": the plain version's order, over the real rows."""
    n = a.shape[-1]
    npad = n + n % 2
    circle, down = _Circle(npad), _down(npad)
    big, v = _padded(a, npad), _padded(a, npad, eye=True)
    for _ in range(sweeps):
        for r in range(circle.m):
            live = [k for k in range(circle.pairs) if k != circle.dead(n, r)]
            x = big[:, :, [circle.p_slot(k) for k in live]]
            y = big[:, :, [circle.q_slot(k) for k in live]]
            terms = (x * x, y * y, x * y)
            plain = [t[:, :n].sum(1) for t in terms]
            if sums == "plain":
                got = plain
            else:
                xw, yw = _by_pair(big, circle.p_slot, circle), _by_pair(big, circle.q_slot, circle)
                halves = [_warp_sums(xw[:, :WARP], yw[:, :WARP]),
                          _warp_sums(xw[:, WARP:], yw[:, WARP:])]
                got = [(w0 + w1)[:, live] for w0, w1 in zip(*halves)]
                _same_places(got, plain)
                for t, f, p in zip(terms, got, plain):
                    fin = torch.isfinite(p)
                    err = (f - p).abs() / t.abs().sum(1).clamp(min=1e-30)
                    if bool(fin.any()):
                        assert float(err[fin].max()) <= 1e-6
            c, s = torch.ones((a.shape[0], circle.pairs)), torch.zeros((a.shape[0], circle.pairs))
            c[:, live], s[:, live] = port._rot_pair(*got)
            _turn_columns(circle, n, r, c, s, big, v)
            big, v = big[:, :, down], v[:, :, down]
    a_n = big[:, :n, :n]
    if sums == "plain":
        ss = (a_n * a_n).sum(1)
    else:
        ss = torch.zeros((a.shape[0], n))
        for row in range(n):   # thread j sums column j's squares row by row
            ss = ss + a_n[:, row] * a_n[:, row]
    sig = torch.sqrt(ss)
    return a_n / torch.where(sig > 0, sig, 1.0)[:, None, :], sig, v[:, :n, :n].contiguous()


def _same_places(got, want):
    """NaN, inf and −inf in the same places."""
    for g, w in zip(got, want):
        for mark in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(mark(g), mark(w))


@pytest.mark.parametrize("n", [33, 40, 63, 64])
def test_block_route_model_is_the_plain_version(n):
    sym, g = _sym(np.random.default_rng(24), 3, n)
    _same(_model_block_syevd(sym, 2), port._syevd_plain(sym, 2))
    _same(_model_block_gesvd(g, 2, sums="plain"), port._gesvd_plain(g, 2))


@pytest.mark.parametrize("n", [33, 64])
def test_block_route_model_with_an_inf_is_the_plain_version(n):
    sym, g = _with_inf(n)
    want = port._syevd_plain(sym, 2)
    assert bool(want[1][0].isnan().any())   # the inf has spread
    _same(_model_block_syevd(sym, 2), want)
    want = port._gesvd_plain(g, 2)
    _same(_model_block_gesvd(g, 2, sums="plain"), want)
    _same_places(_model_block_gesvd(g, 2), want)


@pytest.mark.parametrize("n", [33, 40, 63, 64])
def test_block_route_sums_in_the_kernels_order(n):
    """Every round's folded sums of the two warps within 1e-6 of the plain
    order's, over the sum of the terms' magnitudes (3e-7 the most seen over
    12 sweeps at these n), over the sweeps of gesvd_batched; the values then
    within 2e-6 of the plain version's, sorted and over the largest (1.1e-6
    the most seen: Jacobi's own rounding, the plain version in f32 sits
    1e-5 from float64 after 2 sweeps)."""
    _, g = _sym(np.random.default_rng(24), 3, n)
    s = _model_block_gesvd(g, 12)[1].sort(1, descending=True)[0]
    want = port._gesvd_plain(g, 12)[1].sort(1, descending=True)[0]
    assert float((s - want).abs().max() / want.max()) <= 2e-6
