"""The warp route of tpumathlib_torch.dx.solver's Jacobi kernels (B7g
syevd, B7h gesvd; csrc/dx_jacobi.cu, n ≤ 32), mirrored on the CPU.

- ``_jacobi_route``: "warp" to n = 32, "block" from 33 to 64.
- ``_Circle`` copies the kernel's slot arithmetic (``Circle<NPAD>``: index
  0 in slot 0, slot s ≥ 1 holding 1 + (s − 1 + r) mod (npad − 1) in round
  r, pair k on slots (0, 1) or (1 + k, npad − k), p first). From it, the
  pairs the kernel turns in its lanes' registers, and each lane's view of
  its own pair (slot, partner, role, the buffer entry it writes), give
  ``_live_pairs(n)`` pair for pair, in order, with the p/q roles kept, for
  every n = 1 … 32: the spare index of odd n is skipped, never turned.
- ``_model_warp_route`` runs a warp-route kernel's rounds in torch: A and V
  padded to npad rows (the lanes) and columns, the columns in slot order
  and rotated down by one register between rounds, syevd's coefficients
  from each lane's diagonal entry, coupling and its partner's two (lanes p
  and q must agree), its row turn c·a_mine ± s·a_partner. On the CPU it
  equals ``_syevd_plain`` and ``_gesvd_plain`` bit for bit (NaN in the same
  places) at n = 3, 7 and 16 over 2 sweeps, also on inputs holding an inf
  for odd n; turning the spare pair with c = 1 and s = 0 instead gives
  another result on such an input. The kernel's column sums run in a butterfly, not
  in the plain version's order: the model sums as the plain version does,
  and the card holds the kernel to DXE_TOL (chip_smoke.py phase 21).
"""

import numpy as np
import pytest
import torch

from tpumathlib_torch.core.interop import from_numpy
from tpumathlib_torch.dx import solver as port

torch.set_num_threads(1)


class _Circle:
    """csrc/dx_jacobi.cu's ``Circle<NPAD>``, term for term."""

    def __init__(self, npad: int):
        self.npad, self.m, self.pairs = npad, npad - 1, npad // 2

    def p_slot(self, k):
        return 0 if k == 0 else 1 + k

    def q_slot(self, k):
        return 1 if k == 0 else self.npad - k

    def index_at(self, s, r):
        i = s - 1 + r
        return 0 if s == 0 else 1 + (i - self.m if i >= self.m else i)

    def slot_of(self, i, r):
        d = i - 1 - r
        return 0 if i == 0 else 1 + (d + self.m if d < 0 else d)

    def partner_slot(self, s):
        return 1 if s == 0 else 0 if s == 1 else self.npad + 1 - s

    def pair_of(self, s):
        return 0 if s <= 1 else s - 1 if s <= self.pairs else self.npad - s

    def holds_p(self, s):
        return s == 0 or 2 <= s <= self.pairs

    def earlier(self, s):
        """The slot that holds, a round earlier, what slot s holds."""
        return 0 if s == 0 else 1 if s == self.m else s + 1

    def dead(self, n, r):
        """The pair the column turns skip: the spare index's, in slot m − r."""
        return self.pair_of(self.m - r) if n % 2 else -1


def _lanes(circle, n, r, threads=32):
    """Each lane's (or thread's) view of round r: (slot, partner, live,
    holds p); ``threads``: 32 on the warp route, 64 on the block route."""
    out = []
    for lane in range(threads):
        paired = lane < circle.npad
        slot = circle.slot_of(lane, r) if paired else 0
        partner = circle.index_at(circle.partner_slot(slot), r) if paired else lane
        out.append((slot, partner, lane < n and partner < n, circle.holds_p(slot)))
    return out


def _cols(circle, n, r):
    """Round r's live pairs by the slots the column turns take: {k: (p, q)}."""
    return {k: (circle.index_at(circle.p_slot(k), r), circle.index_at(circle.q_slot(k), r))
            for k in range(circle.pairs) if k != circle.dead(n, r)}


def _warp_schedule(n):
    """The pairs the Jacobi kernels turn, round by round: (npad − 1, live
    pairs, 2) as (p, q), checked against what every lane finds for itself:
    a warp's 32 lanes to n = 32, the block route's 64 threads (two warps)
    beyond. On the warp route lane p writes its pair's (c, s); on the block
    route lane k of each warp forms pair k's, syevd's from the entries of
    the row turn before (``_block_entry_rows``)."""
    circle = _Circle(n + n % 2)
    threads = 32 if port._jacobi_route(n) == "warp" else 64
    rounds = []
    for r in range(circle.m):
        cols = _cols(circle, n, r)
        lanes = _lanes(circle, n, r, threads)
        rows, writers = {}, {}
        for lane, (slot, partner, live, own_p) in enumerate(lanes):
            if not live:
                continue
            k = circle.pair_of(slot)
            rows[k] = rows.get(k, (None, None))
            rows[k] = (lane, rows[k][1]) if own_p else (rows[k][0], lane)
            assert lanes[partner][1] == lane
            if own_p:
                writers[k] = lane
        assert rows == cols and writers == {k: p for k, (p, _) in cols.items()}
        if threads == 64:
            assert _block_entry_rows(circle, n, r) == {
                k: {x: _turned_with(circle, n, (r - 1) % circle.m, x) for x in pq}
                for k, pq in cols.items()}
        rounds.append([cols[k] for k in sorted(cols)])
    return np.array(rounds, np.int32).reshape(circle.m, -1, 2)


def _turned_with(circle, n, r, x):
    """From _live_pairs(n)[r]: (partner, x is p) of index x, or None for a bye."""
    for p, q in port._live_pairs(n)[r]:
        if x in (p, q):
            return (int(q if x == p else p), bool(x == p))
    return None


def _block_entry_rows(circle, n, r):
    """syevd_block_kernel's lane k, forming pair k's (c, s) for round r from
    round r − 1's tile: p and q sit there in slots earlier(p_slot(k)) and
    earlier(q_slot(k)), whatever the round; for each, the row it was turned
    with in round r − 1 and its role there (``turned_entry``), or None where
    it was not turned."""
    prev = (r - 1) % circle.m
    out = {}
    for k, pq in _cols(circle, n, r).items():
        out[k] = {}
        for x, s in zip(pq, (circle.p_slot(k), circle.q_slot(k))):
            sx = circle.earlier(s)
            assert circle.index_at(sx, prev) == x and circle.slot_of(x, prev) == sx
            y = circle.index_at(circle.partner_slot(sx), prev)
            out[k][x] = (y, circle.holds_p(sx)) if y < n else None
    return out


def test_jacobi_route():
    assert [port._jacobi_route(n) for n in (1, 31, 32, 33, 64)] == [
        "warp", "warp", "warp", "block", "block"]


@pytest.mark.parametrize("n", range(1, 65))
def test_warp_schedule_is_live_pairs(n):
    np.testing.assert_array_equal(_warp_schedule(n), port._live_pairs(n))


def _model_warp_route(a, sweeps, svd, turn_spare=False):
    """syevd_warp_kernel (svd False: w, V) or gesvd_warp_kernel (U, s, V) on
    f32 (B, n, n), unsorted; ``turn_spare`` turns the spare pair with c = 1
    and s = 0 where the kernel skips it."""
    bsz, n = a.shape[0], a.shape[-1]
    npad = n + n % 2
    circle = _Circle(npad)
    big = torch.zeros((bsz, npad, npad))
    big[:, :n, :n] = a
    v = torch.zeros((bsz, npad, npad))
    v[:, range(n), range(n)] = 1.0
    down = [0] + list(range(2, npad)) + [1] if npad > 2 else [0, 1]
    for _ in range(sweeps):
        for r in range(circle.m):
            dead = -1 if turn_spare else circle.dead(n, r)
            live = [k for k in range(circle.pairs) if k != dead]
            ps = torch.tensor([circle.p_slot(k) for k in live], dtype=torch.long)
            qs = torch.tensor([circle.q_slot(k) for k in live], dtype=torch.long)
            lanes = _lanes(circle, n, r)[:npad]
            if svd:
                ap, aq = big[:, :n, ps], big[:, :n, qs]
                c, s = port._rot_pair((ap * ap).sum(1), (aq * aq).sum(1), (ap * aq).sum(1))
            else:
                slot = torch.tensor([l[0] for l in lanes])
                partner = torch.tensor([l[1] for l in lanes])
                own_p = torch.tensor([l[3] for l in lanes])
                rows = torch.arange(npad)
                diag = big[:, rows, slot]
                cpl = big[:, rows, [circle.partner_slot(int(t)) for t in slot]]
                diag2, cpl2 = diag[:, partner], cpl[:, partner]   # the shuffles
                lc, ls = port._rot_pair(torch.where(own_p, diag, diag2),
                                        torch.where(own_p, diag2, diag),
                                        torch.where(own_p, cpl, cpl2))
                if turn_spare:
                    spare = torch.tensor([not l[2] for l in lanes]) & (rows < n)
                    lc, ls = torch.where(spare, 1.0, lc), torch.where(spare, 0.0, ls)
                for k in live:   # lanes p and q of a pair compute the same (c, s)
                    lp = circle.index_at(circle.p_slot(k), r)
                    lq = circle.index_at(circle.q_slot(k), r)
                    if lp < n and lq < n:
                        assert torch.allclose(lc[:, lp], lc[:, lq], rtol=0, atol=0, equal_nan=True)
                owners = [circle.index_at(circle.p_slot(k), r) for k in live]
                c, s = lc[:, owners], ls[:, owners]
            c, s = c[:, None, :], s[:, None, :]
            for m in (big, v):
                x, y = m[:, :, ps], m[:, :, qs]
                m[:, :, ps] = c * x - s * y
                m[:, :, qs] = s * x + c * y
            if not svd:   # lane i: c·a_i − s·a_partner (p) or c·a_i + s·a_partner (q)
                turned = torch.tensor([l[2] for l in lanes])
                if turn_spare:
                    turned = rows < n
                sr = torch.where(own_p, -ls, ls)
                new = lc[:, :, None] * big + sr[:, :, None] * big[:, partner]
                big = torch.where(turned[None, :, None], new, big)
            big, v = big[:, :, down], v[:, :, down]
    a_n, v_n = big[:, :n, :n].contiguous(), v[:, :n, :n].contiguous()
    if not svd:
        return torch.diagonal(a_n, dim1=1, dim2=2).clone(), v_n
    sig = torch.sqrt((a_n * a_n).sum(1))
    return a_n / torch.where(sig > 0, sig, 1.0)[:, None, :], sig, v_n


def _same(got, want):
    """Bit for bit where finite or infinite, NaN in the same places."""
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        g, w = torch.nan_to_num(g, nan=0.0), torch.nan_to_num(w, nan=0.0)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _sym(rng, b, n):
    g = rng.normal(size=(b, n, n)).astype(np.float32)
    return from_numpy((g + g.transpose(0, 2, 1)) / 2), from_numpy(g)


@pytest.mark.parametrize("n", [3, 7, 16])
def test_warp_route_model_is_the_plain_version(n):
    sym, g = _sym(np.random.default_rng(18), 4, n)
    _same(_model_warp_route(sym, 2, False), port._syevd_plain(sym, 2))
    _same(_model_warp_route(g, 2, True), port._gesvd_plain(g, 2))


def _with_inf(n):
    """_sym's matrices of order n, the first with an inf in A(i, j) and
    A(j, i) (syevd) or g(i, j) (gesvd): (1, 2) at n = 3, (2, 3) above."""
    sym, g = _sym(np.random.default_rng(18), 2, n)
    i, j = min(2, n - 2), n - 1 if n < 4 else 3
    sym[0, i, j] = sym[0, j, i] = g[0, i, j] = float("inf")
    return sym, g


@pytest.mark.parametrize("n", [3, 7])
def test_warp_route_model_with_an_inf_is_the_plain_version(n):
    sym, g = _with_inf(n)
    _same(_model_warp_route(sym, 2, False), port._syevd_plain(sym, 2))
    _same(_model_warp_route(g, 2, True), port._gesvd_plain(g, 2))


def test_turning_the_spare_pair_is_not_skipping_it():
    """With c = 1 and s = 0 on the spare pair, 0·inf lands in the spare
    column and row, and the NaN reaches real entries: at n = 7 syevd's
    couplings turn NaN sooner (no turn) and V comes back finite where the
    plain version's is NaN."""
    sym, _ = _with_inf(7)
    plain = port._syevd_plain(sym, 2)
    turned = _model_warp_route(sym, 2, False, turn_spare=True)
    assert bool(plain[1][0].isnan().all()) and bool(torch.isfinite(turned[1][0]).all())
    with pytest.raises(AssertionError):
        _same(turned, plain)
