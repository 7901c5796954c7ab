"""In-kernel (de)compression, the nvCOMPDx tier: kernels B8a, B8b and B8c.

Counterpart of ``tpumathlib/dx/comp.py``: ``dx_compress``,
``dx_decompress``, ``dx_decompress_dot`` and ``dx_required_bits``, with the
reference's names, checks and messages, dtypes (uint32 packed words, int32
leaders and values) and return tuples.

The format is the reference's cascaded scheme (delta, zigzag, bit-pack; no
run-length stage). The values are cut into rows of 128. In a row, delta 0
is 0 and delta j is v[j] − v[j−1] in int32, wrapping; each delta is
zigzagged to a uint32 and packed at ``bits`` bits a value. Value j of each
32-value group takes word (j·bits)//32 of the group's ``bits`` words at
shift (j·bits)%32, and borrows the low bits of the next word where the field
crosses a word boundary. So a row is 4·bits words and one int32 leader, the
row's first value. A partial last row is padded with the last value (zero
deltas), as the reference pads. Decoding is the inverse: unpack,
zigzag-decode, a prefix sum over the row that wraps mod 2^32, plus the
leader. The reference spreads words to lanes and takes the prefix sums by
one-hot matmuls on the MXU, because Mosaic has no gather; here the fields
are read directly.

Too few bits corrupt silently, as the reference documents: the caller
validates with ``dx_required_bits``.

``dx_decompress_dot`` (B8c) runs on the tensor cores: persistent blocks
keep the TF32 hi and lo planes of their 128-column tile of Wᵀ in shared
memory, four decode warps write each 64-row tile as float(v)·scale, and two
warpgroups multiply it in 3xTF32 (three TF32 products a k step, each
32-deep stage summed apart in f32), within f32's error of the plain
version's f32 product.

On CPU tensors each wrapper (``_encode``, ``_decode``, ``_decode_dot``) takes
its plain PyTorch version (``_dx_compress_plain``, ``_dx_decompress_plain``,
``_dx_decompress_dot_plain``). Those compute in int64 masked to 32 bits,
because torch cannot shift or add ``uint32``. On CUDA tensors a wrapper
launches its kernel in ``csrc/dx_comp.cu`` or raises, and its ``.launches``
counts the launches. The reference pads the rows to a multiple of its
``tile`` and drops the padding before it returns; here nothing is padded
past the last row, so ``tile`` changes nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpumathlib_torch.core.dtypes import cdiv
from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
# the module, not its names: fft.kernels is still being imported when it
# imports dx (through fft.stockham)
from tpumathlib_torch.fft import kernels as fft_kernels

F32, I32, I64 = torch.float32, torch.int32, torch.int64
_M32 = 0xFFFFFFFF
_ROW = 128   # values a row


# ----------------------------- plain versions -----------------------------


def _wrap_i32(x):
    """int64 → the int32 value of its low 32 bits, as int64."""
    return ((x + 2**31) & _M32) - 2**31


def _words_i64(t):
    """A tensor of 32-bit words (uint32, or their int32 bits) → int64 in
    [0, 2^32)."""
    if t.dtype in (torch.uint32, I32):
        t = t.view(I32)
    return t.to(I64) & _M32


def _to_u32(x):
    """int64 holding 32-bit patterns → torch.uint32, by the int32 bits."""
    return _wrap_i32(x).to(I32).view(torch.uint32)


def _zigzag_enc(x):
    """int32 values (as int64) → their zigzag codes, uint32 as int64."""
    return ((x << 1) ^ (x >> 31)) & _M32


def _zigzag_dec(z):
    """uint32 zigzag codes (as int64) → int32 values, as int64."""
    return (z >> 1) ^ -(z & 1)


@functools.lru_cache(maxsize=32)
def _fields(bits: int):
    """Per value j of a row: its word wi, its shift sh and whether it crosses
    into word wi + 1 (numpy, one entry a value)."""
    j = np.arange(_ROW)
    j32 = j % 32
    wi = (j // 32) * bits + (j32 * bits) // 32
    sh = (j32 * bits) % 32
    return wi, sh, sh + bits > 32


def _field_tensors(bits: int, device):
    wi, sh, cross = _fields(bits)
    nxt = np.minimum(wi + 1, 4 * bits - 1)
    return tuple(torch.from_numpy(t).to(device) for t in (wi, nxt, sh, cross))


def _unpack_row(words, bits: int):
    """(R, 4·bits) words as int64 → (R, 128) fields as int64 (the contract of
    the reference's ``_unpack_row``): the word's bits from the shift up,
    then the next word's low bits where the field crosses."""
    wi, nxt, sh, cross = _field_tensors(bits, words.device)
    lo = words[:, wi]
    # a crossing field takes at most bits + sh − 32 ≤ 31 bits of the next word
    hi = torch.where(cross, words[:, nxt] & 0x7FFFFFFF, 0)
    return (((hi << 32) | lo) >> sh) & ((1 << bits) - 1)


def _pack_row(vals, bits: int):
    """(R, 128) values as int64 → (R, 4·bits) words as int64, the inverse of
    ``_unpack_row`` (the contract of the reference's ``_pack_row``): each
    field's low part goes to its word, the part past bit 32 to the next.
    Fields in a word are bit-disjoint, so adding them is OR."""
    wi, nxt, sh, cross = _field_tensors(bits, vals.device)
    v = vals & ((1 << bits) - 1)
    low = (v << sh) & _M32
    carry = torch.where(cross, v >> (32 - sh), 0)
    out = torch.zeros((vals.shape[0], 4 * bits), dtype=I64, device=vals.device)
    out.index_add_(1, wi, low)
    out.index_add_(1, nxt, carry)
    return out


def _cumsum_lanes(d):
    """Inclusive prefix sum over each row of int32 values (as int64), mod 2^32."""
    return _wrap_i32(torch.cumsum(d, dim=1))


def _padded_rows(values):
    """int32 values (as int64) as (rows, 128), a partial last row padded with
    the last value."""
    v = values.to(I32).to(I64)
    pad = (-v.shape[0]) % _ROW
    if pad:
        v = torch.cat([v, v[-1:].expand(pad)])
    return v.reshape(-1, _ROW)


def _dx_compress_plain(values, bits: int):
    """B8b's plain version: (packed (rows, 4·bits) uint32, leaders (rows,)
    int32)."""
    v = _padded_rows(values)
    d = torch.cat([torch.zeros_like(v[:, :1]), _wrap_i32(v[:, 1:] - v[:, :-1])], dim=1)
    return _to_u32(_pack_row(_zigzag_enc(d), bits)), v[:, 0].to(I32)


def _dx_decompress_plain(packed, leaders, bits: int):
    """B8a's plain version: all rows·128 values, int32."""
    d = _zigzag_dec(_unpack_row(_words_i64(packed), bits))
    return _wrap_i32(_cumsum_lanes(d) + leaders.to(I64)[:, None]).to(I32).reshape(-1)


def _dx_decompress_dot_plain(packed, leaders, w, bits: int, scale: float):
    """B8c's plain version: (values (rows, 128) · f32(scale)) @ W in f32
    products (``fft.kernels._mm``)."""
    vals = _dx_decompress_plain(packed, leaders, bits).reshape(-1, _ROW)
    a = vals.to(F32) * torch.tensor(scale, dtype=F32, device=vals.device)
    return fft_kernels._mm(a, w.to(F32))


# ----------------------------- kernel wrappers -----------------------------


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _kernel_words(packed, leaders):
    """The payload as the kernels read it: contiguous uint32 words and int32
    leaders on the words' device."""
    check(leaders.device == packed.device, "packed words and leaders on one device")
    if packed.dtype not in (torch.uint32, I32):
        packed = _to_u32(packed.to(I64) & _M32)
    return packed.view(I32).contiguous().view(torch.uint32), leaders.to(I32).contiguous()


def _encode(values, bits: int):
    """B8b through ``tml_cascaded_encode``: int32 values (n,) → (packed,
    leaders)."""
    if not on_cuda(values):
        return _dx_compress_plain(values, bits)
    v = values.to(I32).contiguous()
    n = v.shape[0]
    rows = cdiv(n, _ROW)
    packed = torch.empty((rows, 4 * bits), dtype=torch.uint32, device=v.device)
    leaders = torch.empty((rows,), dtype=I32, device=v.device)
    if rows:
        lib = cuda_utils.load_kernels()
        with torch.cuda.device(v.device):
            rc = lib.tml_cascaded_encode(v.data_ptr(), packed.data_ptr(), leaders.data_ptr(), n,
                                         bits, _stream(v.device))
        cuda_utils.check_launch(lib, rc, "tml_cascaded_encode")
        _encode.launches += 1
    return packed, leaders


_encode.launches = 0


def _decode(packed, leaders, bits: int, count: int):
    """B8a through ``tml_cascaded_decode``: the first ``count`` ≤ rows·128
    values, int32."""
    if not on_cuda(packed, leaders):
        return _dx_decompress_plain(packed, leaders, bits)[:count]
    p, ld = _kernel_words(packed, leaders)
    out = torch.empty((count,), dtype=I32, device=p.device)
    if count:
        lib = cuda_utils.load_kernels()
        with torch.cuda.device(p.device):
            rc = lib.tml_cascaded_decode(p.data_ptr(), ld.data_ptr(), out.data_ptr(), p.shape[0],
                                         count, bits, _stream(p.device))
        cuda_utils.check_launch(lib, rc, "tml_cascaded_decode")
        _decode.launches += 1
    return out


_decode.launches = 0


def _decode_dot(packed, leaders, w, bits: int, scale: float):
    """B8c through ``tml_cascaded_decode_dot``: (values · scale) @ W, f32
    (rows, N), in 3xTF32 on the tensor cores; the decoded values stay in
    shared memory."""
    if not on_cuda(packed, leaders, w):
        return _dx_decompress_dot_plain(packed, leaders, w, bits, scale)
    p, ld = _kernel_words(packed, leaders)
    check(w.device == p.device, "W on the payload's device")
    w32 = w.to(F32).contiguous()
    rows, ncols = p.shape[0], w32.shape[1]
    out = torch.empty((rows, ncols), dtype=F32, device=p.device)
    if rows and ncols:
        lib = cuda_utils.load_kernels()
        with torch.cuda.device(p.device):
            rc = lib.tml_cascaded_decode_dot(p.data_ptr(), ld.data_ptr(), w32.data_ptr(),
                                             out.data_ptr(), rows, ncols, bits, float(scale),
                                             _stream(p.device))
        cuda_utils.check_launch(lib, rc, "tml_cascaded_decode_dot")
        _decode_dot.launches += 1
    return out


_decode_dot.launches = 0


# ----------------------------- public API -----------------------------


def dx_decompress(packed, leaders, n: int = None, *, bits: int, tile: int = 512):
    """Cascaded decode (row-restarted delta + zigzag + bit-pack): packed
    (rows, 4·bits) uint32 and one int32 leader a row → int32 values, all
    rows·128 of them, or the first ``n``."""
    check(1 <= bits <= 32, "dx codec packs into 32-bit words: bits must be "
                           "1..32 (wider deltas silently wrap otherwise)")
    check(packed.shape[1] == 4 * bits, "packed shape must be (rows, 4*bits) word rows")
    rows = packed.shape[0]
    check(leaders.shape[0] == rows, "one leader per 128-value row")
    total = rows * _ROW
    count = total if n is None else len(range(total)[:n])
    return _decode(packed, leaders, bits, count)


def dx_compress(values, *, bits: int, tile: int = 512):
    """Cascaded encode: int32 values, a multiple of 32 of them → (packed
    (⌈n/128⌉, 4·bits) uint32, leaders (⌈n/128⌉,) int32). Each row's deltas
    must fit ``bits`` after zigzag: validate with ``dx_required_bits``."""
    check(1 <= bits <= 32, "dx codec packs into 32-bit words: bits must be "
                           "1..32 (use dx_required_bits to validate inputs)")
    n = values.shape[0]
    check(n % 32 == 0, "value count must be a multiple of 32")
    return _encode(values, bits)


def dx_required_bits(values) -> int:
    """Smallest bit width for dx_compress of these values.

    Raises when the zigzagged deltas need more than 32 bits (an int32 delta
    can need 33 after zigzag): such buffers must go through the host
    cascaded codec instead. A tensor is reduced on its own device, with one
    scalar read back; an array or a list on the CPU. The deltas are taken in
    int64, unwrapped."""
    v = torch.as_tensor(values).reshape(-1).to(I64)
    if v.numel() == 0:
        return 1
    d = torch.diff(v, prepend=v.new_zeros(1))
    d[0::_ROW] = 0   # row restarts: leaders are absolute
    top = int(((d << 1) ^ (d >> 63)).max())
    req = max(top.bit_length(), 1)
    if req > 32:
        raise ValueError(
            f"deltas need {req} bits > the dx codec's 32-bit word packing; "
            "use comp.cascaded_compress for this buffer")
    return req


def dx_decompress_dot(packed, leaders, w, *, bits: int, tile: int = 64, scale: float = 1.0):
    """Decode fused with a product (the nvCOMPDx selling point): the values
    of each 128-value row, times ``scale``, against W (128, N): f32 (rows,
    N). The decoded matrix never reaches device memory. The rows must be a
    multiple of ``tile`` unless there are fewer, as in the reference."""
    check(1 <= bits <= 32, "dx codec packs into 32-bit words: bits must be 1..32")
    k = w.shape[0]
    check(k == 128, "fused dot consumes the decoded (rows, 128) layout "
                    "directly: reshape the logical matrix so k == 128")
    check(packed.shape[1] == 4 * bits, "packed shape must be (rows, 4*bits) word rows")
    rows = packed.shape[0]
    rstep = max(1, min(tile, rows))
    check(rows % rstep == 0, "rows must tile the blocking")
    check(leaders.shape[0] == rows, "one leader per 128-value row")
    return _decode_dot(packed, leaders, w, bits, scale)
