"""comp — the nvCOMP capability surface; here only its device-resident half.

Counterpart of the device-resident codec of ``tpumathlib/comp/__init__.py``
(``:373-451``): the cascaded scheme (delta, zigzag, bit-pack; no run-length
stage) on device tensors through the dx kernels (``dx.comp``, kernels B8a and
B8b), and Bitcomp-style error-bounded lossy compression of f32 on top of it.
The data never leaves the device, apart from the one scalar that
``dx_required_bits`` reads back when ``bits`` is not given.

Not ported yet (ROADMAP A7): the host codecs of that module — LZ4, snappy,
deflate, gzip, gdeflate, zstd, rANS, crc32, ``Manager``, ``batched_*`` and the
host ``cascaded`` container format.
"""

from __future__ import annotations

import math

import torch

from tpumathlib_torch.dx.comp import dx_compress, dx_decompress, dx_required_bits


def device_cascaded_compress(x, bits: int | None = None):
    """Compress a device int32 tensor (≙ nvcompBatchedCascadedCompressAsync
    with one chunk a call, device-resident in and out).

    Returns (payload, meta): payload = (packed (⌈n/128⌉, 4·bits) uint32,
    leaders (⌈n/128⌉,) int32, the rows' first values), meta = (n, bits) for
    decompression. If ``bits`` is None it is derived from the data (one
    scalar read back); pass it to stay wholly on the device.
    """
    n = int(x.shape[0])
    if bits is None:
        bits = dx_required_bits(x)
    pad = (-n) % 32
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
    return dx_compress(x, bits=bits), (n, bits)


def device_cascaded_decompress(payload, meta):
    """Decompress on the device: ((packed, leaders), (n, bits)) → int32 (n,)."""
    n, bits = meta
    packed, leaders = payload
    return dx_decompress(packed, leaders, n, bits=bits)


def device_cascaded_ratio(meta, payload) -> float:
    """Achieved compression ratio: input bytes over the logical packed and
    leader bytes (the word rows are padded up to whole 128-value rows)."""
    n, bits = meta
    packed, leaders = payload
    nwords = min(packed.shape[0] * packed.shape[1], -(-(n * bits) // 32) + packed.shape[1])
    return (4.0 * n) / (4.0 * (nwords + leaders.shape[0]))


def device_bitcomp_lossy_compress(x, delta: float, bits: int | None = None):
    """Error-bounded lossy compression of f32 device data (≙ the nvCOMP
    Bitcomp native API: lossy FP32 to signed integers with a quantization
    delta, reconstruction error at most delta/2).

    ``delta`` is rounded down to a power of two, as Bitcomp does; the values
    are quantized to round(x/delta) (half to even) int32 on the device, then
    packed by the device cascaded codec. Returns (payload, meta). The
    quantized magnitudes must fit int32 (|x| ≲ 2^31·delta).
    """
    if not (delta > 0.0) or not math.isfinite(delta):
        raise ValueError(f"delta must be a positive finite float: {delta}")
    d2 = 2.0 ** math.floor(math.log2(delta))
    q = torch.round(x.to(torch.float32) * (1.0 / d2)).to(torch.int32)
    payload, (n, bits) = device_cascaded_compress(q, bits=bits)
    return payload, (n, bits, d2)


def device_bitcomp_lossy_decompress(payload, meta):
    """Decompress to f32 on the device: x̂ = q · delta (error ≤ delta/2)."""
    n, bits, d2 = meta
    q = device_cascaded_decompress(payload, (n, bits))
    return q.to(torch.float32) * d2
