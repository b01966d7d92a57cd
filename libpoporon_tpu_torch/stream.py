"""Streaming interface: protect byte streams of any length (counterpart of
libpoporon_tpu/stream.py, with the same framing).

`StreamCodec` cuts a byte stream into the codec's info-sized blocks,
encodes or decodes them as one batch on the codec's device, and joins
them again.  The framing is an 8-byte little-endian length header and
zero padding, so encode and decode round-trip for every input length, and
the blobs are byte-equal to the JAX package's for the same codec.

    sc = StreamCodec(pt.create(pt.rs_config_default()))
    blob = sc.encode_stream(payload)       # payload: bytes
    out, stats = sc.decode_stream(blob)    # -> (payload, stats)
"""

from __future__ import annotations

import numpy as np
import torch

_HEADER = 8  # uint64 little-endian payload length


class StreamCodec:
    def __init__(self, codec):
        if codec.symbol_dtype != torch.uint8:
            raise ValueError(f"StreamCodec frames bytes; this codec's symbols are "
                             f"{codec.config.symbol_size} bits")
        self.codec = codec
        self.info_size = int(codec.info_size)
        self.parity_size = int(codec.parity_size)
        if self.info_size <= 0:
            raise ValueError("codec has no byte-block structure")

    @property
    def block_size(self) -> int:
        return self.info_size + self.parity_size

    def encode_stream(self, payload: bytes) -> bytes:
        """Returns framed, FEC-protected bytes."""
        raw = np.frombuffer(
            len(payload).to_bytes(_HEADER, "little") + payload, dtype=np.uint8
        )
        k = self.info_size
        nblocks = max(1, -(-len(raw) // k))
        padded = np.zeros(nblocks * k, dtype=np.uint8)
        padded[: len(raw)] = raw
        enc = self.codec.encode(padded.reshape(nblocks, k))
        d, p = enc.data.cpu().numpy(), enc.parity.cpu().numpy()
        return np.concatenate([d, p], axis=1).tobytes()

    def decode_stream(self, blob: bytes, **decode_kw):
        """Returns (payload bytes, stats dict).  Raises ValueError on
        framing errors; uncorrectable blocks are counted in stats.
        `decode_kw` goes to the codec's decode."""
        bs = self.block_size
        if len(blob) % bs != 0:
            raise ValueError(f"stream length {len(blob)} not a multiple of {bs}")
        arr = np.frombuffer(blob, dtype=np.uint8).reshape(-1, bs)
        res = self.codec.decode(arr[:, : self.info_size], arr[:, self.info_size:],
                                **decode_kw)
        ok = res.ok.cpu().numpy()
        out = res.data.cpu().numpy().reshape(-1)
        length = int.from_bytes(out[:_HEADER].tobytes(), "little")
        if length > len(out) - _HEADER:
            raise ValueError("corrupt stream header")
        payload = out[_HEADER: _HEADER + length].tobytes()
        stats = {
            "blocks": int(arr.shape[0]),
            "blocks_failed": int((~ok).sum()),
            "corrected": res.corrected.sum().item(),
        }
        return payload, stats
