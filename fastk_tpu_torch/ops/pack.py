"""The 2-bit packed form of a code stream.

A slice's first trip to the device carries its uint8 codes as they are
(``convert.device_codes``: 0..3 for bases, 4 for sentinels and N's), since
the host already holds them and the copy costs milliseconds. The 2-bit
packed form, ported from ``fastk_tpu/ops/pack.py``, is for a stream the host
keeps for a later upload: the host packs codes 4 bases a byte (code p at
bits 2*(p%4) of byte p//4) and lists the positions of codes >= 4 apart; the
device unpacks. The bytes are moved as int32 words (``convert.upload_int32``),
little-endian, so code p sits at bits 2*(p%16) of word p//16.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fastk_tpu_torch import native, trace
from fastk_tpu_torch.convert import upload_int32

EXC_PAD = 0xFFFFFFFF  # exception-list padding; unpacks into a dump slot


def pack_stream(codes: np.ndarray, cap_step: int = 1 << 12
                ) -> Tuple[np.ndarray, np.ndarray]:
    """numpy packer: (packed uint8[ceil(n/4)], exceptions uint32).

    Exception positions (code >= 4) pack as 0 and are listed, padded with
    EXC_PAD to a multiple of cap_step (at least cap_step)."""
    n = len(codes)
    exc = np.flatnonzero(codes >= 4).astype(np.uint32)
    c = np.where(codes >= 4, 0, codes).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    c = c.reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    m = max(cap_step, -(-len(exc) // cap_step) * cap_step)
    exc_padded = np.full(m, EXC_PAD, dtype=np.uint32)
    exc_padded[: len(exc)] = exc
    return packed, exc_padded


def pack_stream_words(codes: np.ndarray, cap_step: int = 1 << 12
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a host code stream into (uint32 words, uint32 exceptions).

    The stream is padded with code 4 to a multiple of 16 codes. Uses the
    native packer when it is available, the numpy one otherwise. Traced:
    the span pack."""
    with trace.span("pack"):
        pad = (-len(codes)) % 16
        if pad:
            codes = np.concatenate([codes, np.full(pad, 4, np.uint8)])
        got = native.pack2(codes, ecap=max(cap_step, len(codes)))
        if got is None:
            packed, exc_padded = pack_stream(codes, cap_step)
        else:
            packed, exc, ne = got
            m = max(cap_step, -(-ne // cap_step) * cap_step)
            exc_padded = np.full(m, EXC_PAD, dtype=np.uint32)
            exc_padded[:ne] = exc[:ne]
    return packed.view(np.uint32), exc_padded


def unpack_stream(packed: torch.Tensor, exceptions: torch.Tensor, size: int
                  ) -> torch.Tensor:
    """Device: uint8 packed bytes + int32 exception positions -> uint8 codes.

    Exception entries that are negative (EXC_PAD seen as int32) or >= size
    land in a dump slot past the end."""
    p = packed.to(torch.uint8)
    codes = torch.stack([p & 3, (p >> 2) & 3, (p >> 4) & 3, (p >> 6) & 3],
                        dim=1).reshape(-1)[:size]
    idx = exceptions.to(torch.int64)
    idx = torch.where((idx < 0) | (idx > size), size, idx)
    codes = torch.cat([codes, codes.new_zeros(1)])
    with trace.wait("unpack"):  # the scalar's copy may wait for the card
        codes[idx] = 4
    return codes[:size]


def unpack_words(packed_words: torch.Tensor, exceptions: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Device: int32 packed words (little-endian) -> uint8 codes."""
    if packed_words.dtype != torch.int32 or not packed_words.is_contiguous():
        raise ValueError("packed_words must be a contiguous int32 tensor")
    return unpack_stream(packed_words.view(torch.uint8), exceptions, size)


def upload_packed(pw: np.ndarray, exc: np.ndarray, n: int,
                  device: torch.device) -> torch.Tensor:
    """Host packed words and exceptions -> device codes [n], each uploaded
    by upload_int32. Traced: the counter upload.packed_slices."""
    trace.count("upload.packed_slices", 1)
    return unpack_words(upload_int32(pw, device), upload_int32(exc, device),
                        n)
