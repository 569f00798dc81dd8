"""2-bit packed transfer of code streams: host packer and device unpacker.

Port of ``fastk_tpu/ops/pack.py``. The host packs codes 4 bases a byte (code
p at bits 2*(p%4) of byte p//4) and lists the positions of codes >= 4
(sentinels, N's) apart; the device unpacks. The bytes are moved as int32
words, little-endian, so code p sits at bits 2*(p%16) of word p//16.

Count arrays come back through ``fetch_u16``: the device keeps them in a
signed type (torch's uint16 kernels are thin) and the host views the int16
bytes as uint16, which is exact for counts clipped at 32767.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fastk_tpu_torch import native

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
    native packer when it is available, the numpy one otherwise."""
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
    codes[idx] = 4
    return codes[:size]


def unpack_words(packed_words: torch.Tensor, exceptions: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Device: int32 packed words (little-endian) -> uint8 codes."""
    if packed_words.dtype != torch.int32 or not packed_words.is_contiguous():
        raise ValueError("packed_words must be a contiguous int32 tensor")
    return unpack_stream(packed_words.view(torch.uint8), exceptions, size)


def upload_int32(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host 32-bit array as int32 on `device`. On CUDA it is copied into
    pinned memory and uploaded without blocking the host, so host work that
    follows overlaps device work queued before it."""
    t = torch.from_numpy(arr.view(np.int32))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def upload_packed(pw: np.ndarray, exc: np.ndarray, n: int,
                  device: torch.device) -> torch.Tensor:
    """Host packed words and exceptions -> device codes [n], each uploaded
    by upload_int32."""
    return unpack_words(upload_int32(pw, device), upload_int32(exc, device),
                        n)


def device_codes(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host codes -> device codes through the 2-bit packed transfer."""
    pw, exc = pack_stream_words(codes)
    return upload_packed(pw, exc, len(codes), device)


def fetch_u16_async(x: torch.Tensor):
    """Start moving a device count array (values in [0, 32767]) to the host.

    Returns a callable that waits for this copy alone, not for device work
    queued after it, and returns the counts as np.uint16. On CUDA the copy
    goes as int16 into pinned memory without blocking the host."""
    h = x.to(torch.int16)
    if h.device.type != "cuda":
        arr = h.numpy().view(np.uint16)
        return lambda: arr
    host = torch.empty(h.shape, dtype=torch.int16, pin_memory=True)
    host.copy_(h, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> np.ndarray:
        done.synchronize()
        return host.numpy().view(np.uint16)

    return wait


def fetch_u16(x: torch.Tensor) -> np.ndarray:
    """Device count array (values in [0, 32767]) -> host np.uint16."""
    return fetch_u16_async(x)()
