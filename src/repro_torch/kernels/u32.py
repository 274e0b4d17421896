"""uint32 data in torch: storage, int64 carriers, and the device rule.

The reference's records are (key: uint32, val: uint32) pairs. torch's own
uint32 type has no `<`, `>`, `+`, `>>`, `flip` or `searchsorted` on the
CPU, so the port keeps every uint32 array in a torch.int32 tensor that
holds the same 32 bits ("u32 tensors" below). Nothing ever compares those
int32 values directly — keys >= 2**31 would order wrong:

  * the CUDA kernels read and write the storage as raw `uint32_t`;
  * the plain torch versions widen to int64 carriers in [0, 2**32), and
    where a (key, val) lex order is needed they pack the pair into one
    int64 whose signed order IS the lex order:
        pack(k, v) = (k - 2**31) * 2**32 + v
    (no overflow: the product lies in [-2**63, 2**63 - 2**32]).

The device is always an explicit argument. `resolve_device("cuda")`
raises without a card of capability (9, 0) or newer — it never falls
back to the CPU; "cpu" selects the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
SIGN = 1 << 31
PAD = -1  # int32 bits of 0xFFFFFFFF, the lex-max pad key/val


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on; raises for a CUDA device
    that is missing or older than Hopper (sm_90a kernels only)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r}: torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain versions")
        cap = torch.cuda.get_device_capability(dev)
        if cap < (9, 0):
            raise RuntimeError(
                f"device={device!r} has compute capability {cap}; the "
                "kernels are built for sm_90a and need (9, 0) or newer")
    elif dev.type != "cpu":
        raise ValueError(f"device={device!r}: must be 'cuda' or 'cpu'")
    return dev


def from_numpy(a, device) -> torch.Tensor:
    """numpy uint32 array -> u32 tensor on `device` (bits unchanged)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:  # torch tensors must own writable storage
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def as_tensor(x, device) -> torch.Tensor:
    """A u32 tensor on `device` from numpy uint32 or a u32 tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise TypeError(f"u32 tensors are int32 bit storage, got {x.dtype}")
        return x.to(device)
    return from_numpy(x, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """u32 tensor -> numpy uint32 array (bits unchanged)."""
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """u32 tensor (or int64 carrier) -> int64 carrier in [0, 2**32)."""
    return t.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier in [0, 2**32) -> u32 tensor (int32 bits)."""
    return ((x ^ SIGN) - SIGN).to(torch.int32)


def pack(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the (key, val) unsigned lex order."""
    return (widen(keys) - SIGN) * (1 << 32) + widen(vals)


def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of pack: (keys, vals) as u32 tensors."""
    return narrow((packed >> 32) + SIGN), narrow(packed & MASK)


def full(shape, value: int, device) -> torch.Tensor:
    """u32 tensor filled with the uint32 `value`."""
    return torch.full(shape, (value ^ SIGN) - SIGN, dtype=torch.int32,
                      device=device)


def require_u32(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous int32 bit storage on one
    device — what a kernel wrapper hands to `uint32_t*`."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"expected u32 (int32 bit) storage, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
