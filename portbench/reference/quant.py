"""Frozen arithmetic of the storage the configurations state, for the
reference to work out again what the program derives from the weights:

- int8 weights: symmetric per output channel, scale = max|w| / 127,
  round to nearest even, clamp to +-127;
- int4 weights: symmetric per (output channel, group of 128 inputs),
  scale = max|w| / 7, clamp to +-7;
- KV int8 (or int4 for a control): per (token, head) over the head's
  values, scale = max|x| / 127 (7), a zero row keeping scale 1;
- fp8 rounding (a control only): float8 e4m3 with a scale that maps the
  row's (or the tensor's) max to 448.
Each returns the dequantized f32 values.
"""

from __future__ import annotations

from typing import Optional

import torch

GROUP = 128


def weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """w [out, in] f32 as stored at `bits` (16: as given)."""
    if bits == 16:
        return w
    if bits == 8:
        amax = w.abs().amax(1, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        return torch.clamp(torch.round(w / scale), -127, 127) * scale
    if bits == 4:
        out, kin = w.shape
        g = w.reshape(out, kin // GROUP, GROUP)
        amax = g.abs().amax(2, keepdim=True)
        scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
        return (torch.clamp(torch.round(g / scale), -7, 7) * scale).reshape(out, kin)
    raise ValueError(f"weight bits {bits}")


def kv(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """x [..., Dh] as a KV cache of `bits` holds it (None: as computed)."""
    if bits is None:
        return x
    top = {8: 127.0, 4: 7.0}[bits]
    amax = x.abs().amax(-1, keepdim=True)
    scale = (amax / top).masked_fill(amax == 0, 1.0)
    return torch.clamp(torch.round(x / scale), -top, top) * scale


def fp8_round(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """x through float8 e4m3 and back, scaled per row or per tensor."""
    amax = x.abs().amax(-1, keepdim=True) if per_row else x.abs().amax()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
