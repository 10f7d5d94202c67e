"""int8 gradient compression with stochastic rounding and error feedback,
as the reference's (``repro.optim.compression``): a per-tensor scale
``max|x| / 127``, each value rounded up with the probability of its
fractional part (unbiased), and the residual ``x - decompress(q)`` carried
into the next call instead of being dropped.

The random bits come from a ``torch.Generator`` (on ``x``'s device), so
they are not JAX's: the port is held to the reference's properties (the
rounding unbiased, each value within one quantization step, error feedback
converging), not to its bits. :func:`compressed_psum` all-reduces over a
``torch.distributed`` process group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def int8_compress(x: torch.Tensor, generator: Optional[torch.Generator] = None):
    """``(q, scale)``: unbiased stochastic-rounded int8 quantization."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    scaled = x32 / scale
    low = torch.floor(scaled)
    p_up = scaled - low
    up = torch.rand(x.shape, generator=generator, device=x.device) < p_up
    q = torch.clamp(low + up.float(), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(x: torch.Tensor, group=None, generator: Optional[torch.Generator] = None,
                    error: Optional[torch.Tensor] = None):
    """The mean of ``x`` over the ranks of ``group`` with an int8 payload and
    error feedback. Returns ``(mean, new_error)``.

    Each rank sends ``q * scale`` as float32 (the reference's psum of the
    same), so the sum cannot overflow an int8 across ranks; the residual
    ``x - decompress(q)`` is returned to be added to the next call's ``x``.
    """
    if error is not None:
        x = x + error.to(x.dtype)
    q, scale = int8_compress(x, generator)
    new_error = x.float() - int8_decompress(q, scale)
    summed = q.to(torch.int32).float() * scale
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    return (summed / n).to(x.dtype), new_error.to(x.dtype)
