"""DVS event aggregation (port of ``repro.core.events``; paper Sec. 2.2 /
Eq. 1).

Events are (x, y, t, p) tuples; embedded systems aggregate them into windows
of width dt. Two views:

  * ``aggregate_window`` — the spatiotemporal tensor [T_bins, H, W, 2] fed to
    the spiking encoder (events binned over time and polarity);
  * ``eq1_frame`` — the normalized 2-D accumulation E_hat of Eq. 1 used by
    the image->event training bridge.

Event batches are fixed-size padded tensors with a validity count, the
contract of an embedded DMA engine filling a fixed ring buffer. Both views
are scatter-adds of +-1 and 0, so their sums are exact integers in float32
and equal ``repro``'s bit for bit on any device, whatever the order of the
additions. The one rounding that could differ is the time bin at a bin's
edge: it is a true float32 division on every device (see
:func:`aggregate_window`).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EventBatch:
    """Padded event window: tensors are [n_max]; ``count`` marks validity."""

    x: torch.Tensor       # int32 [n_max]
    y: torch.Tensor       # int32 [n_max]
    t: torch.Tensor       # f32   [n_max], relative to window start
    p: torch.Tensor       # int32 [n_max], polarity in {0, 1}
    count: torch.Tensor   # int32 []

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "EventBatch":
        return EventBatch(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def _valid(ev: EventBatch) -> torch.Tensor:
    return torch.arange(ev.x.shape[0], device=ev.device) < ev.count


def aggregate_window(ev: EventBatch, dt: float, t_bins: int, height: int,
                     width: int) -> torch.Tensor:
    """Histogram events into [t_bins, H, W, 2] (scatter-add). The time bin
    is t / dt * t_bins in float32, truncated toward zero, then clipped;
    x, y and p are clipped; padding adds 0.

    ``dt`` divides as a tensor on the events' device: divided by a Python
    float, PyTorch's CUDA kernel multiplies by the float32 reciprocal
    instead, which can bin an event that lies on a bin's edge (as integer
    microseconds often do) other than the CPU and ``repro`` do."""
    dt_t = torch.tensor(dt, dtype=torch.float32, device=ev.device)
    tb = torch.clamp((ev.t / dt_t * t_bins).to(torch.int32), 0, t_bins - 1)
    xx = torch.clamp(ev.x, 0, width - 1)
    yy = torch.clamp(ev.y, 0, height - 1)
    pp = torch.clamp(ev.p, 0, 1)
    w = torch.where(_valid(ev), 1.0, 0.0)
    vol = torch.zeros((t_bins, height, width, 2), dtype=torch.float32,
                      device=ev.device)
    idx = tuple(i.to(torch.int64) for i in (tb, yy, xx, pp))
    return vol.index_put_(idx, w, accumulate=True)


def eq1_frame(ev: EventBatch, height: int, width: int,
              eps: float = 1e-6) -> torch.Tensor:
    """Eq. 1: E_tilde(x,y) = sum of signed events; E_hat = E_tilde /
    max|E_tilde|."""
    sgn = torch.where(ev.p > 0, 1.0, -1.0) * torch.where(_valid(ev), 1.0, 0.0)
    xx = torch.clamp(ev.x, 0, width - 1).to(torch.int64)
    yy = torch.clamp(ev.y, 0, height - 1).to(torch.int64)
    e = torch.zeros((height, width), dtype=torch.float32, device=ev.device)
    e = e.index_put_((yy, xx), sgn, accumulate=True)
    return e / (torch.max(torch.abs(e)) + eps)
