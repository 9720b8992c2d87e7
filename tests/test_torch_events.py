"""Port parity: DVS event aggregation (``repro_torch.core.events`` vs
``repro.core.events``, paper Eq. 1).

Tolerance: bit-equal. Both views sum +-1 and 0 in float32, exact
integers, so the order of the scatter-add cannot change a bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro_torch import convert
from repro_torch.core import events as tev

from _torch_parity import assert_same


def _events(seed, n_max, count, height, width, dt):
    """A padded batch with events past every edge: x, y outside the frame,
    t < 0 and t >= dt, polarities outside {0, 1}; entries past ``count``
    are padding and must add nothing."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.integers(-3, width + 3, n_max).astype(np.int32),
        y=rng.integers(-3, height + 3, n_max).astype(np.int32),
        t=rng.uniform(-0.2 * dt, 1.2 * dt, n_max).astype(np.float32),
        p=rng.integers(-1, 3, n_max).astype(np.int32),
        count=np.int32(count))


def _both(leaves):
    return (jev.EventBatch(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            convert.event_batch_from_numpy(**leaves))


_agg = jax.jit(jev.aggregate_window, static_argnums=(1, 2, 3, 4))
_eq1 = jax.jit(jev.eq1_frame, static_argnums=(1, 2))


@pytest.mark.parametrize("height,width", [(16, 16), (15, 17)])
@pytest.mark.parametrize("n_max,count", [(512, 400), (64, 64), (32, 0)])
def test_aggregate_window_bit_equal(height, width, n_max, count):
    dt, t_bins = 0.004, 4
    ev_j, ev_t = _both(_events(n_max + count, n_max, count, height, width,
                               dt))
    want = _agg(ev_j, dt, t_bins, height, width)
    got = tev.aggregate_window(ev_t, dt, t_bins, height, width)
    assert_same(got, want, "aggregate_window")
    assert float(got.sum()) == float(min(count, n_max))


@pytest.mark.parametrize("dt,t_bins", [(0.003, 4), (1e-3, 7), (0.05, 3)])
def test_time_bins_truncate_as_the_reference(dt, t_bins):
    """The bin edges: t / dt * t_bins in float32 (a division, then a
    product), truncated toward zero (so -0.5 bins to 0), then clipped;
    times sit on and beside every edge. The reference runs op by op here:
    under ``jax.jit`` XLA folds the two into one product by
    f32(t_bins / dt), which bins t = 0.00225 at dt = 0.003, t_bins = 4 in
    bin 3 where the formula gives 2.9999998, bin 2."""
    edges = np.arange(-1, t_bins + 2, dtype=np.float64) * dt / t_bins
    t = np.concatenate([edges, np.nextafter(edges, -np.inf),
                        np.nextafter(edges, np.inf)]).astype(np.float32)
    n = t.size
    leaves = dict(x=np.arange(n, dtype=np.int32) % 5,
                  y=np.arange(n, dtype=np.int32) % 3, t=t,
                  p=np.arange(n, dtype=np.int32) % 2, count=np.int32(n))
    ev_j, ev_t = _both(leaves)
    assert_same(tev.aggregate_window(ev_t, dt, t_bins, 4, 6),
                jev.aggregate_window(ev_j, dt, t_bins, 4, 6), "time bins")


@pytest.mark.parametrize("height,width", [(16, 16), (15, 17)])
@pytest.mark.parametrize("n_max,count", [(256, 200), (16, 1), (16, 0)])
def test_eq1_frame_bit_equal(height, width, n_max, count):
    ev_j, ev_t = _both(_events(7 * n_max + count, n_max, count, height,
                               width, 0.004))
    assert_same(tev.eq1_frame(ev_t, height, width),
                _eq1(ev_j, height, width), "eq1_frame")


def test_eq1_normalization():
    """``repro``'s own case: two positive events at (1, 1), one negative at
    (2, 3), one padding entry."""
    ev = convert.event_batch_from_numpy(
        x=[1, 1, 2, 0], y=[1, 1, 3, 0], t=[0.001, 0.002, 0.003, 0.0],
        p=[1, 1, 0, 0], count=3)
    fr = tev.eq1_frame(ev, 8, 8)
    assert float(torch.max(torch.abs(fr))) == pytest.approx(1.0, abs=1e-4)
    assert float(fr[1, 1]) > 0 and float(fr[3, 2]) < 0


def test_event_batch_to_moves_every_leaf():
    ev = convert.event_batch_from_numpy(**_events(0, 8, 5, 4, 4, 1.0))
    moved = ev.to("cpu")
    assert moved.device.type == "cpu"
    for name in ("x", "y", "t", "p", "count"):
        assert torch.equal(getattr(moved, name), getattr(ev, name))
