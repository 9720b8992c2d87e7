"""The system under test: TorR edge serving through the port's
``AsyncStreamEngine``, driven by camera streams.

Per window: the stream's features are encoded by ``ops.encode_packed``
(one call over the windows submitted together), handed to
``AsyncStreamEngine.submit(stream, words, valid, boxes)`` and resolved
through its ``Future``. The loop is closed: each stream keeps ``depth``
windows submitted and unresolved, and a resolved window's slot is refilled
at once.

Each camera is a client thread (``_Driver``); the engine's dispatcher and
collector are the program's. The driver records, per window, when it was
submitted and delivered, and the parts of its result that the check
compares. Of the packed words it keeps on the card those of each distinct
window's first submission and of a sample of the repeats drawn from the
seed (``REPEAT_SAMPLE``), so that what it holds stops growing once every
stream has cycled.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

REPEAT_SAMPLE = 16       # a repeat's words are kept one submission in this


@dataclasses.dataclass
class Window:
    stream: int
    seq: int                 # the stream's window number, from 0
    j: int                   # which of the stream's distinct windows
    t_sub: float = float("nan")
    t_done: float = float("nan")
    ok: bool = False         # a result arrived (not shed, not failed)
    error: str = ""
    words: object = None     # int32 [N_max, W] on the card (a view), or
    #                          None for a repeat left out of the sample
    scores: np.ndarray = None    # float32 [n_valid, M]
    pad_nonzero: int = 0         # nonzero score entries on padding rows
    best: np.ndarray = None      # int32 [N_max]
    path: np.ndarray = None
    d_count: np.ndarray = None
    rho: np.ndarray = None
    qd: int = 0
    banks: int = 0
    n_valid: int = 0
    high: bool = False


def torr_config(tc: dict):
    """The port's ``TorrConfig`` from the configuration file's ``torr``
    group (its keys that the config class has)."""
    from repro_torch.core.types import TorrConfig

    names = {f.name for f in dataclasses.fields(TorrConfig)}
    return TorrConfig(**{k: v for k, v in tc.items() if k in names})


def build_engine(cfg, codes: torch.Tensor, dep: dict, device, *,
                 metrics=None):
    """The deployment's engine: ``AsyncStreamEngine`` on one card over the
    item memory built from ``codes``, with ``slots_per_card`` slots."""
    from repro_torch.core.item_memory import build_item_memory
    from repro_torch.serving.async_engine import AsyncStreamEngine

    if dep["cards"] != 1:
        raise ValueError("the harness serves one card a cell")
    im = build_item_memory(codes, plane_total=cfg.bit_planes)
    return AsyncStreamEngine(
        cfg, im, n_slots=dep["slots_per_card"], jit=dep["jit"],
        fused=dep["lowering"], bucket_cap=dep["bucket_cap"],
        decide=dep["decide"], pipeline_depth=dep["pipeline_depth"],
        metrics=metrics, device=device)


def captures(eng) -> int:
    """CUDA graphs the engine's graph family has captured so far."""
    return len(eng.graphs.captures) if eng.graphs is not None else 0


class _Driver:
    """Generates one traffic mix against ``eng`` and records every window.

    One client thread a camera submits its windows, as independent cameras
    do: ``submit`` waits for the engine lock, which the dispatcher holds
    through a step's dispatch, so one thread for all cameras fills a step
    with a few windows only. ``inp`` holds the features on the card and the
    valid masks and boxes on the host; stream s's window number k replays
    its distinct window k mod Wn."""

    def __init__(self, eng, inp, traffic: dict, seed: int, device):
        self.eng = eng
        self.inp = inp
        self.traffic = traffic
        self.device = torch.device(device)
        self.S, self.Wn = inp.valid.shape[:2]
        self.windows: list[list[Window]] = [[] for _ in range(self.S)]
        self.done = [queue.SimpleQueue() for _ in range(self.S)]
        self.encodes: list = []      # (t, rows) of each encode call
        # stream s keeps a repeat's words where seq % REPEAT_SAMPLE is
        # its offset, drawn from the seed
        self.keep_at = np.random.default_rng(seed % 2 ** 63).integers(
            0, REPEAT_SAMPLE, self.S)
        self.hooks = []              # (time, fn) run once, in order

    # -- the calls into the program ---------------------------------------

    def _submit(self, wins: list[Window]) -> None:
        """Encode ``wins`` together and submit each."""
        from repro_torch.kernels import ops

        feats = self.inp.feats
        z = (feats[wins[0].stream, wins[0].j] if len(wins) == 1 else
             torch.cat([feats[w.stream, w.j] for w in wins]))
        with torch.profiler.record_function("bench.encode"):
            words = ops.encode_packed(z, self.inp.R, device=self.device)
        self.encodes.append((time.perf_counter(), z.shape[0]))
        N = feats.shape[2]
        with torch.profiler.record_function("bench.submit"):
            for k, w in enumerate(wins):
                x = words[k * N:(k + 1) * N]
                if (w.seq < self.Wn
                        or w.seq % REPEAT_SAMPLE == self.keep_at[w.stream]):
                    w.words = x
                fut = self.eng.submit(f"cam{w.stream}", x,
                                      self.inp.valid[w.stream, w.j],
                                      self.inp.boxes[w.stream, w.j])
                w.t_sub = time.perf_counter()
                fut.add_done_callback(self._resolved(w))

    def _resolved(self, w: Window):
        def cb(fut):
            w.t_done = time.perf_counter()
            self.done[w.stream].put((w, fut))
        return cb

    def _consume(self, w: Window, fut) -> None:
        """Keep what the check compares of a delivered window."""
        try:
            out, tel = fut.result()
        except BaseException as e:  # noqa: BLE001 (shed, cancelled, dead)
            w.error = f"{type(e).__name__}: {e}"[:200]
            return
        n = self.inp.n_valid[w.stream, w.j]      # valid rows lead
        sc = np.asarray(out.scores)
        w.scores = sc[:n].copy()
        w.pad_nonzero = int(np.count_nonzero(sc[n:]))
        w.best = np.asarray(out.best).copy()
        w.path = np.asarray(tel.path).copy()
        w.d_count = np.asarray(tel.delta_count).copy()
        w.rho = np.asarray(tel.rho).copy()
        w.qd = int(tel.queue_depth)
        w.banks = int(tel.banks)
        w.n_valid = int(tel.n_valid)
        w.high = bool(tel.high_load)
        w.ok = True

    def _next(self, s: int) -> Window:
        seq = len(self.windows[s])
        w = Window(stream=s, seq=seq, j=seq % self.Wn)
        self.windows[s].append(w)
        return w

    def _drain_own(self, s: int, timeout: float | None = None) -> list:
        """Consume camera s's delivered windows (waiting up to ``timeout``
        for the first); the windows that came."""
        try:
            item = self.done[s].get(timeout=timeout) if timeout \
                else self.done[s].get_nowait()
        except queue.Empty:
            return []
        got = [item]
        while True:
            try:
                got.append(self.done[s].get_nowait())
            except queue.Empty:
                break
        for w, fut in got:
            self._consume(w, fut)
        return [w for w, _fut in got]

    # -- the cameras ---------------------------------------------------------

    def _closed(self, s: int, t_end: float) -> None:
        """Camera s keeps ``depth`` windows submitted and unresolved,
        refilling as they resolve."""
        if not self.windows[s]:
            self._submit([self._next(s)
                          for _ in range(self.traffic["depth"])])
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            got = self._drain_own(s, timeout=max(1e-3, t_end - now))
            now = time.perf_counter()
            if got and now < t_end:
                self._submit([self._next(s) for _w in got])

    def run(self, t_end: float) -> None:
        """Every camera generates until ``t_end`` (perf_counter seconds);
        this thread runs the hooks meanwhile."""
        threads = [threading.Thread(target=self._closed, args=(s, t_end),
                                    name=f"camera{s}", daemon=True)
                   for s in range(self.S)]
        for t in threads:
            t.start()
        self.hooks.sort(key=lambda h: h[0])
        while self.hooks and self.hooks[0][0] <= t_end:
            wait = self.hooks[0][0] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.hooks.pop(0)[1]()
        for t in threads:
            t.join()

    def drain(self, timeout: float) -> None:
        """Wait for every submitted window, up to ``timeout`` seconds, then
        keep what arrived."""
        t_stop = time.perf_counter() + timeout
        for s in range(self.S):
            while any(not (w.ok or w.error) for w in self.windows[s]):
                left = t_stop - time.perf_counter()
                if left <= 0 or not self._drain_own(s, timeout=left):
                    break
            self._drain_own(s)


def make_driver(eng, inp, traffic: dict, seed: int, device) -> _Driver:
    """Admit one stream a slot (``cam<s>``, its task's weights) and return
    the traffic's driver."""
    S = inp.valid.shape[0]
    for s in range(S):
        eng.admit(f"cam{s}", inp.task_w[s].cpu())
    return _Driver(eng, inp, traffic, seed, device)


def final_cache(eng) -> dict:
    """Every slot's query cache after the last step, on the host."""
    st = eng.state
    c = st.cache
    return {k: getattr(c, k).cpu().numpy() for k in (
        "packed", "acc", "acc_tag", "out", "topk_key", "margin", "age",
        "valid")}
